"""Config 3, the ConvLSTM sequence VAE, in plain float32 PyTorch.

The per-frame conv encoder over B*T frames; the encoder ConvLSTM (1x1
input projection) keeping its last h; the Gaussian head and its sample;
the decoder's initial (c, h) and a time-constant z-token from z; the
decoder ConvLSTM (3x3 input conv of the token) over T steps; the "fast"
frame decoder to logits; BCE + KL summed, over the batch.  Sizes come
from the configuration's file (`sizes`).  `recurrences` declares the two
ConvLSTMs as the port's K5 and K6 count them.
"""

from __future__ import annotations

import torch

from benchmark import counts
from benchmark.reference import common as c


def spec(sizes: dict) -> list:
    ch, f, lat, tok = sizes["enc_channels"], sizes["lstm_features"], sizes["latent_dim"], \
        sizes["token_ch"]
    g = 64 // 2 ** len(ch)
    return (c.encoder_spec(ch) + c.lstm_proj_spec("enc_lstm", ch[-1], f)
            + c.linear_spec("head.mu", g * g * f, lat)
            + c.linear_spec("head.logvar", g * g * f, lat)
            + c.linear_spec("z_to_state", lat, 2 * g * g * f)
            + c.linear_spec("z_to_token", lat, g * g * tok)
            + c.lstm_conv_spec("dec_lstm", tok, f) + c.decoder_spec(f, tuple(reversed(ch))))


def recurrences(sizes: dict, batch: int) -> list:
    """The step's recurrences at `batch` clips (`counts.Recurrence`): the
    encoder as K5, the decoder, driven by a time-constant token, as K6."""
    ch, f = sizes["enc_channels"], sizes["lstm_features"]
    g, t = 64 // 2 ** len(ch), sizes["seq_len"]
    return [counts.k5_call("enc_lstm", batch, t, g, g, ch[-1], f),
            counts.k6_call("dec_lstm", batch, t, g, g, f)]


def eps_shapes(sizes: dict, batch: int) -> dict:
    """{salt: (rows, latent)} of the step's draws."""
    return {0: (batch, sizes["latent_dim"])}


def loss(P, x, eps, sizes: dict, lowp=None, hidden_conv=None, lowp32=None):
    """The step's loss, (BCE + KL) / B, of frames x (B, T, 64, 64) in f32."""
    b, t = x.shape[:2]
    ch, f, tok = sizes["enc_channels"], sizes["lstm_features"], sizes["token_ch"]
    g = 64 // 2 ** len(ch)
    feats = c.frame_encoder(P, x.reshape(b * t, 1, 64, 64), ch, lowp)
    feats = feats.permute(0, 2, 3, 1).reshape(b, t, g, g, ch[-1])
    zeros = x.new_zeros(b, f, g, g)
    w_enc = P["enc_lstm.step.hidden.weight"].permute(3, 2, 0, 1)
    _, h_t, _ = c.convlstm(c.proj_drive(P, feats, "enc_lstm", lowp), w_enc, zeros, zeros, t,
                           lowp, hidden_conv)
    flat = h_t.permute(0, 2, 3, 1).reshape(b, -1)
    mu, logvar = c.linear(flat, P, "head.mu", lowp32), c.linear(flat, P, "head.logvar", lowp32)
    z = c.sample(mu, logvar, eps[0])
    state = c.linear(z, P, "z_to_state", lowp32).reshape(b, g, g, 2 * f).permute(0, 3, 1, 2)
    token = c.linear(z, P, "z_to_token", lowp32).reshape(b, g, g, tok).permute(0, 3, 1, 2)
    xg = c.conv(token, P["dec_lstm.input.weight"], P["dec_lstm.input.bias"], lowp, padding=1)
    c0, h0 = c._q(state[:, :f], lowp), c._q(state[:, f:], lowp)
    _, _, hs = c.convlstm(xg[:, None], P["dec_lstm.step.hidden.weight"], c0, h0, t, lowp,
                          hidden_conv)
    logits = c.frame_decoder(P, torch.stack(hs, 1).reshape(b * t, f, g, g), lowp)
    bce = c.bce_sum(logits, x.reshape(b * t, 64, 64))
    return (bce + c.kl_sum(mu, logvar)) / b
