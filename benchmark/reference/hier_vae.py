"""Config 5, the hierarchical temporal-latent video VAE, in plain float32
PyTorch.

Clips of K chunks x Tc frames: the conv encoder over B*T frames; the
chunk ConvLSTM (1x1 projection) over B*K chunks keeping its last h; a
dense chunk projection; the global latent z_g from the chunks' mean; the
chunk latents z_k from (chunk features, z_g) through a tanh MLP; the
learned prior p(z_k | z_g, z_{k-1}), a GRU over the chunk index with flax's
gate layout (no recurrent biases on r and z), teacher-forced on the z_k;
the decoder ConvLSTM over Tc steps for all B*K chunks from a state and a
time-constant token made from (z_g, z_k); the "fast" frame decoder; BCE +
KL(z_g) + KL(q(z_k) || p(z_k)), over the batch.  `recurrences` declares
the two ConvLSTMs as the port's K5 and K6 count them.
"""

from __future__ import annotations

import torch

from benchmark import counts
from benchmark.reference import common as c

_TOKEN_CH = 16
_HIDDEN = 256


def spec(sizes: dict) -> list:
    ch, f = sizes["enc_channels"], sizes["lstm_features"]
    lg, lc, cf = sizes["global_latent"], sizes["chunk_latent"], sizes["chunk_feature"]
    g = 64 // 2 ** len(ch)
    gru = (c.linear_spec("prior_gru.ir", lc, _HIDDEN) + c.linear_spec("prior_gru.iz", lc, _HIDDEN)
           + c.linear_spec("prior_gru.in", lc, _HIDDEN)
           + c.linear_spec("prior_gru.hr", _HIDDEN, _HIDDEN, bias=False)
           + c.linear_spec("prior_gru.hz", _HIDDEN, _HIDDEN, bias=False)
           + c.linear_spec("prior_gru.hn", _HIDDEN, _HIDDEN))
    return (c.encoder_spec(ch) + c.lstm_proj_spec("chunk_lstm", ch[-1], f)
            + c.linear_spec("chunk_proj", g * g * f, cf)
            + c.linear_spec("g_mu", cf, lg) + c.linear_spec("g_logvar", cf, lg)
            + c.linear_spec("q_hidden", cf + lg, _HIDDEN)
            + c.linear_spec("q_mu", _HIDDEN, lc) + c.linear_spec("q_logvar", _HIDDEN, lc)
            + gru + c.linear_spec("prior_init", lg, _HIDDEN)
            + c.linear_spec("p_mu", _HIDDEN, lc) + c.linear_spec("p_logvar", _HIDDEN, lc)
            + c.linear_spec("z_to_state", lg + lc, 2 * g * g * f)
            + c.linear_spec("z_to_token", lg + lc, g * g * _TOKEN_CH)
            + c.lstm_conv_spec("dec_lstm", _TOKEN_CH, f) + c.decoder_spec(f, tuple(reversed(ch))))


def recurrences(sizes: dict, batch: int) -> list:
    """The step's recurrences at `batch` clips (`counts.Recurrence`), over
    its B x K chunks: the chunk encoder as K5, the decoder, driven by a
    time-constant token, as K6."""
    ch, f, tc = sizes["enc_channels"], sizes["lstm_features"], sizes["chunk_len"]
    g, n = 64 // 2 ** len(ch), batch * (sizes["seq_len"] // tc)
    return [counts.k5_call("chunk_lstm", n, tc, g, g, ch[-1], f),
            counts.k6_call("dec_lstm", n, tc, g, g, f)]


def eps_shapes(sizes: dict, batch: int) -> dict:
    """{salt: (rows, latent)}: z_g's draw (salt 0) and the chunks' (salt 1)."""
    k = sizes["seq_len"] // sizes["chunk_len"]
    return {0: (batch, sizes["global_latent"]), 1: (batch * k, sizes["chunk_latent"])}


def _gru(P, h, x, lowp32=None):
    lin = lambda v, n: c.linear(v, P, f"prior_gru.{n}", lowp32)  # noqa: E731
    r = torch.sigmoid(lin(x, "ir") + lin(h, "hr"))
    z = torch.sigmoid(lin(x, "iz") + lin(h, "hz"))
    n = torch.tanh(lin(x, "in") + r * lin(h, "hn"))
    return (1.0 - z) * n + z * h


def loss(P, x, eps, sizes: dict, lowp=None, hidden_conv=None, lowp32=None):
    """The step's loss, (BCE + KL(z_g) + KL(z_k)) / B, of frames x (B, T, 64,
    64) in f32."""
    b, t = x.shape[:2]
    ch, f, tc = sizes["enc_channels"], sizes["lstm_features"], sizes["chunk_len"]
    lg, lc, cf = sizes["global_latent"], sizes["chunk_latent"], sizes["chunk_feature"]
    g, k = 64 // 2 ** len(ch), t // tc
    feats = c.frame_encoder(P, x.reshape(b * t, 1, 64, 64), ch, lowp)
    feats = feats.permute(0, 2, 3, 1).reshape(b * k, tc, g, g, ch[-1])
    zeros = x.new_zeros(b * k, f, g, g)
    w_enc = P["chunk_lstm.step.hidden.weight"].permute(3, 2, 0, 1)
    _, h_t, _ = c.convlstm(c.proj_drive(P, feats, "chunk_lstm", lowp), w_enc, zeros, zeros, tc,
                           lowp, hidden_conv)
    chunks = c.linear(h_t.permute(0, 2, 3, 1).reshape(b * k, -1), P, "chunk_proj",
                      lowp32).reshape(b, k, cf)
    pooled = chunks.mean(dim=1)
    mu_g = c.linear(pooled, P, "g_mu", lowp32)
    logvar_g = c.linear(pooled, P, "g_logvar", lowp32)
    z_g = c.sample(mu_g, logvar_g, eps[0])
    qin = torch.cat([chunks, z_g[:, None].expand(b, k, lg)], dim=-1).reshape(b * k, -1)
    hq = torch.tanh(c.linear(qin, P, "q_hidden", lowp32))
    mu_c, logvar_c = c.linear(hq, P, "q_mu", lowp32), c.linear(hq, P, "q_logvar", lowp32)
    z_c = c.sample(mu_c, logvar_c, eps[1]).reshape(b, k, lc)
    s = torch.tanh(c.linear(z_g, P, "prior_init", lowp32))
    z_prev, mus, logvars = torch.zeros_like(z_c[:, 0]), [], []
    for i in range(k):
        s = _gru(P, s, z_prev, lowp32)
        mus.append(c.linear(s, P, "p_mu", lowp32))
        logvars.append(c.linear(s, P, "p_logvar", lowp32))
        z_prev = z_c[:, i]
    extra = c.gaussian_kl(mu_c.reshape(b, k, lc), logvar_c.reshape(b, k, lc),
                          torch.stack(mus, 1), torch.stack(logvars, 1))
    zz = torch.cat([z_g[:, None].expand(b, k, lg), z_c], dim=-1).reshape(b * k, -1)
    state = c.linear(zz, P, "z_to_state", lowp32).reshape(b * k, g, g, 2 * f)
    state = state.permute(0, 3, 1, 2)
    token = c.linear(zz, P, "z_to_token", lowp32).reshape(b * k, g, g, _TOKEN_CH)
    token = token.permute(0, 3, 1, 2)
    xg = c.conv(token, P["dec_lstm.input.weight"], P["dec_lstm.input.bias"], lowp, padding=1)
    c0, h0 = c._q(state[:, :f], lowp), c._q(state[:, f:], lowp)
    _, _, hs = c.convlstm(xg[:, None], P["dec_lstm.step.hidden.weight"], c0, h0, tc, lowp,
                          hidden_conv)
    logits = c.frame_decoder(P, torch.stack(hs, 1).reshape(b * k * tc, f, g, g), lowp)
    bce = c.bce_sum(logits, x.reshape(b * t, 64, 64))
    return (bce + c.kl_sum(mu_g, logvar_g) + extra) / b
