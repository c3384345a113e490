"""Model families of the port (NCHW convs inside, NHWC at the ConvLSTM)."""

from mmvae_torch.models.base import VAEOutput, flax_init_
from mmvae_torch.models.convlstm import ConvLSTM
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE

MODEL_REGISTRY = {
    "seq_vae": ConvLSTMSeqVAE,
}

__all__ = ["ConvLSTM", "ConvLSTMSeqVAE", "MODEL_REGISTRY", "VAEOutput", "flax_init_"]
