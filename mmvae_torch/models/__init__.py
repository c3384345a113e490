"""Model families of the port (NCHW convs inside, NHWC at the ConvLSTM)."""

from mmvae_torch.models.base import VAEOutput, flax_init_
from mmvae_torch.models.conv_vae import ConvVAE
from mmvae_torch.models.convlstm import ConvLSTM
from mmvae_torch.models.hier_vae import HierVideoVAE
from mmvae_torch.models.mlp_vae import MLPVAE
from mmvae_torch.models.pred_vae import PredSeqVAE
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE

MODEL_REGISTRY = {
    "mlp_vae": MLPVAE,
    "conv_vae": ConvVAE,
    "seq_vae": ConvLSTMSeqVAE,
    "pred_vae": PredSeqVAE,
    "hier_vae": HierVideoVAE,
}

__all__ = ["ConvLSTM", "ConvLSTMSeqVAE", "ConvVAE", "HierVideoVAE", "MLPVAE",
           "MODEL_REGISTRY", "PredSeqVAE", "VAEOutput", "flax_init_"]
