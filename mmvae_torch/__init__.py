"""mmvae_torch: the PyTorch / CUDA port of mmvae_tpu for NVIDIA Hopper.

Module names mirror `mmvae_tpu`.  The port imports torch and never jax or
flax.  Its main path is the config-3 (`seq_vae`) train step:

    ops.preprocess_kernels  u8 resident gather + binarize   (CUDA, csrc/preprocess.cu)
    models.seq_vae          frame encoder (cuDNN), encoder ConvLSTM
                            (ops.convlstm_kernels, CUDA csrc/convlstm_proj.cu),
                            head + sampling (ops.elbo_kernels, Triton),
                            decoder ConvLSTM (K6, csrc/convlstm_scan.cu),
                            frame decoder (cuDNN)
    ops.elbo_kernels        BCE + KL reduce (Triton)
    train.loop              loss, backward, Adam; `fit` (eval, checkpoints,
                            resume, the streaming data.feed) and `evaluate`
    bench.throughput        frames/s/GPU

Every kernel has a plain PyTorch version beside it, used for CPU tensors and
as the kernel's oracle on the card.
"""

__version__ = "0.1.0"
