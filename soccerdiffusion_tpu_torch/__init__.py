"""soccerdiffusion_tpu_torch — the PyTorch + CUDA (Hopper) port of soccerdiffusion_tpu.

The JAX package ``soccerdiffusion_tpu`` is the reference; this package is laid
out like it (same module and class names) and is held against it by the
``tests/test_torch_*.py`` parity tests. It carries the batched closed-loop
serving loop (the proprioceptive context encoder, the DDIM / DPM-Solver++
chunk sampler and the 1-step distilled denoiser), camera-conditioned serving
of the ``vit_flagship`` model (the fused ViT blocks, the image-token cache,
the fused encoder stacks at head_dim 64), the ResNet18 / ResNet50 and Swin
image encoders with BatchNorm running statistics and their remat modes, the
decoder-only tier, and training of every shipped configuration; its
kernels are hand-written CUDA for sm_90a (``csrc/``) with a plain PyTorch
version beside each for CPU tensors (the ResNet and Swin layers run
PyTorch's own convolutions and products). Its entry points run on the card
unless the caller asks for the CPU.

The package imports torch and numpy and never jax, flax or anything of the
JAX package: ``config.py`` is its own copy of the configuration.
"""

__version__ = "0.1.0"
