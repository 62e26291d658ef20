"""soccerdiffusion_tpu_torch — the PyTorch + CUDA (Hopper) port of soccerdiffusion_tpu.

The JAX package ``soccerdiffusion_tpu`` is the reference; this package is laid
out like it (same module and class names) and is held against it by the
``tests/test_torch_*.py`` parity tests. It carries the batched closed-loop
serving loop (the proprioceptive context encoder, the DDIM / DPM-Solver++
chunk sampler and the 1-step distilled denoiser), camera-conditioned serving
of the ``vit_flagship`` model (the fused ViT blocks, the image-token cache,
the fused encoder stacks at head_dim 64) and the training of the
proprioceptive architecture (the fused encoder stacks and decoder layers,
forward and backward), each backed by hand-written CUDA kernels for sm_90a
(``csrc/``) with a plain PyTorch version beside them for CPU tensors. Its
entry points run on the card unless the caller asks for the CPU.

The package imports torch and numpy and never jax, flax or anything of the
JAX package: ``config.py`` is its own copy of the configuration.
"""

__version__ = "0.1.0"
