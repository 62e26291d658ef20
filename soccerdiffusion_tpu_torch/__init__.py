"""soccerdiffusion_tpu_torch — the PyTorch + CUDA (Hopper) port of soccerdiffusion_tpu.

The JAX package ``soccerdiffusion_tpu`` is the reference; this package is laid
out like it (same module and class names) and is held against it by the
``tests/test_torch_*.py`` parity tests. It carries the batched closed-loop
serving loop without images (the proprioceptive context encoder, the DDIM /
DPM-Solver++ chunk sampler and the 1-step distilled denoiser) and the
training of that architecture (the fused encoder stacks and decoder layers,
forward and backward), each backed by hand-written CUDA kernels for sm_90a
(``csrc/``) with a plain PyTorch version beside them for CPU tensors.

The package imports torch and numpy and never jax or flax; from the JAX
package it imports only the JAX-free ``config`` module.
"""

__version__ = "0.1.0"
