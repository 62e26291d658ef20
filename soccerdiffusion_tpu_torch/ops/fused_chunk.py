"""Whole-chunk fused sampler: every DDIM / DPM-Solver++ step of the
cross-attending decoder as ONE CUDA kernel launch (``csrc/fused_chunk.cu``).

Counterpart of ``soccerdiffusion_tpu/ops/fused_chunk.py`` in its default
form ("kstat", ``group_robots=1``, unquantised context K/V). The kernel
projects the raw context's per-layer K/V once per chunk into a global
scratch (in the order of the tensor-core fragments that read them), then
loops over the T steps inside one launch with the fp32 solver carry on
chip; per step the shared step-token K/V rows come from (T, L, E) tables
and the update from the (T, 5) [A, B, C, P, Q] table
(``diffusion/dpm_solver.py``), so DDIM and DPM-Solver++(2M) run the same
kernel.

Each step is one decoder pass of the code the serving denoiser runs
(``csrc/decoder_pass.cuh``), with its launch shapes and shape limits
(``ops/fused_denoise.py``: ``block_threads``, ``cluster_size``,
``check_kernel_shapes``). The serving weights are packed for the kernel
once per sampler (``kernel_weights``): the denoiser's (the Dense kernels
transposed to (out, in), the embedding's input columns padded with zeros to
a multiple of 32) and the context K/V projection ordered by (layer, head,
K | V). While the card has two SMs for each robot, a robot runs on a
cluster of two thread blocks that split its heads (``cluster_size``). The
kernel takes head_dim 32 or 64 at hidden 128 / 256 (at most 16 chunk steps
and 1023 context tokens, fewer where its shared memory runs out:
``check_kernel_shapes``) and head_dim 128 at hidden 512 (the larger_model
configuration: 8-warp blocks, at most 10 chunk steps and 383 context
tokens); its context K/V scratch is (B, L, H, 2, Sp D) bf16, 5.2 MB a robot
at larger_model's L=8, S=311.

Dispatch as in ``ops/fused_denoise.py``: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain version. ``FusedChunkSampler.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from soccerdiffusion_tpu_torch.config import check_serving_supported
from soccerdiffusion_tpu_torch.diffusion.dpm_solver import solver_coef_table
from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops.fused_denoise import (FusedDenoiser, check_cuda_operand,
                                                         padded_joints, padded_keys, r4)


class FusedChunkSampler(FusedDenoiser):
    """One kernel launch for the entire multi-step chunk; the weights are
    packed from ``FusedDenoiser``'s once per sampler, the context K/V are
    projected in-kernel."""

    launches = 0

    def __init__(self, model, group_robots: int = 1, cross_orientation: str = "kstat",
                 context_kv_quant: str = "none"):
        super().__init__(model)
        check_serving_supported(group_robots=group_robots, kv_quant=context_kv_quant,
                                cross_orientation=cross_orientation)

    def pass_carry(self) -> int:
        """The solver carry x and the DPM-Solver++ x0 cache, (P, J) fp32 each."""
        P, J = self.cfg.trajectory_prediction_length, self.cfg.num_joints
        return 2 * r4(P * J)

    def pack_kernel_weights(self) -> list[torch.Tensor]:
        """The 21 tensors ``csrc/fused_chunk.cu:ChunkArgs`` reads, in its
        order, packed once per sampler into ``kernel_weights``: the
        denoiser's (``FusedDenoiser.pack_kernel_weights``), then ``kv_t``
        (2 L E, E) / ``kv_b`` whose row ((l H + h) 2 + sel) D + d is output
        column h D + d of layer l's context K (sel 0) or V (sel 1)
        projection."""
        L, E = self.num_layers, self.cfg.hidden_dim
        H, D = self.num_heads, self.head_dim
        by_head = lambda k, v: torch.stack([k.reshape(*k.shape[:-1], H, D),
                                            v.reshape(*v.shape[:-1], H, D)], dim=-2)
        kv_w = by_head(self.ck_w, self.cv_w)  # (L, E, H, 2, D)
        kv_t = kv_w.permute(0, 2, 3, 4, 1).reshape(2 * L * E, E).contiguous()
        kv_b = by_head(self.ck_b, self.cv_b).reshape(2 * L * E).contiguous()
        return super().pack_kernel_weights() + [kv_t, kv_b]

    def sample(self, context: torch.Tensor, noise: torch.Tensor, step_token_table: torch.Tensor,
               schedule, num_inference_steps: int, solver: str = "ddim") -> torch.Tensor:
        """context (B, S, E) raw encoded tokens; noise (B, P, J) fp32;
        step_token_table (T, E) on the solver's timestep sequence. Returns
        the sampled chunk (B, P, J) fp32."""
        coefs = solver_coef_table(schedule, num_inference_steps, solver)  # (T, 5) fp32
        stk, stv = self.step_tables(step_token_table)
        if noise.is_cuda:
            return self.sample_kernel(context, noise, stk, stv, coefs)
        return self.sample_plain(context, noise, stk, stv, coefs)

    def sample_plain(self, context, noise, stk, stv, coefs) -> torch.Tensor:
        """The plain PyTorch version of the kernel, on any device: stk / stv
        (T, L, E) step tables, coefs the (T, 5) numpy solver table."""
        r = self._round
        ctx = r(context)
        ck = [r(ctx @ self.ck_w[l].float() + self.ck_b[l].float()) for l in range(self.num_layers)]
        cv = [r(ctx @ self.cv_w[l].float() + self.cv_b[l].float()) for l in range(self.num_layers)]
        x = noise.float()
        x0c = torch.zeros_like(x)
        for t, (a, b, c, p, q) in enumerate(coefs.tolist()):
            eps = self.plain_pass(x, ck, cv, stk[t], stv[t])
            x, x0c = a * x + b * eps + c * x0c, p * x + q * eps
        return x

    def sample_kernel(self, context, noise, stk, stv, coefs) -> torch.Tensor:
        """The CUDA kernel (``csrc/fused_chunk.cu``) on CUDA tensors."""
        self.check_kernel_shapes(context.shape[1], context.shape[0], context.device)
        for t, name in ((context, "context"), (noise, "noise"), (stk, "step K")):
            check_cuda_operand(t, self.emb_w, name)
        cfg = self.cfg
        B, S, E = context.shape
        P, J, L = cfg.trajectory_prediction_length, cfg.num_joints, self.num_layers
        if E != cfg.hidden_dim or tuple(noise.shape) != (B, P, J):
            raise ValueError(f"context {tuple(context.shape)} / noise {tuple(noise.shape)} "
                             "do not match the decoder")
        T = coefs.shape[0]
        dev = noise.device
        H, D, Jp, Sp = self.num_heads, self.head_dim, padded_joints(J), padded_keys(S)
        noise = noise.float().contiguous()
        out = torch.empty_like(noise)
        kv = torch.empty((B, L, H, 2, Sp * D), dtype=torch.bfloat16, device=dev)
        coef_dev = torch.as_tensor(coefs, device=dev)
        err = _build.library().sd_fused_chunk(
            _build.pointers(*self.kernel_weights, noise, context.to(torch.bfloat16).contiguous(),
                            stk, stv, coef_dev, kv, out),
            _build.ints(L, E, H, P, J, Jp, B, S, Sp, T, self.block_threads(B, S, dev),
                        self.cluster_size(B, dev)),
            _build.stream(dev))
        _build.check("sd_fused_chunk", err)
        FusedChunkSampler.launches += 1
        return out
