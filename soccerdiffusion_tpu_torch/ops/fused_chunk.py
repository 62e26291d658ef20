"""Whole-chunk fused sampler: every DDIM / DPM-Solver++ step of the
cross-attending decoder as ONE CUDA kernel launch (``csrc/fused_chunk.cu``,
and ``csrc/fused_chunk_int8.cu`` for int8 context K/V).

Counterpart of ``soccerdiffusion_tpu/ops/fused_chunk.py`` in each of its
forms. The kernel projects the raw context's per-layer K/V once per chunk
into a global scratch (in the order of the tensor-core fragments that read
them), then loops over the T steps inside one launch with the fp32 solver
carry on chip; per step the shared step-token K/V rows come from (T, L, E)
tables and the update from the (T, 5) [A, B, C, P, Q] table
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

The JAX sampler's other forms:
  * ``cross_orientation="qstat"`` (the JAX docstring marks it
    experiment-only): the same kernel with the step token as key S, its
    unnormalised probabilities rounded to bf16 before the value product and
    the fp32 divide after it (a run-time flag of the kernel).
  * ``group_robots`` G > 1: the JAX kernel packs G robots into one
    block-diagonal attention whose off-diagonal probabilities are exactly
    0, so it computes the G = 1 function (the JAX package's own test says
    so); the port accepts G and launches the G = 1 kernel, as it does for
    ``vit_fused_layout``.
  * ``context_kv_quant="int8"``: per block of R robots (``block_robots``,
    at most ``INT8_MAX_BLOCK`` = 32) the fp32 context K and V of each layer
    are quantised with one scale each, max|.| / 127 over the block, and each
    (step, layer)'s cross queries with one scale over the block's R robots;
    scores and value sums are int8 x int8 -> int32 products (the int8
    tensor cores), the probabilities quantised in 1/127 steps, the
    step-token column and the normalisation kept in fp32
    (``csrc/fused_chunk_int8.cu``: a thread-block cluster per robot block;
    head_dim 32, 64 and larger_model's 128). ``block_robots`` changes
    nothing in the other forms.

Dispatch as in ``ops/fused_denoise.py``: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain version. ``FusedChunkSampler.launches``
counts the bf16 kernel's launches, ``FusedChunkSampler.int8_launches`` the
int8 kernel's.
"""

from __future__ import annotations

import math

import torch

from soccerdiffusion_tpu_torch.config import INT8_MAX_BLOCK, check_serving_supported
from soccerdiffusion_tpu_torch.diffusion.dpm_solver import solver_coef_table
from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops.fused_denoise import (SMEM_LIMIT, WIDE_HEAD, WIDE_THREADS,
                                                         FusedDenoiser, chunk_param_elems,
                                                         check_cuda_operand, padded_joints,
                                                         padded_keys, r4, staged_params)

# the int8 kernel's blocks: 16 warps (8 at head_dim 128), a ring of
# INT8_RING[D] K / V units
INT8_RING = {32: 8, 64: 4, WIDE_HEAD: 2}


def int8_threads(head_dim: int) -> int:
    return WIDE_THREADS if head_dim == WIDE_HEAD else 512


def int8_keys(s: int) -> int:
    """Keys per (layer, head) of the int8 K/V scratch: the S context keys
    rounded up to 32-key chunks (the step token stays in fp32)."""
    return -(-s // 32) * 32


def int8_cluster(block: int) -> int:
    """Thread blocks a robot block of the int8 kernel: the largest power of
    two <= 8 that divides it (each block holds block / cluster robots)."""
    c = 1
    while c < 8 and block % (2 * c) == 0:
        c *= 2
    return c


def int8_state_floats(P: int, E: int, J: int) -> int:
    """fp32 floats of a robot's state between the int8 kernel's phases
    (``csrc/fused_chunk_int8.cu:RobotState``): the residual (P, E), the
    solver carry x and x0cache (P, J) each, the cross queries (P, E) bf16."""
    return r4(P * E) + 2 * r4(P * J) + r4(-(-P * E // 2))


def int8_smem_bytes(L: int, P: int, E: int, H: int, J: int, Jp: int, Sk: int) -> int:
    """Shared memory of one int8 kernel block (the mirror of
    ``csrc/fused_chunk_int8.cu:int8_smem_bytes``): the ring's mbarriers, the
    fp32 residual, the chunk statistics, the warps' int32 partials, the
    step-token scores, the rows' statistics, the scales, the staged
    parameters (none at head_dim 128), the bf16 activations, the int8
    queries and the ring of int8 K / V units."""
    D = E // H
    floats = (r4(P * E) + Sk + (int8_threads(D) // 32) * P * D + r4(P * H) + r4(2 * P)
              + r4(4 * L + 2))
    halves = ((chunk_param_elems(L, E, P, J) if staged_params(D) else 0) + P * (E + 8)
              + P * (3 * E + 8) + P * (Jp + 8))
    return 64 + 4 * floats + 2 * halves + P * (E + 16) + INT8_RING[D] * Sk * D


def kfrag8(s, d, D: int):
    """Byte of element (key s, dim d) of a head's int8 K in the int8
    kernel's score-fragment order (the mirror of
    csrc/fused_chunk_int8.cu:kfrag8; ints or integer arrays)."""
    dd = d & 31
    lane = 4 * (s & 7) + ((dd & 15) >> 2)
    reg = 2 * (d >> 5) + (dd >> 4)
    return (((s >> 3) * 32 + lane) * (D // 16) + reg) * 4 + (d & 3)


def vfrag8(s, d, D: int):
    """Byte of element (key s, dim d) of a head's int8 V in the int8
    kernel's value-fragment order (the mirror of
    csrc/fused_chunk_int8.cu:vfrag8)."""
    kk = s & 31
    w = kk & 15
    lane = 4 * (d & 7) + ((w & 7) >> 1)
    reg = 2 * (d >> 3) + (kk >> 4)
    return (((s >> 5) * 32 + lane) * (D // 4) + reg) * 4 + 2 * (w >> 3) + (w & 1)


def unpack_int8_kv(kv: torch.Tensor, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernel's K/V scratch (B, L, H, 2, Sk D) in fragment order ->
    (K, V), each (B, L, S, H D) int8: the inverse of its writes."""
    B, L, H, _, n = kv.shape
    D = n // int8_keys(S)
    s = torch.arange(S)[:, None]
    d = torch.arange(D)[None, :]
    kidx = torch.as_tensor(kfrag8(s, d, D)).reshape(-1).to(kv.device)
    vidx = torch.as_tensor(vfrag8(s, d, D)).reshape(-1).to(kv.device)
    unit = lambda sel, idx: (kv[:, :, :, sel].index_select(-1, idx).view(B, L, H, S, D)
                             .permute(0, 1, 3, 2, 4).reshape(B, L, S, H * D))
    return unit(0, kidx), unit(1, vidx)


def quantise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's symmetric int8 quantiser, clip(round(x / scale),
    -127, 127) (a true division, round half to even), as float integers."""
    return torch.clamp(torch.round(x / scale), -127.0, 127.0)


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-8), the division a true one as in the kernel (on
    CUDA, PyTorch multiplies a tensor by the reciprocal of a Python number
    it is divided by, which is one unit in the last place off in about 5%
    of the scales)."""
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)


def block_scale(x: torch.Tensor, robots: int) -> torch.Tensor:
    """max(max |x| / 127, 1e-8) over each block of ``robots`` rows of x
    (B, ...), broadcast back to (B, 1, 1)."""
    a = x.reshape(x.shape[0] // robots, -1).abs().amax(1)
    return int8_scale(a).repeat_interleave(robots)[:, None, None]


class FusedChunkSampler(FusedDenoiser):
    """One kernel launch for the entire multi-step chunk; the weights are
    packed from ``FusedDenoiser``'s once per sampler, the context K/V are
    projected in-kernel. The arguments are the JAX sampler's."""

    launches = 0
    int8_launches = 0

    def __init__(self, model, block_robots: int = 32, group_robots: int = 1,
                 cross_orientation: str = "kstat", context_kv_quant: str = "none"):
        super().__init__(model)
        check_serving_supported(group_robots, context_kv_quant, cross_orientation, block_robots)
        self.block_robots, self.group_robots = block_robots, group_robots
        self.cross_orientation, self.context_kv_quant = cross_orientation, context_kv_quant

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

    def robots_per_block(self, batch: int, block_robots: int | None = None) -> int:
        """R = min(block_robots, B), which must divide B (the JAX sampler's
        assertion); int8 K/V: at most INT8_MAX_BLOCK (the kernel's limit)."""
        R = min(self.block_robots if block_robots is None else block_robots, batch)
        if batch % R:
            raise ValueError(f"batch {batch} not divisible by block_robots {R}")
        if self.context_kv_quant == "int8" and R > INT8_MAX_BLOCK:
            raise ValueError(f"the int8 chunk kernel takes at most {INT8_MAX_BLOCK} robots a "
                             f"block (block_robots); got {R}")
        return R

    def sample(self, context: torch.Tensor, noise: torch.Tensor, step_token_table: torch.Tensor,
               schedule, num_inference_steps: int, solver: str = "ddim",
               block_robots: int | None = None) -> torch.Tensor:
        """context (B, S, E) raw encoded tokens; noise (B, P, J) fp32;
        step_token_table (T, E) on the solver's timestep sequence;
        ``block_robots`` overrides the sampler's (the engine's, fitted to
        the batch as the JAX engine fits it). Returns the sampled chunk (B,
        P, J) fp32."""
        R = self.robots_per_block(context.shape[0], block_robots)
        if self.context_kv_quant == "int8" and context.shape[1] == 0:
            raise ValueError("context_kv_quant='int8' quantises the context K/V: it needs "
                             "context tokens (the decoder-only tier has none)")
        coefs = solver_coef_table(schedule, num_inference_steps, solver)  # (T, 5) fp32
        stk, stv = self.step_tables(step_token_table)
        if noise.is_cuda:
            return self.sample_kernel(context, noise, stk, stv, coefs, R)
        return self.sample_plain(context, noise, stk, stv, coefs, R)

    # ------------------------------------------------------------ plain

    def int8_context_kv(self, context: torch.Tensor, robots: int) -> list:
        """Per layer (k_q, v_q, s_k, s_v): the fp32 context K / V projections
        (not rounded to the compute dtype) quantised with one scale per
        block of ``robots`` robots each (s_k, s_v: (B, 1, 1))."""
        ctx = self._round(context)
        out = []
        for l in range(self.num_layers):
            k = ctx @ self.ck_w[l].float() + self.ck_b[l].float()
            v = ctx @ self.cv_w[l].float() + self.cv_b[l].float()
            sk, sv = block_scale(k, robots), block_scale(v, robots)
            out.append((quantise(k, sk), quantise(v, sv), sk, sv))
        return out

    def int8_cross(self, q2, kv, stk_l, stv_l, robots: int) -> torch.Tensor:
        """The int8 form's cross-attention of one layer: q2 (B, P, E)
        bf16-valued queries, kv = (k_q, v_q, s_k, s_v) of the layer, the
        step-token rows stk_l / stv_l (E,); the output rounded to the
        compute dtype, heads merged."""
        kq, vq, sk, sv = kv
        H, D = self.num_heads, self.head_dim
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], H, D).transpose(1, 2)  # (B, H, n, D)
        scale = 1.0 / math.sqrt(D)
        sq = block_scale(q2, robots)
        q_h = heads(q2)
        s = (heads(quantise(q2, sq)) @ heads(kq).transpose(-1, -2)) * ((sq * sk) * scale)[..., None]
        s_x = (q_h * stk_l.float().reshape(H, 1, D)).sum(-1, keepdim=True) * scale
        m = torch.maximum(s.amax(-1, keepdim=True), s_x)
        p, p_x = torch.exp(s - m), torch.exp(s_x - m)
        denom = p.sum(-1, keepdim=True) + p_x
        o = (torch.round(p * 127.0) @ heads(vq)) * (sv * (1.0 / 127.0))[..., None]
        o = (o + p_x * stv_l.float().reshape(H, 1, D)) / denom
        return self._round(o.transpose(1, 2).reshape(q2.shape))

    def qstat_cross(self, q2, k, v, stk_l, stv_l) -> torch.Tensor:
        """The qstat form's cross-attention of one layer: the S context keys
        and the step token in one softmax, its unnormalised probabilities
        rounded to the compute dtype before the value product and the fp32
        sum divided by their fp32 sum after it."""
        b, E = q2.shape[0], self.cfg.hidden_dim
        H, D = self.num_heads, self.head_dim
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], H, D).transpose(1, 2)
        keys = torch.cat([k.float(), stk_l.float().expand(b, 1, E)], dim=1)
        vals = torch.cat([v.float(), stv_l.float().expand(b, 1, E)], dim=1)
        s = (heads(q2) @ heads(keys).transpose(-1, -2)) * (1.0 / math.sqrt(D))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (self._round(p) @ heads(vals)) / p.sum(-1, keepdim=True)
        return self._round(o.transpose(1, 2).reshape(q2.shape))

    def sample_plain(self, context, noise, stk, stv, coefs, block_robots: int = 1) -> torch.Tensor:
        """The plain PyTorch version of the kernel of the sampler's form, on
        any device: stk / stv (T, L, E) step tables, coefs the (T, 5) numpy
        solver table, ``block_robots`` the int8 form's R."""
        r = self._round
        L = self.num_layers
        if self.context_kv_quant == "int8":
            kv = self.int8_context_kv(context, block_robots)
            ck = cv = None
        else:
            ctx = r(context)
            ck = [r(ctx @ self.ck_w[l].float() + self.ck_b[l].float()) for l in range(L)]
            cv = [r(ctx @ self.cv_w[l].float() + self.cv_b[l].float()) for l in range(L)]
        x = noise.float()
        x0c = torch.zeros_like(x)
        for t, (a, b, c, p, q) in enumerate(coefs.tolist()):
            if self.context_kv_quant == "int8":
                cross = lambda l, q2, t=t: self.int8_cross(q2, kv[l], stk[t, l], stv[t, l],
                                                           block_robots)
            elif self.cross_orientation == "qstat":
                cross = lambda l, q2, t=t: self.qstat_cross(q2, ck[l], cv[l], stk[t, l], stv[t, l])
            else:
                cross = None
            eps = self.plain_pass(x, ck, cv, stk[t], stv[t], cross)
            x, x0c = a * x + b * eps + c * x0c, p * x + q * eps
        return x

    # ------------------------------------------------------------ kernels

    def check_int8_shapes(self, context_len: int, robots: int) -> None:
        """Raise for what the int8 kernel does not take: the bf16 kernel's
        limits other than the context's (``check_kernel_shapes``: head_dim
        32 / 64 at hidden 128 / 256, 128 at hidden 512), more than
        INT8_MAX_BLOCK robots a block, more context tokens than its warps'
        32-key chunks hold (1024, 512 at head_dim 128) or a block past
        ``SMEM_LIMIT``: at 10 chunk steps S <= 672 at h128, 576 at hidden
        128 and head_dim 64, 448 at hidden 256 (4 layers) and at
        larger_model's hidden 512 (8 layers)."""
        self.check_kernel_shapes(0)
        if robots > INT8_MAX_BLOCK:
            raise ValueError(f"the int8 chunk kernel takes at most {INT8_MAX_BLOCK} robots a "
                             f"block (block_robots); got {robots}")
        cfg = self.cfg
        P, J, E = cfg.trajectory_prediction_length, cfg.num_joints, cfg.hidden_dim
        Sk = int8_keys(context_len)
        smem = int8_smem_bytes(self.num_layers, P, E, self.num_heads, J, padded_joints(J), Sk)
        most = 32 * 2 * (int8_threads(self.head_dim) // 32)
        if context_len > most or smem > SMEM_LIMIT:
            raise ValueError(f"the int8 chunk kernel takes at most {most} context tokens and "
                             f"{SMEM_LIMIT} bytes of shared memory; got {context_len} tokens, "
                             f"{smem} bytes")

    def sample_kernel(self, context, noise, stk, stv, coefs, block_robots: int = 1) -> torch.Tensor:
        """The CUDA kernel of the sampler's form on CUDA tensors."""
        for t, name in ((context, "context"), (noise, "noise"), (stk, "step K")):
            check_cuda_operand(t, self.emb_w, name)
        cfg = self.cfg
        B, S, E = context.shape
        P, J, L = cfg.trajectory_prediction_length, cfg.num_joints, self.num_layers
        if E != cfg.hidden_dim or tuple(noise.shape) != (B, P, J):
            raise ValueError(f"context {tuple(context.shape)} / noise {tuple(noise.shape)} "
                             "do not match the decoder")
        if self.context_kv_quant == "int8":
            return self.sample_int8_kernel(context, noise, stk, stv, coefs, block_robots)
        self.check_kernel_shapes(S, B, context.device)
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
                        self.cluster_size(B, dev), int(self.cross_orientation == "qstat")),
            _build.stream(dev))
        _build.check("sd_fused_chunk", err)
        FusedChunkSampler.launches += 1
        return out

    def sample_int8_kernel(self, context, noise, stk, stv, coefs, robots: int,
                           record: bool = False):
        """The int8 kernel (``csrc/fused_chunk_int8.cu``): a cluster of
        ``int8_cluster(R)`` blocks per block of R robots. With ``record``
        also what couples the block's robots, as the kernel used it: a dict
        of its int8 K/V scratch ``kv`` (``unpack_int8_kv`` reads it), per
        robot the K / V scales ``sk``, ``sv`` (B, L) and the query scales
        ``sq`` (B, T, L), and per (robot, step, layer) the bf16 cross
        queries ``q2``, their int8 form ``qq`` and the cross-attention's
        bf16 output ``cross``, (B, T, L, P, E) each."""
        B, S, E = context.shape
        self.check_int8_shapes(S, robots)
        cfg = self.cfg
        P, J, L, H, D = (cfg.trajectory_prediction_length, cfg.num_joints, self.num_layers,
                         self.num_heads, self.head_dim)
        T, dev, Sk = coefs.shape[0], noise.device, int8_keys(S)
        noise = noise.float().contiguous()
        out = torch.empty_like(noise)
        kv = torch.empty((B, L, H, 2, Sk * D), dtype=torch.int8, device=dev)
        state = torch.empty((B, int8_state_floats(P, E, J)), dtype=torch.float32, device=dev)
        rec = [None] * 4
        if record:
            rec = [torch.empty((B, (2 + T) * L), dtype=torch.float32, device=dev)] + [
                torch.empty((B, T, L, P, E), dtype=dt, device=dev)
                for dt in (torch.bfloat16, torch.int8, torch.bfloat16)]
        err = _build.library().sd_fused_chunk_int8(
            _build.pointers(*self.kernel_weights, noise, context.to(torch.bfloat16).contiguous(),
                            stk, stv, torch.as_tensor(coefs, device=dev), kv, state, out, *rec),
            _build.ints(L, E, H, P, J, padded_joints(J), B, S, Sk, T, robots,
                        int8_cluster(robots)),
            _build.stream(dev))
        _build.check("sd_fused_chunk_int8", err)
        FusedChunkSampler.int8_launches += 1
        if not record:
            return out
        scales = rec[0]
        return out, {"kv": kv, "sk": scales[:, 0:2 * L:2], "sv": scales[:, 1:2 * L:2],
                     "sq": scales[:, 2 * L:].reshape(B, T, L), "q2": rec[1], "qq": rec[2],
                     "cross": rec[3]}
