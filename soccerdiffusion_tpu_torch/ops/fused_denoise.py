"""Fused serving-path denoiser: one pass of the whole cross-attending
decoder as one CUDA kernel (``csrc/fused_denoise.cu``).

Counterpart of ``soccerdiffusion_tpu/ops/fused_denoise.py``: the kernel runs
embedding -> posenc -> L x [self-attention, cross-attention against the
pre-projected context K/V plus the shared step-token K/V in one softmax,
exact-GELU MLP] -> output projection for each robot, and returns eps, or
x_prev when DDIM coefficients are given. It runs the whole-chunk sampler's
decoder pass (``csrc/decoder_pass.cuh``) with the sampler's launch shapes
(``block_threads``, ``cluster_size``) and shape limits
(``check_kernel_shapes``). ``FusedDenoiser.__init__`` packs the decoder
weights once, for the plain version and, transposed, for the kernel;
``FusedChunkSampler`` (``ops/fused_chunk.py``) inherits the packing, the
launch shapes, the limits and the plain decoder pass.

``pack_context_kv`` writes the per-layer context K/V in the order the
kernel reads them, the chunk kernel's scratch layout (B, L, H, 2, Sp D):
per (layer, head) its K in score-fragment order (``kfrag``) and its V in
value-fragment order (``vfrag``), Sp = ``padded_keys(S)`` keys of which key
S is the step token's slot and the rest past S are zero. On the card a
kernel of ``csrc/fused_denoise.cu`` packs them, a launch per layer
(``pack_kernel``); ``pack_plain`` is its plain version (index copies).

Dispatch: a CUDA tensor launches the kernels (bf16 weights, head_dim 32 or
64, or 128 at hidden 512) or raises; a CPU tensor runs the plain PyTorch
versions below, which round to the compute dtype at the kernel's rounding
points (``csrc/common.cuh``).
``FusedDenoiser.launches`` counts the denoiser's kernel launches,
``FusedDenoiser.pack_launches`` the pack's.

Noise precision: the carry x is fp32 throughout (the TPU kernel rounds it
to bf16 on entry); only the embedding matmul's input is rounded, as the
unfused path's per-step cast does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.config import check_supported
from soccerdiffusion_tpu_torch.diffusion.ddim import alpha_bar, ddim_timesteps
from soccerdiffusion_tpu_torch.models.attention import plain_attention
from soccerdiffusion_tpu_torch.models.layers import LN_EPS
from soccerdiffusion_tpu_torch.ops import _build


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm with eps 1e-6 over the last axis."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps=LN_EPS)


def heads_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """(B, Tq, E) x (B, Tk, E) fp32 -> (B, Tq, E) fp32 rounded to ``dtype``:
    fp32 scores and softmax, probabilities rounded to ``dtype``, fp32 sums."""
    split = lambda t: t.to(dtype).reshape(t.shape[0], t.shape[1], num_heads, -1)
    out = plain_attention(split(q), split(k), split(v)).float()
    return out.reshape(q.shape[0], q.shape[1], -1)


def max_context(threads: int) -> int:
    """Most context tokens of the decoder kernels at a block size: 32-key
    chunks, at most 2 for each warp (csrc/decoder_pass.cuh:kMaxChunks), hold
    the S keys and the step token."""
    return 32 * 2 * (threads // 32) - 1


# head_dim 128 (csrc/decoder_pass.cuh:kWideHead): a plan of its own, at
# hidden 512 only, in blocks of WIDE_THREADS threads, at most WIDE_STEPS
# chunk steps (its shared memory) and a head's whole K in the ring of
# CHUNK_RING 32-key chunks
WIDE_HEAD, WIDE_THREADS, WIDE_STEPS, CHUNK_RING = 128, 256, 10, 12


def kernel_max_context(head_dim: int) -> int:
    """Most context tokens of the decoder kernels at a head dim: 1023 (a
    16-warp block's chunks), 383 at head_dim 128 (the ring's chunks hold
    the S keys and the step token)."""
    return 32 * CHUNK_RING - 1 if head_dim == WIDE_HEAD else max_context(512)


def padded_joints(j: int) -> int:
    """The embedding's input width in the kernels: J rounded up to 32 (its
    product reads the reduction in 32-column blocks)."""
    return -(-j // 32) * 32


def padded_keys(s: int) -> int:
    """Keys per (layer, head) of the kernels' context K/V: the S context keys
    and the step token, rounded up to 32-key chunks."""
    return -(-(s + 1) // 32) * 32


# the opt-in shared memory of a thread block on sm_90 (227 KB), and the SMs of
# an H100 SXM, which the launch shapes assume where no card is asked (the
# shape checks of CPU tensors)
SMEM_LIMIT, H100_SMS = 232448, 132


def sm_count(device) -> int:
    """The SMs of ``device`` when it is a CUDA device, else the H100's."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


# Python mirrors of csrc/decoder_pass.cuh's shared-memory plan (the C
# function itself is exported as sd_pass_smem_bytes and held equal to this
# one on the card by chip_smoke.py)
def r4(n: int) -> int:
    return (n + 3) & ~3


def staged_params(D: int) -> bool:
    return D != WIDE_HEAD


def kv_buffers(D: int, threads: int) -> int:
    return CHUNK_RING if D == WIDE_HEAD else 4 if D == 32 and threads == 512 else 2


def bar_slots(D: int) -> int:
    return 16 if D == WIDE_HEAD else 4


def chunk_param_elems(L: int, E: int, P: int, J: int) -> int:
    """The staged per-layer parameters (ln_s, ln_b, qkv_b, so_b .. m2_b,
    emb_b, pe, fc_b), rounded up to 8 elements."""
    return (14 * L * E + E + P * E + J + 7) // 8 * 8


def pass_smem_bytes(L: int, P: int, E: int, H: int, J: int, Jp: int, Sp: int, threads: int,
                    cs: int, carry: int) -> int:
    """Bytes of shared memory a block of the decoder pass takes, for a kernel
    that keeps ``carry`` fp32 floats of its own: the mbarriers, the fp32
    residual, the carry, the attention statistics and partials (floats), the
    staged parameters, the bf16 activations, the K / V ring and, in a
    cluster, the two cross-attention outputs (halves)."""
    D = E // H
    floats = r4(P * E) + carry + (Sp // 32) * 64 + (threads // 32) * P * D
    halves = ((chunk_param_elems(L, E, P, J) if staged_params(D) else 0) + P * (E + 8)
              + P * (3 * E + 8) + P * (Jp + 8)
              + kv_buffers(D, threads) * (32 if D == WIDE_HEAD else Sp) * D
              + (2 * P * (E + 8) if cs > 1 else 0))
    return 8 * bar_slots(D) + 4 * floats + 2 * halves


def kfrag(s, d, D: int):
    """Index of element (key s, dim d) of a head's K in score-fragment order
    (the mirror of csrc/decoder_pass.cuh:kfrag; ints or integer arrays)."""
    dd = d & 15
    lane = 4 * (s & 7) + ((dd & 7) >> 1)
    reg = 2 * (d >> 4) + (dd >> 3)
    return (((s >> 3) * 32 + lane) * (D // 8) + reg) * 2 + (dd & 1)


def vfrag(s, d, D: int):
    """Index of element (key s, dim d) of a head's V in value-fragment order
    (the mirror of csrc/decoder_pass.cuh:vfrag)."""
    kk = s & 15
    lane = 4 * (d & 7) + ((kk & 7) >> 1)
    reg = 2 * (d >> 3) + (kk >> 3)
    return (((s >> 4) * 32 + lane) * (D // 4) + reg) * 2 + (kk & 1)


# the weight tensors of one decoder pass (csrc/decoder_pass.cuh:kPassWeights),
# the first entries of ``kernel_weights``
PASS_WEIGHTS = 19


class PackedKV(NamedTuple):
    """Context K/V packed for the denoiser kernel: ``kv`` (B, L, H, 2, Sp D)
    over ``context_len`` = S context keys (``FusedDenoiser.pack_context_kv``)."""

    kv: torch.Tensor
    context_len: int


def check_cuda_operand(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    """Raise unless the CUDA operand ``t`` lives on ``like``'s device."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, the packed weights on {like.device}")


class FusedDenoiser:
    """Packs the decoder weights of a ``DiffusionPolicy`` once and serves
    ``denoise(packed_kv, noisy, step_token)``."""

    launches = 0
    pack_launches = 0

    def __init__(self, model):
        cfg = model.config
        check_supported(cfg)
        self.cfg, self.dtype = cfg, model.dtype
        self.num_layers = cfg.num_decoder_layers
        self.num_heads = cfg.num_decoder_heads
        if cfg.hidden_dim % self.num_heads:
            raise ValueError(f"hidden_dim {cfg.hidden_dim} not divisible by "
                             f"num_decoder_heads {self.num_heads}")
        self.head_dim = cfg.hidden_dim // self.num_heads
        gen = model.diffusion_action_generator
        layers = gen.decoder.layers
        if len(layers) != self.num_layers:
            raise ValueError(f"decoder holds {len(layers)} layers, config says {self.num_layers}")

        def kernel(lin):  # nn.Linear weight (out, in) -> Dense kernel (in, out)
            return lin.weight.detach().t()

        def stack(fn):  # float32 masters -> the compute dtype
            return torch.stack([fn(lyr) for lyr in layers]).to(self.dtype).contiguous()

        sa = lambda lyr: lyr.self_attn
        ca = lambda lyr: lyr.cross_attn
        with torch.no_grad():
            self.qkv_w = stack(lambda l: torch.cat(
                [kernel(sa(l).q_proj), kernel(sa(l).k_proj), kernel(sa(l).v_proj)], dim=1))
            self.qkv_b = stack(lambda l: torch.cat(
                [sa(l).q_proj.bias, sa(l).k_proj.bias, sa(l).v_proj.bias]).detach())
            self.so_w = stack(lambda l: kernel(sa(l).out_proj))
            self.so_b = stack(lambda l: sa(l).out_proj.bias.detach())
            self.cq_w = stack(lambda l: kernel(ca(l).q_proj))
            self.cq_b = stack(lambda l: ca(l).q_proj.bias.detach())
            self.ck_w = stack(lambda l: kernel(ca(l).k_proj))
            self.ck_b = stack(lambda l: ca(l).k_proj.bias.detach())
            self.cv_w = stack(lambda l: kernel(ca(l).v_proj))
            self.cv_b = stack(lambda l: ca(l).v_proj.bias.detach())
            self.co_w = stack(lambda l: kernel(ca(l).out_proj))
            self.co_b = stack(lambda l: ca(l).out_proj.bias.detach())
            self.m1_w = stack(lambda l: kernel(l.mlp.linear1))
            self.m1_b = stack(lambda l: l.mlp.linear1.bias.detach())
            self.m2_w = stack(lambda l: kernel(l.mlp.linear2))
            self.m2_b = stack(lambda l: l.mlp.linear2.bias.detach())
            self.ln_s = stack(lambda l: torch.stack([l.norm1.weight, l.norm2.weight, l.norm3.weight]))
            self.ln_b = stack(lambda l: torch.stack([l.norm1.bias, l.norm2.bias, l.norm3.bias]))
            self.emb_w = kernel(gen.embedding).to(self.dtype).contiguous()
            self.emb_b = gen.embedding.bias.detach().to(self.dtype).contiguous()
            self.fc_w = kernel(gen.fc_out).to(self.dtype).contiguous()
            self.fc_b = gen.fc_out.bias.detach().to(self.dtype).contiguous()
            self.pe = gen.pos.table[: cfg.trajectory_prediction_length].to(self.dtype).contiguous()
            self.kernel_weights = self.pack_kernel_weights()
        self._kv_index = {}  # (S, device) -> pack_index

    def pack_kernel_weights(self) -> list[torch.Tensor]:
        """The PASS_WEIGHTS tensors ``csrc/decoder_pass.cuh:PassArgs`` reads, in
        its order, packed once into ``kernel_weights``: the Dense kernels
        transposed to (out, in) (the reduction axis contiguous) and ``emb_t``
        (E, Jp) with zero columns J .. Jp - 1."""
        E, J = self.cfg.hidden_dim, self.cfg.num_joints
        t = lambda w: w.transpose(-1, -2).contiguous()
        emb_t = self.emb_w.new_zeros((E, padded_joints(J)))
        emb_t[:, :J] = self.emb_w.t()
        return [emb_t, self.emb_b, self.pe, t(self.qkv_w), self.qkv_b, t(self.so_w), self.so_b,
                t(self.cq_w), self.cq_b, t(self.co_w), self.co_b, t(self.m1_w), self.m1_b,
                t(self.m2_w), self.m2_b, self.ln_s, self.ln_b, t(self.fc_w), self.fc_b]

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype).float()

    def pack_index(self, S: int, device) -> dict:
        """The index tensors of the plain pack for S context keys, built once per
        (S, device) from the mirrors of kfrag / vfrag: ``dst`` [l][sel]
        (S E,) the offset in a robot's (L H 2 Sp D) block of each element
        (key s, head h, dim d) of layer l's K (sel 0) or V (sel 1); ``pad``
        the offsets of keys S .. Sp - 1 in a (layer, head)'s (2 Sp D); ``src``
        [sel] (S D,) the offset in a K or V unit of each (key s, dim d)."""
        key = (S, str(device))
        if key not in self._kv_index:
            L, H, D = self.num_layers, self.num_heads, self.head_dim
            Sp = padded_keys(S)
            s, d = np.meshgrid(np.arange(Sp), np.arange(D), indexing="ij")
            pos = [kfrag(s, d, D), Sp * D + vfrag(s, d, D)]  # (Sp, D) in a head's (2 Sp D)
            dst = [[((l * H + np.arange(H))[None, :, None] * 2 * Sp * D + p[:S, None, :]).reshape(-1)
                    for p in pos] for l in range(L)]
            as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                                             device=device)
            self._kv_index[key] = {
                "dst": [[as_t(i) for i in layer] for layer in dst],
                "pad": as_t(np.concatenate([p[S:].reshape(-1) for p in pos])),
                "src": [as_t(p[:S].reshape(-1) - sel * Sp * D) for sel, p in enumerate(pos)]}
        return self._kv_index[key]

    def pack_context_kv(self, context_kv: list) -> PackedKV:
        """Per-layer [(k, v)] of (B, S, H, D) -> the kernel's layout (B, L, H,
        2, Sp D), keys past S zero, the step token's slot S among them: the
        pack kernel for CUDA tensors, the plain version for CPU tensors.
        Each denoiser launch writes its step token's key and value into slot
        S of its robots' (layer, head) units: the buffer is the launch's
        scratch as well as its input."""
        if context_kv[0][0].is_cuda:
            return self.pack_kernel(context_kv)
        return self.pack_plain(context_kv)

    def pack_plain(self, context_kv: list) -> PackedKV:
        """The plain version of the pack, on any device: an index copy per
        layer and K | V, and zeros in the keys past S."""
        k0 = context_kv[0][0]
        B, S = k0.shape[:2]
        H, D, E = self.num_heads, self.head_dim, self.cfg.hidden_dim
        idx = self.pack_index(S, k0.device)
        Sp = padded_keys(S)
        kv = torch.empty((B, self.num_layers * H * 2 * Sp * D), dtype=self.dtype, device=k0.device)
        for l, pair in enumerate(context_kv):
            for sel, t in enumerate(pair):
                kv.index_copy_(1, idx["dst"][l][sel], t.reshape(B, S * E).to(self.dtype))
        kv.view(B * self.num_layers * H, 2 * Sp * D).index_fill_(1, idx["pad"], 0)
        return PackedKV(kv.view(B, self.num_layers, H, 2, Sp * D), S)

    def pack_kernel(self, context_kv: list) -> PackedKV:
        """The pack kernel (``csrc/fused_denoise.cu:pack_context_kv_kernel``,
        a launch per layer) on CUDA tensors."""
        k0 = context_kv[0][0]
        B, S = k0.shape[:2]
        self.check_kernel_shapes(S, B, k0.device)
        L, H, D, Sp = self.num_layers, self.num_heads, self.head_dim, padded_keys(S)
        if len(context_kv) != L:
            raise ValueError(f"{len(context_kv)} layers of context K/V for a {L}-layer decoder")
        kv = torch.empty((B, L, H, 2, Sp * D), dtype=torch.bfloat16, device=k0.device)
        lib = _build.library()
        for l, (k, v) in enumerate(context_kv):
            for t, name in ((k, "context K"), (v, "context V")):
                check_cuda_operand(t, self.emb_w, name)
                if tuple(t.shape) != (B, S, H, D) or t.dtype != torch.bfloat16:
                    raise ValueError(f"{name} of layer {l}: {tuple(t.shape)} {t.dtype}, expected "
                                     f"({B}, {S}, {H}, {D}) bfloat16")
            err = lib.sd_pack_context_kv(_build.pointers(k.contiguous(), v.contiguous(), kv),
                                         _build.ints(B, L, l, H, D, S, Sp),
                                         _build.stream(k0.device))
            _build.check("sd_pack_context_kv", err)
            FusedDenoiser.pack_launches += 1
        return PackedKV(kv, S)

    def unpack_context_kv(self, packed: PackedKV) -> list:
        """The inverse of ``pack_context_kv``: per-layer [(k, v)] of (B, S,
        H, D) (the step token's slot and the padding dropped)."""
        kv, S = packed
        B = kv.shape[0]
        src = self.pack_index(S, kv.device)["src"]
        unit = lambda l, sel: (kv[:, l, :, sel].index_select(-1, src[sel])
                               .view(B, self.num_heads, S, self.head_dim).transpose(1, 2))
        return [(unit(l, 0), unit(l, 1)) for l in range(self.num_layers)]

    def step_tables(self, step_tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(T, E) step tokens -> per-step, per-layer cross K / V rows (T, L, E),
        projected outside the kernel (robot-independent)."""
        st = self._round(step_tokens)
        k = torch.einsum("te,lef->tlf", st, self.ck_w.float()) + self.ck_b.float()[None]
        v = torch.einsum("te,lef->tlf", st, self.cv_w.float()) + self.cv_b.float()[None]
        return k.to(self.dtype).contiguous(), v.to(self.dtype).contiguous()

    def step_token_kv(self, step_token: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(E,) shared step token -> per-layer cross K / V rows (L, E)."""
        k, v = self.step_tables(step_token[None])
        return k[0], v[0]

    def __call__(self, packed_kv, noisy: torch.Tensor, step_token: torch.Tensor,
                 ddim_coefs=None) -> torch.Tensor:
        """noisy (B, P, J); step_token (E,) shared by the batch; with
        ``ddim_coefs`` [1/sqrt(abar_t), sqrt(1-abar_t), sqrt(abar_prev),
        sqrt(1-abar_prev)] the pass returns x_prev instead of eps."""
        stk, stv = self.step_token_kv(step_token)
        coefs = None if ddim_coefs is None else [float(c) for c in np.asarray(ddim_coefs).reshape(-1)]
        return self.run(packed_kv, noisy, stk, stv, coefs)

    def sample(self, packed_kv, noise: torch.Tensor, step_token_table: torch.Tensor, schedule,
               num_inference_steps: int) -> torch.Tensor:
        """Full DDIM chunk with one denoiser pass (one kernel launch) per step."""
        T = num_inference_steps
        step = schedule.num_train_timesteps // T
        abar = np.array([(alpha_bar(schedule, int(t)), alpha_bar(schedule, int(t) - step))
                         for t in ddim_timesteps(schedule.num_train_timesteps, T)])
        abar_t, abar_prev = abar[:, 0], abar[:, 1]
        coefs = np.stack([1.0 / np.sqrt(abar_t), np.sqrt(1.0 - abar_t), np.sqrt(abar_prev),
                          np.sqrt(1.0 - abar_prev)], axis=1).astype(np.float32)
        k_tab, v_tab = self.step_tables(step_token_table)
        x = noise.float()
        for i in range(T):
            x = self.run(packed_kv, x, k_tab[i], v_tab[i], coefs[i].tolist())
        return x

    def run(self, packed_kv, noisy, stk, stv, coefs=None) -> torch.Tensor:
        """One pass given the per-step step-token K / V rows (L, E) and the
        optional DDIM coefficients: the kernel for CUDA tensors, the plain
        version for CPU tensors."""
        if noisy.is_cuda:
            return self.run_kernel(packed_kv, noisy, stk, stv, coefs)
        return self.run_plain(packed_kv, noisy, stk, stv, coefs)

    def run_plain(self, packed_kv, noisy, stk, stv, coefs=None) -> torch.Tensor:
        """The plain PyTorch version of the kernel, on any device: the context
        K/V read back through the inverse of the pack, the step token from
        stk / stv."""
        kv = self.unpack_context_kv(packed_kv)
        x = noisy.float()
        eps = self.plain_pass(x, [k.flatten(2) for k, _ in kv], [v.flatten(2) for _, v in kv],
                              stk, stv)
        if coefs is None:
            return eps
        c0, c1, c2, c3 = coefs
        return c2 * ((x - c1 * eps) * c0) + c3 * eps

    def plain_pass(self, x: torch.Tensor, ctx_k, ctx_v, stk: torch.Tensor,
                   stv: torch.Tensor, cross=None) -> torch.Tensor:
        """Plain PyTorch decoder pass: x (B, P, J) fp32, ctx_k[l] / ctx_v[l]
        (B, S, E), stk / stv (L, E) -> eps (B, P, J) fp32. The step-token
        column joins the context keys in one softmax; ``cross(l, q2)``, given,
        computes the cross-attention of layer l's bf16-valued queries (B, P,
        E) in its place (the chunk sampler's other forms)."""
        r, H, E = self._round, self.num_heads, self.cfg.hidden_dim
        f = lambda t: t.float()
        b = x.shape[0]
        h = r(x) @ f(self.emb_w) + f(self.emb_b) + f(self.pe)
        for l in range(self.num_layers):
            n1 = r(layer_norm(h, self.ln_s[l, 0], self.ln_b[l, 0]))
            q, k, v = r(n1 @ f(self.qkv_w[l]) + f(self.qkv_b[l])).split(E, dim=-1)
            h = h + (heads_attention(q, k, v, H, self.dtype) @ f(self.so_w[l]) + f(self.so_b[l]))
            n2 = r(layer_norm(h, self.ln_s[l, 1], self.ln_b[l, 1]))
            q2 = r(n2 @ f(self.cq_w[l]) + f(self.cq_b[l]))
            if cross is None:
                keys = torch.cat([f(ctx_k[l]), f(stk[l]).expand(b, 1, E)], dim=1)
                vals = torch.cat([f(ctx_v[l]), f(stv[l]).expand(b, 1, E)], dim=1)
                o = heads_attention(q2, keys, vals, H, self.dtype)
            else:
                o = cross(l, q2)
            h = h + (o @ f(self.co_w[l]) + f(self.co_b[l]))
            n3 = r(layer_norm(h, self.ln_s[l, 2], self.ln_b[l, 2]))
            m1 = r(F.gelu(n3 @ f(self.m1_w[l]) + f(self.m1_b[l]), approximate="none"))
            h = h + (m1 @ f(self.m2_w[l]) + f(self.m2_b[l]))
        return r(h) @ f(self.fc_w) + f(self.fc_b)

    def block_threads(self, batch: int, context_len: int, device) -> int:
        """The decoder kernels' threads per block for ``batch`` robots over
        ``context_len`` tokens: a robot per block of 16 warps while the card
        has an SM for each; past that, at head_dim 32, blocks of 8 warps, two
        on an SM (their shared memory fits twice), so that one robot's
        barrier waits hide behind the other's work (measured on the chunk
        sampler, an H100 80GB HBM3 at 700 W: h128 B=1024 21.0 against 26.1
        ms, B=64 4.49 against 3.61 ms; PERF.md), unless the context outgrows
        the 8 warps' scores (``max_context``). Head_dim 128 runs its own
        8-warp block (WIDE_THREADS: registers for its D = 128 accumulators),
        one an SM (its shared memory)."""
        if self.head_dim == WIDE_HEAD:
            return WIDE_THREADS
        two_an_sm = (self.head_dim == 32 and batch > sm_count(device)
                     and context_len <= max_context(256))
        return 256 if two_an_sm else 512

    def cluster_size(self, batch: int, device) -> int:
        """Thread blocks a robot: 2 (a cluster that splits the heads of
        the cross-attention, and in the chunk sampler of the context K/V
        projection, and shares the rest of each pass) while the card has two
        SMs for each robot, else 1 (measured on the chunk sampler, an H100
        80GB HBM3 at 700 W: h128 B=64 3.00 against 3.85 ms, head_dim 64 B=64
        6.92 against 7.73 ms; PERF.md)."""
        return 2 if 2 * batch <= sm_count(device) and self.num_heads % 2 == 0 else 1

    # fp32 floats of a pass's shared memory that the kernel keeps for itself
    # (the chunk sampler's solver carry; the denoiser keeps none)
    def pass_carry(self) -> int:
        return 0

    def smem_bytes(self, context_len: int, batch: int, device=None) -> int:
        """Shared memory a block of the kernel takes for ``batch`` robots over
        ``context_len`` tokens, at the launch shape it would get."""
        cfg = self.cfg
        return pass_smem_bytes(self.num_layers, cfg.trajectory_prediction_length, cfg.hidden_dim,
                               self.num_heads, cfg.num_joints, padded_joints(cfg.num_joints),
                               padded_keys(context_len),
                               self.block_threads(batch, context_len, device),
                               self.cluster_size(batch, device), self.pass_carry())

    def longest_context(self, batch: int, device=None) -> int:
        """The most context tokens whose plan fits ``SMEM_LIMIT`` at ``batch``
        robots (-1 where none does)."""
        fits = [s for s in range(31, kernel_max_context(self.head_dim) + 1, 32)
                if self.smem_bytes(s, batch, device) <= SMEM_LIMIT]
        return fits[-1] if fits else -1

    def check_kernel_shapes(self, context_len: int, batch: int = 1, device=None) -> None:
        """Raise for what the CUDA decoder kernels (the denoiser's and the
        chunk sampler's, one pass: csrc/decoder_pass.cuh) do not take:
        weights other than bf16; head_dim other than 32, 64 or 128; hidden
        other than 128 (head_dim 32 or 64), 256 (head_dim 64) or 512
        (head_dim 128); more than 16 chunk steps (10 at head_dim 128); an odd
        joint count or more than 64; more than ``kernel_max_context``
        context tokens (1023; 383 at head_dim 128); a plan whose shared
        memory (``pass_smem_bytes`` at the launch shape ``batch`` robots get
        on ``device``: the cluster while the card has two SMs a robot, so
        the default batch of 1 is the largest plan) exceeds ``SMEM_LIMIT``.
        At 10 chunk steps and 4 layers that is S <= 639 at head_dim 32,
        575 / 543 (one block / a cluster) at hidden 128 and head_dim 64, 447
        / 415 at hidden 256."""
        cfg, D = self.cfg, self.head_dim
        P, J, E = cfg.trajectory_prediction_length, cfg.num_joints, cfg.hidden_dim
        if self.dtype != torch.bfloat16:
            raise ValueError("the CUDA decoder kernels take bfloat16 weights "
                             "(compute_dtype='bfloat16'); got " + str(self.dtype))
        if D not in (32, 64, WIDE_HEAD):
            raise ValueError(f"the CUDA decoder kernels take head_dim 32 or 64 (hidden 128 / 256) "
                             f"or 128 (hidden 512), got {D}")
        steps = WIDE_STEPS if D == WIDE_HEAD else 16
        if P > steps or J % 2 or J > 64:
            raise ValueError(f"the CUDA decoder kernels take at most {steps} chunk steps at "
                             f"head_dim {D} and an even joint count of at most 64; got {P} steps, "
                             f"{J} joints")
        hidden_ok = E == 512 if D == WIDE_HEAD else E in (128, 256) and (D == 64 or E == 128)
        if not hidden_ok:
            raise ValueError(f"the CUDA decoder kernels take hidden_dim 128 (head_dim 32 or 64), "
                             f"256 (head_dim 64) or 512 (head_dim 128); got {E} at head_dim {D}")
        most = kernel_max_context(D)
        if context_len > most:
            raise ValueError(f"the CUDA decoder kernels take at most {most} context tokens; got "
                             f"{context_len}")
        smem = self.smem_bytes(context_len, batch, device)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"the CUDA decoder kernels' shared memory at {context_len} context tokens, "
                f"{self.num_layers} layers, hidden {E}, {P} chunk steps and {batch} robots is "
                f"{smem} bytes, past the {SMEM_LIMIT} a block has: they take at most "
                f"{self.longest_context(batch, device)} context tokens there")

    def run_kernel(self, packed_kv: PackedKV, noisy, stk, stv, coefs=None) -> torch.Tensor:
        """The CUDA kernel (``csrc/fused_denoise.cu``) on CUDA tensors; it
        writes the step token into slot S of ``packed_kv`` (see
        ``pack_context_kv``)."""
        kv, S = packed_kv
        self.check_kernel_shapes(S, kv.shape[0], kv.device)
        for t, name in ((noisy, "noisy"), (kv, "context K/V"), (stk, "step K")):
            check_cuda_operand(t, self.emb_w, name)
        cfg = self.cfg
        L, H, D, E = self.num_layers, self.num_heads, self.head_dim, cfg.hidden_dim
        P, J, B, Sp = cfg.trajectory_prediction_length, cfg.num_joints, kv.shape[0], padded_keys(S)
        if tuple(kv.shape) != (B, L, H, 2, Sp * D) or tuple(noisy.shape) != (B, P, J):
            raise ValueError(f"packed context K/V {tuple(kv.shape)} over {S} keys / noisy "
                             f"{tuple(noisy.shape)} do not match the decoder")
        if kv.dtype != torch.bfloat16 or not kv.is_contiguous():
            raise ValueError("packed context K/V must be contiguous bfloat16 (pack_context_kv)")
        dev = noisy.device
        noisy = noisy.float().contiguous()
        out = torch.empty_like(noisy)
        err = _build.library().sd_fused_denoise(
            _build.pointers(*self.kernel_weights[:PASS_WEIGHTS], noisy, kv,
                            stk.to(self.dtype).contiguous(), stv.to(self.dtype).contiguous(), out),
            _build.ints(L, E, H, P, J, padded_joints(J), B, S, Sp, int(coefs is not None),
                        self.block_threads(B, S, dev), self.cluster_size(B, dev)),
            _build.floats(*(coefs if coefs is not None else (0.0,) * 4)),
            _build.stream(dev))
        _build.check("sd_fused_denoise", err)
        FusedDenoiser.launches += 1
        return out
