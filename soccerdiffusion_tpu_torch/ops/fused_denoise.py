"""Fused serving-path denoiser: one pass of the whole cross-attending
decoder as one CUDA kernel (``csrc/fused_denoise.cu``).

Counterpart of ``soccerdiffusion_tpu/ops/fused_denoise.py``: the kernel runs
embedding -> posenc -> L x [self-attention, cross-attention against the
pre-projected context K/V plus the shared step-token K/V in one softmax,
exact-GELU MLP] -> output projection for each robot, and returns eps, or
x_prev when DDIM coefficients are given. ``FusedDenoiser.__init__`` packs the
decoder weights once; ``FusedChunkSampler`` (``ops/fused_chunk.py``)
inherits the packing and the plain decoder pass.

Dispatch: a CUDA tensor launches the kernel (bf16 weights, head_dim 32 or
64) or raises; a CPU tensor runs the plain PyTorch version below, which rounds to
the compute dtype at the kernel's rounding points (``csrc/common.cuh``).
``FusedDenoiser.launches`` counts kernel launches.

Noise precision: the carry x is fp32 throughout (the TPU kernel rounds it
to bf16 on entry); only the embedding matmul's input is rounded, as the
unfused path's per-step cast does.
"""

from __future__ import annotations

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


def check_cuda_operand(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    """Raise unless the CUDA operand ``t`` lives on ``like``'s device."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, the packed weights on {like.device}")


class FusedDenoiser:
    """Packs the decoder weights of a ``DiffusionPolicy`` once and serves
    ``denoise(packed_kv, noisy, step_token)``."""

    launches = 0

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

    def weights(self) -> list[torch.Tensor]:
        """The 19 packed tensors in ``csrc/decoder_layer.cuh:DecoderWeights`` order."""
        return [self.emb_w, self.emb_b, self.pe, self.qkv_w, self.qkv_b, self.so_w, self.so_b,
                self.cq_w, self.cq_b, self.co_w, self.co_b, self.m1_w, self.m1_b, self.m2_w,
                self.m2_b, self.ln_s, self.ln_b, self.fc_w, self.fc_b]

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype).float()

    def pack_context_kv(self, context_kv: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-layer [(k, v)] of (B, S, H, D) -> stacked (L, B, S, E) k and v."""
        ks = torch.stack([k.reshape(k.shape[0], k.shape[1], -1) for k, _ in context_kv])
        vs = torch.stack([v.reshape(v.shape[0], v.shape[1], -1) for _, v in context_kv])
        return ks.to(self.dtype).contiguous(), vs.to(self.dtype).contiguous()

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
        """The plain PyTorch version of the kernel, on any device."""
        ck, cv = packed_kv
        x = noisy.float()
        eps = self.plain_pass(x, ck, cv, stk, stv)
        if coefs is None:
            return eps
        c0, c1, c2, c3 = coefs
        return c2 * ((x - c1 * eps) * c0) + c3 * eps

    def plain_pass(self, x: torch.Tensor, ctx_k, ctx_v, stk: torch.Tensor,
                   stv: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch decoder pass: x (B, P, J) fp32, ctx_k[l] / ctx_v[l]
        (B, S, E), stk / stv (L, E) -> eps (B, P, J) fp32. The step-token
        column joins the context keys in one softmax."""
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
            keys = torch.cat([f(ctx_k[l]), f(stk[l]).expand(b, 1, E)], dim=1)
            vals = torch.cat([f(ctx_v[l]), f(stv[l]).expand(b, 1, E)], dim=1)
            h = h + (heads_attention(q2, keys, vals, H, self.dtype) @ f(self.co_w[l]) + f(self.co_b[l]))
            n3 = r(layer_norm(h, self.ln_s[l, 2], self.ln_b[l, 2]))
            m1 = r(F.gelu(n3 @ f(self.m1_w[l]) + f(self.m1_b[l]), approximate="none"))
            h = h + (m1 @ f(self.m2_w[l]) + f(self.m2_b[l]))
        return r(h) @ f(self.fc_w) + f(self.fc_b)

    def check_kernel_shapes(self) -> None:
        """Raise for what the CUDA decoder kernels do not take."""
        if self.dtype != torch.bfloat16:
            raise ValueError("the CUDA decoder kernels take bfloat16 weights "
                             "(compute_dtype='bfloat16'); got " + str(self.dtype))
        if self.head_dim not in (32, 64):
            raise ValueError(f"the CUDA decoder kernels take head_dim 32 or 64, got "
                             f"{self.head_dim}")
        if self.cfg.trajectory_prediction_length > 128:
            raise ValueError("the CUDA decoder kernels take at most 128 chunk steps")

    def run_kernel(self, packed_kv, noisy, stk, stv, coefs=None) -> torch.Tensor:
        """The CUDA kernel (``csrc/fused_denoise.cu``) on CUDA tensors."""
        self.check_kernel_shapes()
        ck, cv = packed_kv
        for t, name in ((noisy, "noisy"), (ck, "context K"), (cv, "context V"), (stk, "step K")):
            check_cuda_operand(t, self.emb_w, name)
        L, B, S, E = ck.shape
        cfg = self.cfg
        if (L, E) != (self.num_layers, cfg.hidden_dim) or cv.shape != ck.shape:
            raise ValueError(f"packed context K/V of shape {tuple(ck.shape)} do not match the decoder")
        if ck.dtype != torch.bfloat16 or cv.dtype != torch.bfloat16:
            raise ValueError("packed context K/V must be bfloat16")
        noisy = noisy.float().contiguous()
        out = torch.empty_like(noisy)
        lib = _build.library()
        err = lib.sd_fused_denoise(
            _build.pointers(*self.weights(), noisy, ck.contiguous(), cv.contiguous(),
                            stk.to(self.dtype).contiguous(), stv.to(self.dtype).contiguous(), out),
            _build.ints(L, E, self.num_heads, cfg.trajectory_prediction_length, cfg.num_joints,
                        B, S, int(coefs is not None)),
            _build.floats(*(coefs if coefs is not None else (0.0,) * 4)),
            _build.stream(noisy.device))
        _build.check("sd_fused_denoise", err)
        FusedDenoiser.launches += 1
        return out
