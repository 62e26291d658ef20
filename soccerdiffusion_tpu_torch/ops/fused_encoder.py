"""Fused context encoder: all proprioceptive encoder stacks as ONE CUDA
kernel launch (``csrc/fused_encoder.cu``).

Counterpart of ``soccerdiffusion_tpu/ops/fused_encoder.py``: per stack,
patch-conv embed -> + sinusoidal posenc -> L x [LN1 -> 4-head self-attention
-> +res, LN2 -> exact-GELU MLP -> +res]; the game-state token is a row
gather of its embedding table; the result is the (B, S, E) context in
canonical order (action history, IMU, joint states, game state), the
contract of ``DiffusionPolicy.encode_context``.

The kernel reads the Dense kernels transposed, (out, in), and the
patch-conv kernel transposed with its input columns padded by zeros to a
multiple of 8 (``_Stack.pack_kernel_weights``), packed once per encoder.

Dispatch as in ``ops/fused_denoise.py``: a CUDA tensor launches the kernel
(bf16 weights, head_dim 32, at most 128 tokens per stack) or raises, a CPU
tensor runs the plain version. ``FusedContextEncoder.launches`` counts
kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn import functional as F

from soccerdiffusion_tpu_torch.config import check_supported
from soccerdiffusion_tpu_torch.models.encoders import IMUEncoder, JointEncoder
from soccerdiffusion_tpu_torch.ops import _build
from soccerdiffusion_tpu_torch.ops.fused_denoise import check_cuda_operand, heads_attention, layer_norm


@dataclass
class _Stack:
    """Packed weights of one encoder stack, in ``csrc/fused_encoder.cu:EncoderStack`` order."""

    key: str  # batch key
    tokens: int
    in_dim: int  # patch_size * channels
    emb_w: torch.Tensor  # (in_dim, E)
    emb_b: torch.Tensor
    pos: torch.Tensor  # (tokens, E)
    qkv_w: torch.Tensor  # (L, E, 3E)
    qkv_b: torch.Tensor
    o_w: torch.Tensor
    o_b: torch.Tensor
    ln_s: torch.Tensor  # (L, 2, E)
    ln_b: torch.Tensor
    m1_w: torch.Tensor
    m1_b: torch.Tensor
    m2_w: torch.Tensor
    m2_b: torch.Tensor

    @property
    def layers(self) -> int:
        return self.qkv_w.shape[0]

    def weights(self) -> list[torch.Tensor]:
        return [self.emb_w, self.emb_b, self.pos, self.qkv_w, self.qkv_b, self.o_w, self.o_b,
                self.ln_s, self.ln_b, self.m1_w, self.m1_b, self.m2_w, self.m2_b]

    @property
    def in_pad(self) -> int:
        """The embedding's reduction width in the kernel: in_dim rounded up to 8."""
        return -(-self.in_dim // 8) * 8

    def pack_kernel_weights(self) -> list[torch.Tensor]:
        """The 13 weights in ``csrc/fused_encoder.cu:EncoderStack`` order:
        every Dense kernel transposed to (out, in), the patch-conv kernel as
        (E, in_pad) with zero columns in_dim .. in_pad - 1."""
        t = lambda w: w.transpose(-1, -2).contiguous()
        emb_t = self.emb_w.new_zeros((self.emb_w.shape[1], self.in_pad))
        emb_t[:, : self.in_dim] = self.emb_w.t()
        return [emb_t, self.emb_b, self.pos, t(self.qkv_w), self.qkv_b, t(self.o_w), self.o_b,
                self.ln_s, self.ln_b, t(self.m1_w), self.m1_b, t(self.m2_w), self.m2_b]


class FusedContextEncoder:
    """Packs the policy's proprioceptive encoder weights once, cast from the
    float32 masters to the compute dtype, and serves ``encode(batch) -> (B, S, E)``."""

    launches = 0

    def __init__(self, model):
        cfg = model.config
        check_supported(cfg)
        self.cfg, self.dtype = cfg, model.dtype
        self.num_heads = JointEncoder.num_heads
        if IMUEncoder.num_heads != self.num_heads:
            raise ValueError("the fused encoder assumes one head count for all modality stacks")
        if cfg.hidden_dim % self.num_heads:
            raise ValueError(f"hidden_dim {cfg.hidden_dim} not divisible by {self.num_heads} heads")
        self.head_dim = cfg.hidden_dim // self.num_heads
        mods = []  # (module, batch key) in canonical context order
        if cfg.use_action_history:
            mods.append((model.action_history_encoder, "joint_command_history"))
        if cfg.use_imu:
            mods.append((model.imu_encoder, "rotation"))
        if cfg.use_joint_states:
            mods.append((model.joint_states_encoder, "joint_state"))
        if not mods:
            raise ValueError("no sequence encoders enabled")

        def kernel(lin):
            return lin.weight.detach().t().to(self.dtype)

        self.stacks: list[_Stack] = []
        with torch.no_grad():
            for mod, key in mods:
                seq = mod.seq
                conv = seq.embedding.proj  # weight (E, C, ps)
                E, C, ps = conv.weight.shape
                T = {"joint_command_history": cfg.action_context_length,
                     "rotation": cfg.imu_context_length,
                     "joint_state": cfg.joint_state_context_length}[key]
                if T % ps:
                    raise ValueError(f"{key}: context length {T} not divisible by patch {ps}")
                layers = seq.encoder.layers

                def stack(fn):
                    return torch.stack([fn(lyr) for lyr in layers]).to(self.dtype).contiguous()

                sa = lambda lyr: lyr.self_attn
                self.stacks.append(_Stack(
                    key=key, tokens=T // ps, in_dim=ps * C,
                    # patch element k of channel c is feature k * C + c
                    emb_w=conv.weight.detach().permute(2, 1, 0).reshape(ps * C, E)
                    .to(self.dtype).contiguous(),
                    emb_b=conv.bias.detach().to(self.dtype).contiguous(),
                    pos=seq.pos.table[: T // ps].to(self.dtype).contiguous(),
                    qkv_w=stack(lambda l: torch.cat(
                        [kernel(sa(l).q_proj), kernel(sa(l).k_proj), kernel(sa(l).v_proj)], dim=1)),
                    qkv_b=stack(lambda l: torch.cat(
                        [sa(l).q_proj.bias, sa(l).k_proj.bias, sa(l).v_proj.bias]).detach()),
                    o_w=stack(lambda l: kernel(sa(l).out_proj)),
                    o_b=stack(lambda l: sa(l).out_proj.bias.detach()),
                    ln_s=stack(lambda l: torch.stack([l.norm1.weight, l.norm2.weight])),
                    ln_b=stack(lambda l: torch.stack([l.norm1.bias, l.norm2.bias])),
                    m1_w=stack(lambda l: kernel(l.mlp.linear1)),
                    m1_b=stack(lambda l: l.mlp.linear1.bias.detach()),
                    m2_w=stack(lambda l: kernel(l.mlp.linear2)),
                    m2_b=stack(lambda l: l.mlp.linear2.bias.detach())))
            self.kernel_weights = [st.pack_kernel_weights() for st in self.stacks]
            self.gs_table = (model.game_state_encoder.embedding.weight.detach().to(self.dtype)
                             .contiguous()
                             if cfg.use_gamestate else None)
        self.num_tokens = sum(s.tokens for s in self.stacks) + (self.gs_table is not None)

    def _inputs(self, batch) -> list[torch.Tensor]:
        """Patch-folded (B, tokens, in_dim) inputs in the compute dtype."""
        return [batch[s.key].to(self.dtype).reshape(-1, s.tokens, s.in_dim) for s in self.stacks]

    def _game_state(self, batch) -> torch.Tensor:
        return batch["game_state"].long().clamp(0, self.gs_table.shape[0] - 1)

    def encode(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Same contract as ``DiffusionPolicy.encode_context``: the kernel for
        CUDA tensors, the plain version for CPU tensors."""
        if batch[self.stacks[0].key].is_cuda:
            return self.encode_kernel(batch)
        return self.encode_plain(batch)

    def encode_plain(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """The plain PyTorch version of the kernel, on any device."""
        xs = self._inputs(batch)
        r = lambda t: t.to(self.dtype).float()
        f = lambda t: t.float()
        pieces = []
        for st, x in zip(self.stacks, xs):
            h = f(x) @ f(st.emb_w) + f(st.emb_b) + f(st.pos)
            for l in range(st.layers):
                n1 = r(layer_norm(h, st.ln_s[l, 0], st.ln_b[l, 0]))
                q, k, v = r(n1 @ f(st.qkv_w[l]) + f(st.qkv_b[l])).split(self.cfg.hidden_dim, dim=-1)
                o = heads_attention(q, k, v, self.num_heads, self.dtype)
                h = h + (o @ f(st.o_w[l]) + f(st.o_b[l]))
                n2 = r(layer_norm(h, st.ln_s[l, 1], st.ln_b[l, 1]))
                m1 = r(F.gelu(n2 @ f(st.m1_w[l]) + f(st.m1_b[l]), approximate="none"))
                h = h + (m1 @ f(st.m2_w[l]) + f(st.m2_b[l]))
            pieces.append(h.to(self.dtype))
        if self.gs_table is not None:
            pieces.append(self.gs_table[self._game_state(batch)][:, None])
        return torch.cat(pieces, dim=1)

    def encode_kernel(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """The CUDA kernel (``csrc/fused_encoder.cu``) on CUDA tensors."""
        if self.dtype != torch.bfloat16:
            raise ValueError("the CUDA encoder kernel takes bfloat16 weights "
                             f"(compute_dtype='bfloat16'); got {self.dtype}")
        if self.head_dim != 32:
            raise ValueError(f"the CUDA context-encoder kernel takes head_dim 32 (h128), got "
                             f"{self.head_dim}; h256 configs use the fused encoder stack "
                             "(encoder_fused_stack)")
        if max(s.tokens for s in self.stacks) > 128:
            raise ValueError("the CUDA encoder kernel takes at most 128 tokens per stack")
        E = self.cfg.hidden_dim
        xs = [x.contiguous() for x in self._inputs(batch)]
        B, dev = xs[0].shape[0], xs[0].device
        for x, st in zip(xs, self.stacks):
            check_cuda_operand(x, st.emb_w, st.key)
        gs = None
        if self.gs_table is not None:
            gs = self._game_state(batch).to(device=dev, dtype=torch.int32).contiguous()
        out = torch.empty((B, self.num_tokens, E), dtype=torch.bfloat16, device=dev)
        ptrs, meta, offset = [], [], 0
        for st, x, w in zip(self.stacks, xs, self.kernel_weights):
            ptrs += [x, *w]
            meta += [st.tokens, st.in_dim, st.in_pad, st.layers, offset]
            offset += st.tokens
        err = _build.library().sd_fused_encoder(
            _build.pointers(*ptrs, gs, self.gs_table, out),
            _build.ints(len(self.stacks), B, self.num_tokens, E, self.num_heads, *meta),
            _build.stream(dev))
        _build.check("sd_fused_encoder", err)
        FusedContextEncoder.launches += 1
        return out
