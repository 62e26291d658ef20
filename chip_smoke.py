"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the torch / CUDA versions and the card's name and power limit.
2. Builds the CUDA kernels of soccerdiffusion_tpu_torch/csrc (nvcc, sm_90a)
   and reads the library's SASS (cuobjdump -sass): every instance of the
   ViT-block, encoder-stack, decoder-layer, tdot, chunk-sampler, denoiser
   and context-encoder kernels and every bf16 instance of the flash kernels
   must hold tensor-core instructions (HMMA / HGMMA); the fp32 flash
   instances are logged as scalar.
3. Holds each serving kernel against its plain PyTorch version on the card
   at the h128 serving path's shapes (S=301 context tokens, 30 DDIM steps,
   B=64 and B=1024; bf16 weights from a seeded flax-layout random init) and
   times both with CUDA events; the denoiser's context K/V pack kernel
   (pack_context_kv) too, bit for bit its plain version.
4. Drives the proprioceptive serving loop through
   RolloutEngine.make_rollout_fn at the bench configuration (default.yaml
   architecture without images, bf16, B=1024): 5 replan periods of 30-step
   DDIM with the fused encoder + chunk kernels, 5 of the 1-step distilled
   student through the fused denoiser, then 5 of 30-step DDIM through the
   per-step denoiser (fused=True: 30 denoiser launches a period), with
   every launch counter zeroed just before and read just after each; then
   checks a short rollout of the kernel path against the same engine's
   plain versions on the CPU.
5. Holds the training kernels (fused encoder stack and fused decoder layer,
   forward and backward) against their plain versions at the training
   shapes (T=100 / L=2 encoder stacks, T=10 x S=302 decoder layers) at B=64
   and B=256: the output, the input gradients and every weight gradient.
6. Trains through training/train.py's loop (synthetic data, the bench
   configuration with encoder_fused_stack and decoder_fused_block, bf16,
   B=64, 20 steps) with the four training counters zeroed just before and
   read just after, then the same loop with both knobs off; then 3 steps
   on the card against the same 3 steps on the CPU (plain versions).
7. The camera-conditioned flagship (vit_flagship.yaml's model, built in
   code: h256, 4 heads of 64, the 8-block width-256 ViT over 224 px frames
   in 64 patches of 28 px, quick GELU, bf16): holds the fused ViT block,
   the head_dim-64 chunk, denoiser and encoder-stack-forward instances and
   the image-frame stack's head_dim-32 forward against their plain versions
   at B=64 and B=256 robots (2 frames per robot for the ViT), and the ViT
   block at the raw-frame lane's 640 frames; drives 5 replan periods at
   B=64 of each of the three lanes of the JAX package's serving benchmark
   (30-step DDIM with the image-token cache, the same with raw frames, the
   distilled student with the cache) with the launch counters zeroed
   before and read after each; then 2 cached DDIM periods on the card
   against the same engine's plain versions on the CPU.
8. The flagship's training (soccerdiffusion_tpu_torch/training/configs/
   vit_flagship.yaml): holds the ViT block's backward (N=128 and N=640
   frames), the head_dim-64 encoder-stack backward (T=100, L=2), the
   image-frame stack's backward (head_dim 32, 8 heads, T=10, L=1) and the
   head_dim-64 decoder layer's forward and backward (T=10 over S=312 memory
   rows) against their plain versions at B=64 and B=256 robots (every
   output, input gradient and weight gradient); trains 20 steps through
   training/train.py on packed dummy data (uint8 frames, pre-patchified) at
   B=64 with every launch counter zeroed before and read after (exact
   launches per step checked), then 3 steps at the YAML's own B=256 (ms of
   the last step, peak device memory); then 3 steps on the card against the
   same 3 steps on the CPU (plain versions) at B=2.
9. Flash attention (ops/flash_attention.py): holds the kernel's forward
   and backward (o, dq, dk, dv) against their plain versions in fp32 and
   bf16 at the flash flagship's shapes at B=64 robots (the ViT over 640
   frames, the image-frame stack, the proprioceptive stacks, the decoder's
   self- and cross-attention), the h128 stacks' head_dim 32, the "auto"
   threshold (Tq = Tk = 256), Tk = 1536, an unaligned shape and head_dim
   48, each timed beside F.scaled_dot_product_attention's forward and one
   torch.autograd.grad through it (library_ms; the port never calls it). Then the flash flagship, vit_flagship.yaml's
   model with attention_impl="pallas" and the three fused knobs off, so
   that every attention runs the kernel: 5 replan periods of 30-step DDIM
   with the image-token cache at B=64 through RolloutEngine(fused=False)
   and 2 periods on the card against the CPU; 20 training steps through
   training/train.py on packed dummy data at B=64 and 3 card-vs-CPU steps
   at B=2; exact flash launches per period and per step, and no fused
   kernel. Phase 6 also trains the unfused h128 step with "pallas" (the
   head_dim-32 T=100 shape); every earlier path, which runs "auto" at
   shapes under its threshold, launches no flash kernel.
10. The ResNet / Swin slice. default_tpu.yaml's model (ResNet18 at 224 px
   with the spatial head, h128, bf16, remat_image_encoder "conv_only"):
   the per-frame encoder timed over 128 and 640 frames (FLOPs per ms
   against the bf16 peak); the chunk sampler, the K/V pack and the
   denoiser against their plain versions at its lanes' shape (head_dim 32,
   S=311, B=64); 5 replan periods at B=64 of each serving lane
   (cached 30-step DDIM through the chunk sampler, the same with raw
   frames, the distilled student through the denoiser and its K/V pack;
   exact launches per period, no fused encoder) and 2 cached periods on
   the card against the CPU at B=4; 20 training steps through
   training/train.py on packed whole-frame uint8 data at B=64 (no kernel
   of the port runs there: the ResNet is cuDNN's convolutions, the layers
   unfused), 3 at the YAML's B=128 with "conv_only" and with remat off
   (peak device memory of each), 3 card-vs-CPU steps at B=2 (losses,
   update norm, BatchNorm running statistics). ResNet50 and Swin-T
   forwards on the card against the CPU (float32, TF32 off) and timed in
   bf16. decoder_only.yaml's model in bf16: the chunk sampler, the K/V pack
   and the denoiser against their plain versions at S=0 context tokens
   (B=64 and 256), its two serving lanes at B=64 (exact launches) and 20
   training steps.
11. Prints one JSON line of per-kernel results, then as its last line
   {"ok": true, "device": {...}}. Where one torch.nn call computes the
   same function as a kernel (the encoder-stack, ViT-block and
   decoder-layer forwards; one torch.autograd.grad through the same layers
   for their backwards, checked against the plain backward;
   scaled_dot_product_attention for the flash forward, one autograd.grad
   through it for the flash backward), its time on the same inputs is the
   entry's library_ms; the port never calls those.

Exits non-zero, without the last line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --profile-training [--flagship [--flash]] [--profile-out FILE]
    python3 chip_smoke.py --profile-serving [--flash | --resnet] [--profile-out FILE]
    python3 chip_smoke.py --profile-training --resnet [--profile-out FILE]

build the kernels and instead trace, with torch.profiler, the h128 B=64
training step (fused knobs on, then off), with --flagship the flagship's
B=64 training step (packed data; with --flash the flash flagship's), or 3
replan periods of each flagship serving lane at B=64 (with --flash the
flash flagship's cached ddim30 lane; with --resnet default_tpu.yaml's
three lanes; --profile-training --resnet its B=64 training step): per step or period the host wall
clock, the device busy time (the union of the device ops' intervals), the
device's idle share, both taken from the same trace, and the largest device
ops. FILE receives the full tables. None prints the ok line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# kernel-vs-plain tolerance on the card, as a share of the output's scale:
# max |kernel - plain| <= TOL * max |plain|. Both sides round to bf16 at the
# same points, so they differ by fp32 summation order plus the bf16
# roundings that order flips (2^-8 = 0.4% of the value each), carried
# through the layers and, for the chunk, 30 solver steps. The seeded random
# model is untrained: its eps is not unit-scale and the DDIM chunk grows to
# |x| ~ 1e3, so an absolute bound would mean nothing. Measured on an H100:
# kernel - plain ~0.5% of scale at every step count, bf16 plain - fp32
# plain ~1.4% after 30 steps (PERF.md).
TOL = 2e-2
ROLLOUT_TOL = 2e-2  # the same bound on each replan period's chunk
BENCH_B, CHUNKS = 1024, 5
# the flagship: kernel checks at B robots (2 frames each for the ViT), the
# three serving lanes at FLAG_B robots for CHUNKS periods each
FLAG_BATCHES, FLAG_B = (64, 256), 64
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core FLOP/s
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
# training kernels: every output and weight gradient within TRAIN_TOL x
# max|plain| of that tensor (bf16 at the same rounding points, fp32 sums in
# another order); the key-bias gradients, zero in exact arithmetic, within
# TRAIN_TOL x the largest weight gradient of their layer instead
TRAIN_TOL = 2e-2
TRAIN_BATCHES, TRAIN_STEPS, TRAIN_BATCH = (64, 256), 20, 64
TRAIN_LOG_EVERY = 4  # two epochs of 10 steps: syncs at steps 4, 8 | 12, 16, 20
# 3 steps on the card vs on the CPU: the losses within 2e-2 relative; the
# parameter updates within 0.1 of the update norm (AdamW normalises each
# step to ~lr, so entries whose gradient is float noise, such as the key
# biases, take steps of either sign)
STEP_LOSS_TOL, STEP_UPDATE_TOL = 2e-2, 0.1
# the flagship's training: the ViT backward's frames (2 and 10 per robot at
# B=64), the training path's batch (the benchmark's cell) and the YAML's own
FLAG_VIT_FRAMES, FLAG_TRAIN_B, FLAG_TRAIN_FULL_B = (128, 640), 64, 256
FLAG_YAML = (Path(__file__).resolve().parent / "soccerdiffusion_tpu_torch" / "training" / "configs"
             / "vit_flagship.yaml")
# kernel launches per flagship training step: 8 ViT blocks, 3 proprioceptive
# stacks (head_dim 64) + the image-frame stack (head_dim 32), 4 decoder
# layers (head_dim 64), each forward and backward
FLAG_TRAIN_LAUNCHES = {
    "fused_vit_block_fwd": 8, "fused_vit_block_bwd": 8,
    "fused_encoder_stack_fwd": 4, "fused_encoder_stack_fwd_hd64": 3,
    "fused_encoder_stack_bwd": 4, "fused_encoder_stack_bwd_hd64": 3,
    "fused_decoder_layer_fwd": 4, "fused_decoder_layer_fwd_hd64": 4,
    "fused_decoder_layer_bwd": 4, "fused_decoder_layer_bwd_hd64": 4}
# torch.nn's layers against the plain version, only to show that they were
# built from the same weights (a wrong mapping gives errors of the order of
# the output): torch rounds the residual stream to bf16 at every sublayer
LIBRARY_TOL = 0.1
# kernels that must run on the tensor cores: every instance whose mangled
# name holds the second string (the bf16 flash instances; the others: every
# instance) has HMMA (mma.sync) or HGMMA (wgmma) instructions in its SASS
TENSOR_CORE_KERNELS = (
    ("vit_block_fwd_kernel", ""), ("vit_block_bwd_kernel", ""), ("encoder_stack_fwd_kernel", ""),
    ("encoder_stack_bwd_kernel", ""), ("tdot_kernel", ""), ("decoder_layer_fwd_kernel", ""),
    ("decoder_layer_bwd_kernel", ""), ("fused_chunk_kernel", ""), ("fused_denoise_kernel", ""),
    ("fused_encoder_kernel", ""), ("flash_fwd_kernel", "__nv_bfloat16"),
    ("flash_bwd_dq_kernel", "__nv_bfloat16"), ("flash_bwd_dkdv_kernel", "__nv_bfloat16"))
# kernel instances that stay scalar fp32 FMAs (logged with their counts)
SCALAR_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
# H100 SXM fp32 peak outside the tensor cores (NVIDIA data sheet): the bound
# of the flash kernel's fp32 instances
FP32_FLOPS = 67e12
# the flash kernel against its plain version, (B, Tq, Tk, H, D): the flash
# flagship's shapes at B=64 robots (the ViT over 10 frames per robot), the
# h128 stacks' head_dim 32, the "auto" threshold, the TPU kernel's streamed
# regime (Tk > 1024), an unaligned shape and head_dim 48; the first is the
# one the JSON line's flash entries time
FLASH_SHAPES = {
    "vit_640_frames": (640, 64, 64, 4, 64),
    "frame_stack": (64, 10, 10, 8, 32),
    "stacks": (64, 100, 100, 4, 64),
    "decoder_self": (64, 10, 10, 4, 64),
    "decoder_cross": (64, 10, 312, 4, 64),
    "h128_stacks": (64, 100, 100, 4, 32),
    "auto_threshold": (16, 256, 256, 4, 64),
    "tk_1536": (8, 64, 1536, 4, 64),
    "unaligned": (3, 7, 13, 2, 8),
    "head_dim_48": (2, 196, 196, 4, 48),
}


def log(*a):
    print(*a, flush=True)


def bench_config():
    from soccerdiffusion_tpu_torch.config import ModelConfig

    return ModelConfig(  # bench.py:73-90 with its defaults (patch 1, bf16)
        num_joints=20, hidden_dim=128, trajectory_prediction_length=10,
        action_context_length=100, joint_state_context_length=100, imu_context_length=100,
        use_images=False, use_gamestate=True, num_action_history_encoder_layers=2,
        num_imu_encoder_layers=2, joint_state_encoder_layers=2, num_decoder_layers=4,
        encoder_patch_size=1, compute_dtype="bfloat16")


def build_model(cfg, device, seed=1):
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

    model = DiffusionPolicy(cfg)
    return load_jax_params(model, *random_jax_params(model, seed)).to(device).eval()


def random_batch(cfg, b, device, rng):
    t = lambda a: torch.from_numpy(a).to(device)
    return {
        "joint_command_history": t(rng.uniform(0, 2 * np.pi, (b, 100, 20)).astype(np.float32)),
        "rotation": t(rng.normal(size=(b, 100, cfg.imu_input_dim)).astype(np.float32)),
        "joint_state": t(rng.uniform(0, 2 * np.pi, (b, 100, 20)).astype(np.float32)),
        "game_state": t(rng.integers(0, 4, (b,))),
    }


# ------------------------------------------------------- bounds
# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the HBM rate
# and its matmul FLOPs (bf16 operands) over the bf16 tensor-core peak.

def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested lists / tuples flattened; None skipped)."""
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound(flops: float, io_bytes: int, peak: float = BF16_FLOPS) -> dict:
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------- library calls
# torch.nn's pre-norm layers compute the same functions as the fused
# encoder-stack, ViT-block and decoder-layer forwards (with torch's own
# rounding points: a bf16 residual stream). Built here from the kernels'
# bf16 weights and timed for the library_ms column; the port never calls
# them. The fused context encoder, chunk sampler and denoiser, and the
# backward kernels, have no one-call counterpart (library_ms null).

def quick_gelu(z):
    return z * torch.sigmoid(1.702 * z)


def torch_encoder(w, num_heads: int, activation="gelu"):
    """nn.TransformerEncoderLayer (one layer) or nn.TransformerEncoder (L
    layers) on stacked (L, ...) weights in STACK_WEIGHTS order."""
    from torch import nn

    L, E, FF = w[0].shape[0], w[0].shape[-1], w[8].shape[-1]
    layers = []
    for l in range(L):
        g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1, w2, b2 = (t[l] for t in w)
        layer = nn.TransformerEncoderLayer(
            E, num_heads, FF, dropout=0.0, activation=activation, layer_norm_eps=1e-6,
            batch_first=True, norm_first=True, device=wqkv.device, dtype=wqkv.dtype)
        with torch.no_grad():
            for dst, src in ((layer.norm1.weight, g1), (layer.norm1.bias, be1),
                             (layer.self_attn.in_proj_weight, wqkv.t()),
                             (layer.self_attn.in_proj_bias, bqkv),
                             (layer.self_attn.out_proj.weight, wo.t()),
                             (layer.self_attn.out_proj.bias, bo),
                             (layer.norm2.weight, g2), (layer.norm2.bias, be2),
                             (layer.linear1.weight, w1.t()), (layer.linear1.bias, b1),
                             (layer.linear2.weight, w2.t()), (layer.linear2.bias, b2)):
                dst.copy_(src)
        layers.append(layer.eval())
    if L == 1:
        return layers[0]
    stack = nn.TransformerEncoder(layers[0], L, enable_nested_tensor=False)
    stack.layers = nn.ModuleList(layers)
    return stack.eval()


def torch_decoder_layer(w, num_heads: int):
    """nn.TransformerDecoderLayer on weights in WEIGHT_NAMES order (the
    memory enters the cross-attention un-normed, as in the fused layer)."""
    from torch import nn

    (g1, be1, wqkv, bqkv, wso, bso, g2, be2, wcq, bcq, wck, bck, wcv, bcv, wco, bco,
     g3, be3, w1, b1, w2, b2) = w
    E, FF = g1.shape[0], w1.shape[-1]
    layer = nn.TransformerDecoderLayer(
        E, num_heads, FF, dropout=0.0, activation="gelu", layer_norm_eps=1e-6,
        batch_first=True, norm_first=True, device=wqkv.device, dtype=wqkv.dtype)
    with torch.no_grad():
        for dst, src in ((layer.norm1.weight, g1), (layer.norm1.bias, be1),
                         (layer.self_attn.in_proj_weight, wqkv.t()),
                         (layer.self_attn.in_proj_bias, bqkv),
                         (layer.self_attn.out_proj.weight, wso.t()),
                         (layer.self_attn.out_proj.bias, bso),
                         (layer.norm2.weight, g2), (layer.norm2.bias, be2),
                         (layer.multihead_attn.in_proj_weight, torch.cat([wcq, wck, wcv], 1).t()),
                         (layer.multihead_attn.in_proj_bias, torch.cat([bcq, bck, bcv])),
                         (layer.multihead_attn.out_proj.weight, wco.t()),
                         (layer.multihead_attn.out_proj.bias, bco),
                         (layer.norm3.weight, g3), (layer.norm3.bias, be3),
                         (layer.linear1.weight, w1.t()), (layer.linear1.bias, b1),
                         (layer.linear2.weight, w2.t()), (layer.linear2.bias, b2)):
            dst.copy_(src)
    return layer.eval()


def library_ms(name, label, library_fn, ref) -> float:
    """The CUDA-event time of one library call; its output must agree with
    the plain version's ``ref`` within LIBRARY_TOL of the scale (a check that
    the layer was built from the same weights, not a tolerance of the port)."""
    with torch.no_grad():
        got = library_fn().float()
        err, scale = (got - ref.float()).abs().max().item(), ref.float().abs().max().item()
        ms = median_ms(library_fn)
    log(f"  {name} {label}: torch.nn library call {ms:.3f} ms, |library - plain| {err:.4e} "
        f"(max|plain| {scale:.4e}, tol {LIBRARY_TOL} x max|plain|)")
    if not err <= LIBRARY_TOL * scale:
        raise AssertionError(f"{name}: the torch.nn layers built for library_ms do not compute "
                             "the same function")
    return ms


def dec_zero(E: int) -> dict:
    """The decoder layer's gradients that are zero in exact arithmetic: the
    key third of the self-attention's q|k|v bias, the cross-attention's key
    bias."""
    return {"bqkv": slice(E, 2 * E), "bck": slice(None)}


def _encoder_params(layer):
    """A torch.nn encoder layer's parameters in STACK_WEIGHTS order."""
    sa = layer.self_attn
    return [layer.norm1.weight, layer.norm1.bias, sa.in_proj_weight, sa.in_proj_bias,
            sa.out_proj.weight, sa.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
            layer.linear1.weight, layer.linear1.bias, layer.linear2.weight, layer.linear2.bias]


def encoder_grad_fn(w, num_heads: int, x, dy, activation="gelu", stacked=True):
    """One torch.autograd.grad through torch_encoder's layers (train mode,
    dropout 0) built from ``w`` (stacked (L, ...)), with respect to x and
    every parameter: a function returning [dx, *the 12 weight gradients in
    STACK_WEIGHTS order, stacked on L unless ``stacked`` is False (one
    layer), Dense kernels as (in, out)]."""
    mod = torch_encoder(w, num_heads, activation).train()
    layers = [mod] if w[0].shape[0] == 1 else list(mod.layers)
    params = [p for layer in layers for p in _encoder_params(layer)]
    x = x.detach().requires_grad_(True)

    def run():
        dx, *g = torch.autograd.grad(mod(x), [x, *params], dy)
        per = [g[12 * l:12 * (l + 1)] for l in range(len(layers))]
        # (out, in) weights back to the kernels' (in, out)
        grads = [torch.stack([p[i].t() if p[i].dim() == 2 else p[i] for p in per])
                 for i in range(12)]
        return [dx] + (grads if stacked else [g[0] for g in grads])

    return run


def decoder_grad_fn(w, num_heads: int, x, mem, dy):
    """One torch.autograd.grad through torch_decoder_layer (train mode,
    dropout 0) with respect to x, mem and every parameter: a function
    returning [dx, dmem, *the 22 weight gradients in WEIGHT_NAMES order]."""
    layer = torch_decoder_layer(w, num_heads).train()
    sa, ca = layer.self_attn, layer.multihead_attn
    params = [layer.norm1.weight, layer.norm1.bias, sa.in_proj_weight, sa.in_proj_bias,
              sa.out_proj.weight, sa.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
              ca.in_proj_weight, ca.in_proj_bias, ca.out_proj.weight, ca.out_proj.bias,
              layer.norm3.weight, layer.norm3.bias, layer.linear1.weight, layer.linear1.bias,
              layer.linear2.weight, layer.linear2.bias]
    x, mem = x.detach().requires_grad_(True), mem.detach().requires_grad_(True)

    def run():
        (dx, dmem, g1, be1, wqkv, bqkv, wso, bso, g2, be2, wc, bc, wco, bco, g3, be3, w1, b1, w2,
         b2) = torch.autograd.grad(layer(x, mem), [x, mem, *params], dy)
        wcq, wck, wcv = (t.t() for t in wc.chunk(3, 0))
        bcq, bck, bcv = bc.chunk(3)
        return [dx, dmem, g1, be1, wqkv.t(), bqkv, wso.t(), bso, g2, be2, wcq, bcq, wck, bck, wcv,
                bcv, wco.t(), bco, g3, be3, w1.t(), b1, w2.t(), b2]

    return run


def library_bwd_ms(name, label, grad_fn, ref, names, zero) -> float:
    """The CUDA-event time of ``grad_fn`` (one torch.autograd.grad through
    the torch.nn layer); each of its gradients must agree with the plain
    backward's (``ref``: the input gradient(s), then the weight gradients
    named ``names``) within LIBRARY_TOL of that gradient's scale, the parts
    in ``zero`` (zero in exact arithmetic) within LIBRARY_TOL of the layer's
    largest weight gradient: a check that the layer was built from the same
    weights."""
    got = grad_fn()
    n_in = len(ref) - len(names)
    top = max(r.float().abs().max().item() for r in ref[n_in:])
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        key = names[i - n_in] if i >= n_in else None
        err = (g - r).abs()
        if key in zero:
            worst = max(worst, err[..., zero[key]].max().item() / top)
            err[..., zero[key]] = 0
        worst = max(worst, err.max().item() / max(r.abs().max().item(), 1e-30))
    ms = median_ms(grad_fn)
    log(f"  {name} {label}: torch.nn autograd.grad {ms:.3f} ms, max |library - plain| / scale "
        f"{worst:.4e} (tol {LIBRARY_TOL})")
    if not worst <= LIBRARY_TOL:
        raise AssertionError(f"{name}: the torch.nn layers built for library_ms do not compute "
                             "the same gradients")
    return ms


def sdpa_bwd_ms(name, label, q, k, v, do, ref) -> float:
    """The CUDA-event time of one torch.autograd.grad through
    F.scaled_dot_product_attention's output with respect to q, k and v (the
    forward run once, outside the timed call: the backward alone, as the
    flash backward kernels compute it). Its gradients must agree with the
    plain backward's (``ref``: dq, dk, dv) within LIBRARY_TOL of each one's
    scale: a check that the call computes the same function, not a
    tolerance of the port."""
    from torch.nn import functional as F

    leaves = [x.detach().transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    dout = do.transpose(1, 2)
    run = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
    worst = 0.0
    for g, r in zip(run(), ref):
        g, r = g.transpose(1, 2).float(), r.float()
        worst = max(worst, (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30))
    ms = median_ms(run)
    log(f"  {name} {label}: SDPA autograd.grad {ms:.3f} ms, max |library - plain| / scale "
        f"{worst:.4e} (tol {LIBRARY_TOL})")
    if not worst <= LIBRARY_TOL:
        raise AssertionError(f"{name}: scaled_dot_product_attention's gradients do not match the "
                             "plain backward")
    return ms


def attn_flops(tq, tk, e):  # scores and value sums over all heads
    return 4 * tq * tk * e


def enc_layer_flops(t, e, ff):  # pre-norm self-attention layer with an ff-wide MLP
    return 2 * t * e * 3 * e + attn_flops(t, t, e) + 2 * t * e * e + 4 * t * e * ff


def dec_layer_flops(p, s, e, ff):  # self-attention, cross-attention over s keys, MLP
    return 2 * p * e * 3 * e + attn_flops(p, p, e) + 6 * p * e * e + attn_flops(p, s, e) + 4 * p * e * ff


def decoder_pass_flops(cfg, s):  # one denoiser pass over s context keys + the step token
    p, j, e = cfg.trajectory_prediction_length, cfg.num_joints, cfg.hidden_dim
    return 4 * p * j * e + cfg.num_decoder_layers * dec_layer_flops(p, s + 1, e, e)


def median_ms(fn, reps=5, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel_fn, plain_fn, b, flops, inputs, library_fn=None):
    """Kernel vs plain version: the error, both CUDA-event times, the bound
    (``flops`` and the bytes of ``inputs`` and the kernel's output) and the
    time of ``library_fn``, one PyTorch call computing the same function."""
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    out_bytes = nbytes(got)  # the output as the kernel writes it (bf16 or fp32)
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name} B={b}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                             "or non-finite output")
    max_abs = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = max_abs <= TOL * scale
    k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
    bnd = bound(flops, nbytes(inputs) + out_bytes)
    log(f"{name} B={b}: max_abs_err={max_abs:.4e} max|plain|={scale:.4e} "
        f"(tol {TOL} x max|plain|) kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} B={b} disagrees with its plain version")
    lib = None if library_fn is None else library_ms(name, f"B={b}", library_fn, ref)
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, **bnd, "library_ms": lib}


def merge(results, name, r):
    """Keep the largest error over the batch sizes and the last (largest)
    batch's times and bound."""
    prev = results.get(name)
    results[name] = {**r, "max_abs_err": r["max_abs_err"] if prev is None
                     else max(prev["max_abs_err"], r["max_abs_err"])}


def decoder_checks(model, context, noise, device, b, suffix=""):
    """The chunk sampler (30-step DDIM), the denoiser's K/V pack and the
    denoiser (eps and in-kernel DDIM forms) against their plain versions on
    one context."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser

    cfg, S = model.config, context.shape[1]
    den, chunk = FusedDenoiser(model), FusedChunkSampler(model)
    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    table = model.step_encoding(torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64),
                                                device=device))[:, 0]
    stk, stv = chunk.step_tables(table)
    e, L = cfg.hidden_dim, cfg.num_decoder_layers
    chunk_flops = b * (2 * S * e * 2 * L * e + 30 * decoder_pass_flops(cfg, S))
    r_chunk = compare("fused_chunk" + suffix,
                      lambda: chunk.sample_kernel(context, noise, stk, stv, coefs),
                      lambda: chunk.sample_plain(context, noise, stk, stv, coefs), b, chunk_flops,
                      [chunk.kernel_weights, context, noise, stk, stv])
    context_kv = model.precompute_context_kv(context)
    # the pack: a permutation, bit for bit the plain pack's (max_abs_err 0)
    r_pack = compare("fused_denoise_pack" + suffix, lambda: den.pack_kernel(context_kv).kv,
                     lambda: den.pack_plain(context_kv).kv, b, 0, [context_kv])
    if r_pack["max_abs_err"] != 0:
        raise AssertionError(f"the pack kernel B={b} is not the plain pack")
    packed = den.pack_context_kv(context_kv)
    ddim = [1.3, 0.8, 0.9, 0.4]  # eps form and in-kernel DDIM form
    r_den = max((compare("fused_denoise" + suffix,
                         lambda c=c: den.run_kernel(packed, noise, stk[3], stv[3], c),
                         lambda c=c: den.run_plain(packed, noise, stk[3], stv[3], c), b,
                         b * decoder_pass_flops(cfg, S),
                         [den.kernel_weights, context_kv, noise, stk[3], stv[3]])
                 for c in (None, ddim)), key=lambda r: r["max_abs_err"])
    return r_chunk, r_den, r_pack


def kernel_phase(cfg, model, device):
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder

    enc = FusedContextEncoder(model)
    results = {}
    for b in (64, BENCH_B):
        rng = np.random.default_rng(b)
        batch = random_batch(cfg, b, device, rng)
        with torch.no_grad():
            e = cfg.hidden_dim
            flops = b * sum(2 * st.tokens * st.in_dim * e + st.layers * enc_layer_flops(st.tokens, e, e)
                            for st in enc.stacks)
            merge(results, "fused_encoder", compare(
                "fused_encoder", lambda: enc.encode_kernel(batch), lambda: enc.encode_plain(batch), b,
                flops, [list(batch.values()), [st.weights() for st in enc.stacks], enc.gs_table]))
            context = enc.encode_plain(batch)
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, b)
        merge(results, "fused_chunk", r_chunk)
        merge(results, "fused_denoise", r_den)
        merge(results, "fused_denoise_pack", r_pack)
    return results


def engine(model, cfg, device, **kw):
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference import RolloutEngine

    return RolloutEngine(model, make_schedule(1000), Normalizer.identity(cfg.num_joints),
                         num_inference_steps=30, fused_encoder=kw.pop("fused_encoder", True),
                         device=device, **kw)


def zero_counters():
    """Set every kernel wrapper's launch counter to 0."""
    from soccerdiffusion_tpu_torch.ops import fused_vit_block
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import FusedDecoderLayer
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import FusedEncoderStack
    from soccerdiffusion_tpu_torch.ops.flash_attention import FlashAttention

    for c in (FusedContextEncoder, FusedChunkSampler, FusedDenoiser):
        c.launches = 0
    FusedDenoiser.pack_launches = 0
    for c in (FusedEncoderStack, FusedDecoderLayer):
        c.fwd_launches = c.bwd_launches = c.fwd_launches_hd64 = c.bwd_launches_hd64 = 0
    fused_vit_block.forward_kernel.launches = fused_vit_block.backward_kernel.launches = 0
    FlashAttention.launches = FlashAttention.backward_launches = 0


def read_counters() -> dict:
    from soccerdiffusion_tpu_torch.ops import fused_vit_block
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import FusedDecoderLayer
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import FusedEncoderStack
    from soccerdiffusion_tpu_torch.ops.flash_attention import FlashAttention

    return {"fused_encoder": FusedContextEncoder.launches, "fused_chunk": FusedChunkSampler.launches,
            "fused_denoise": FusedDenoiser.launches,
            "fused_denoise_pack": FusedDenoiser.pack_launches,
            "fused_encoder_stack_fwd": FusedEncoderStack.fwd_launches,
            "fused_encoder_stack_fwd_hd64": FusedEncoderStack.fwd_launches_hd64,
            "fused_encoder_stack_bwd": FusedEncoderStack.bwd_launches,
            "fused_encoder_stack_bwd_hd64": FusedEncoderStack.bwd_launches_hd64,
            "fused_decoder_layer_fwd": FusedDecoderLayer.fwd_launches,
            "fused_decoder_layer_fwd_hd64": FusedDecoderLayer.fwd_launches_hd64,
            "fused_decoder_layer_bwd": FusedDecoderLayer.bwd_launches,
            "fused_decoder_layer_bwd_hd64": FusedDecoderLayer.bwd_launches_hd64,
            "fused_vit_block_fwd": fused_vit_block.forward_kernel.launches,
            "fused_vit_block_bwd": fused_vit_block.backward_kernel.launches,
            "flash_attention_fwd": FlashAttention.launches,
            "flash_attention_bwd": FlashAttention.backward_launches}


def no_flash(*launches):
    """The paths that run attention_impl="auto" (every path but the flash
    ones) stay under its threshold: no flash kernel may have run."""
    for got in launches:
        if got["flash_attention_fwd"] or got["flash_attention_bwd"]:
            raise AssertionError(f"a flash kernel ran on an \"auto\" path: {got}")


def timed_rollout(eng, device, seed, b=BENCH_B, periods=CHUNKS):
    """ms per replan period of a ``periods``-period rollout at B=b, and the
    launch counts of that rollout (zeroed just before, read just after)."""
    run = eng.make_rollout_fn(periods)
    carry = eng.init(b, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    _, chunks = run(carry)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / periods
    launches = read_counters()
    cfg = eng.cfg
    if (tuple(chunks.shape) != (periods, b, eng.replan_every, cfg.num_joints)
            or not torch.isfinite(chunks).all()):
        raise AssertionError(f"bad chunks: shape {tuple(chunks.shape)}, "
                             f"finite={bool(torch.isfinite(chunks).all())}")
    return ms, launches


def main_path_phase(cfg, model, device):
    ddim30 = engine(model, cfg, device, fused="chunk")
    distilled = engine(model, cfg, device, distilled=True, fused=True)
    per_step = engine(model, cfg, device, fused=True)
    plain = engine(model, cfg, device, fused=False, fused_encoder=False)
    for eng in (ddim30, distilled, per_step, plain):  # warm-up: allocator, first launches
        eng.make_rollout_fn(1)(eng.init(BENCH_B, torch.Generator(device=device).manual_seed(0)))
    ms_ddim, l_ddim = timed_rollout(ddim30, device, 1)
    ms_dist, l_dist = timed_rollout(distilled, device, 2)
    ms_step, l_step = timed_rollout(per_step, device, 3)
    names = ("fused_encoder", "fused_chunk", "fused_denoise", "fused_denoise_pack")
    launches = {name: l_ddim[name] + l_dist[name] + l_step[name] for name in names}
    log(f"main path B={BENCH_B}, {CHUNKS} periods each: ddim30 (fused encoder + chunk kernels) "
        f"{ms_ddim:.2f} ms/period; distilled1 (fused encoder + denoiser kernels) "
        f"{ms_dist:.2f} ms/period; ddim30 per-step (fused encoder + 30 denoiser launches) "
        f"{ms_step:.2f} ms/period; launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    want = {"fused_encoder": CHUNKS, "fused_chunk": 0, "fused_denoise": 30 * CHUNKS,
            "fused_denoise_pack": cfg.num_decoder_layers * CHUNKS}  # a pack launch a layer
    if {name: l_step[name] for name in names} != want:
        raise AssertionError(f"per-step ddim30 launches {l_step}, expected {want}")
    no_flash(l_ddim, l_dist, l_step)
    ms_plain, l_plain = timed_rollout(plain, device, 1)
    no_flash(l_plain)
    log(f"unfused plain-PyTorch rollout (fused=False, bf16) B={BENCH_B}: {ms_plain:.2f} ms/period")
    return launches, {"ddim30": ms_ddim, "distilled1": ms_dist, "ddim30_per_step": ms_step,
                      "ddim30_unfused": ms_plain}


def to_device(carry, device):
    """The rollout carry on another device, with a fresh generator there."""
    move = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None})
    return dataclasses.replace(carry, controller=move(carry.controller), plant=move(carry.plant),
                               generator=torch.Generator(device=device))


def reference_phase(cfg, model, device, b=8, **kw):
    """Closed-loop periods of the kernel path, each held against the same
    engine's plain versions on the CPU from the same state and noise (the
    untrained model's loop is chaotic, so the states are re-synchronised
    every period)."""
    rng = np.random.default_rng(5)
    kw = kw or dict(fused="chunk")
    gpu = engine(model, cfg, device, **kw)
    cpu = engine(copy.deepcopy(model).cpu(), cfg, "cpu", **kw)
    carry = gpu.init(b, torch.Generator(device=device).manual_seed(0))
    for period in range(2):
        noise = torch.from_numpy(rng.normal(size=(b, cfg.trajectory_prediction_length,
                                                  cfg.num_joints)).astype(np.float32))
        _, ref = cpu.replan_period(to_device(carry, "cpu"), noise)
        carry, got = gpu.replan_period(carry, noise)
        err, scale = (got.cpu() - ref).abs().max().item(), ref.abs().max().item()
        log(f"serving loop B={b} period {period}: kernels on {device} vs plain versions on cpu: "
            f"max_abs_err={err:.4e} max|plain|={scale:.4e} (tol {ROLLOUT_TOL} x max|plain|)")
        if not err <= ROLLOUT_TOL * scale:
            raise AssertionError("the kernel path disagrees with the plain path")


def err_line(name, got, ref, tol_scale=None):
    """max |got - ref| against TRAIN_TOL x tol_scale (default max|ref|)."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    tol_scale = scale if tol_scale is None else tol_scale
    ok = err <= TRAIN_TOL * tol_scale
    log(f"  {name}: max_abs_err={err:.4e} max|plain|={scale:.4e} tol={TRAIN_TOL * tol_scale:.4e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def grads_check(names, got, ref, zero):
    """Every weight gradient; those in ``zero`` (name -> last-axis slice,
    zero in exact arithmetic) against the layer's largest gradient."""
    top = max(r.float().abs().max().item() for r in ref)
    errs = []
    for name, g, r in zip(names, got, ref):
        if name in zero:
            cut = zero[name]
            errs.append(err_line(f" d{name}[exact zero part]", g[..., cut], r[..., cut], top))
            keep = torch.ones(g.shape[-1], dtype=torch.bool, device=g.device)
            keep[cut] = False
            g, r = g[..., keep], r[..., keep]
            if not g.numel():
                continue
        errs.append(err_line(f" d{name}", g, r))
    return max(errs)


def training_kernel_phase(cfg, model, device):
    """Kernels C / D (encoder stack fwd / bwd) on the action-history stack's
    weights and A / B (decoder layer fwd / bwd) on decoder layer 0's, at the
    training shapes, against their plain versions."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    H, E = 4, cfg.hidden_dim
    S = cfg.action_context_length + cfg.imu_context_length + cfg.joint_state_context_length + 2
    enc_w = [t.detach().to(torch.bfloat16) for t in
             fes.stack_weights(model.action_history_encoder.seq.encoder.layers)]
    dec_w = [t.detach().to(torch.bfloat16) for t in
             fdl.layer_weights(model.diffusion_action_generator.decoder.layers[0])]
    results = {}
    for b in TRAIN_BATCHES:
        rng = np.random.default_rng(100 + b)
        t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, torch.bfloat16)
        x, dy, xd, mem, dyd = t(b, 100, E), t(b, 100, E), t(b, 10, E), t(b, S, E), t(b, 10, E)
        log(f"encoder stack B={b} T=100 L=2 E={E}:")
        y, acts = fes.forward_kernel(x, enc_w, H)
        e_fwd = err_line("y", y, fes.forward_plain(x, enc_w, H))
        dx, grads = fes.backward_kernel(acts, dy, enc_w, H)
        dx_ref, grads_ref = fes.backward_plain(x, dy, enc_w, H)
        e_bwd = max(err_line("dx", dx, dx_ref),
                    grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(E, 2 * E)}))
        log(f"decoder layer B={b} T=10 S={S} E={E}:")
        e_dfwd = err_line("y", fdl.forward_kernel(xd, mem, dec_w, H), fdl.forward_plain(xd, mem, dec_w, H))
        ddx, dmem, dgrads = fdl.backward_kernel(xd, mem, dyd, dec_w, H)
        ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(xd, mem, dyd, dec_w, H)
        e_dbwd = max(err_line("dx", ddx, ddx_ref), err_line("dmem", dmem, dmem_ref),
                     grads_check(fdl.WEIGHT_NAMES, dgrads, dgrads_ref,
                                 {"bqkv": slice(E, 2 * E), "bck": slice(None)}))
        enc_lib, dec_lib = torch_encoder(enc_w, H), torch_decoder_layer(dec_w, H)
        enc_flops = b * 2 * enc_layer_flops(100, E, E)  # L=2
        dec_flops = b * (dec_layer_flops(10, S, E, E) + 4 * S * E * E)  # + memory K/V
        # backward: recompute the forward, then two products per forward product
        times = {
            "fused_encoder_stack_fwd": (e_fwd, lambda: fes.forward_kernel(x, enc_w, H),
                                        lambda: fes.forward_plain(x, enc_w, H),
                                        enc_flops, [x, enc_w, y, acts], lambda: enc_lib(x)),
            "fused_encoder_stack_bwd": (e_bwd, lambda: fes.backward_kernel(acts, dy, enc_w, H),
                                        lambda: fes.backward_plain(x, dy, enc_w, H),
                                        3 * enc_flops, [acts, dy, enc_w, dx, grads],
                                        LibraryGrad(encoder_grad_fn(enc_w, H, x, dy),
                                                    fes.STACK_WEIGHTS, {"bqkv": slice(E, 2 * E)})),
            "fused_decoder_layer_fwd": (e_dfwd, lambda: fdl.forward_kernel(xd, mem, dec_w, H),
                                        lambda: fdl.forward_plain(xd, mem, dec_w, H),
                                        dec_flops, [xd, mem, dec_w, xd], lambda: dec_lib(xd, mem)),
            "fused_decoder_layer_bwd": (e_dbwd, lambda: fdl.backward_kernel(xd, mem, dyd, dec_w, H),
                                        lambda: fdl.backward_plain(xd, mem, dyd, dec_w, H),
                                        3 * dec_flops, [xd, mem, dyd, dec_w, ddx, dmem, dgrads],
                                        LibraryGrad(decoder_grad_fn(dec_w, H, xd, mem, dyd),
                                                    fdl.WEIGHT_NAMES, dec_zero(E))),
        }
        time_checked(results, f"B={b}", times)
    return results


@dataclasses.dataclass(frozen=True)
class LibraryGrad:
    """A backward kernel's library call for time_checked: ``fn`` returns the
    torch.nn layer's input and weight gradients (encoder_grad_fn /
    decoder_grad_fn), ``names`` names the weight gradients and ``zero`` maps
    those that are zero in exact arithmetic to their slice."""
    fn: object
    names: tuple
    zero: dict


def time_checked(results, label, times):
    """Time each checked kernel beside its plain version (and its library
    call), with its bound: ``times`` maps a name to (max_abs_err, kernel_fn,
    plain_fn, flops, the tensors it reads and writes, library_fn, a
    LibraryGrad for a backward, or None); merged into ``results``."""
    for name, (err, kernel_fn, plain_fn, flops, io, lib_fn) in times.items():
        k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
        bnd = bound(flops, nbytes(io))
        log(f"{name} {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) (max_abs_err {err:.4e})")
        if isinstance(lib_fn, LibraryGrad):  # a backward: (dx[, dmem], grads) of the plain version
            *inputs, grads = plain_fn()
            lib = library_bwd_ms(name, label, lib_fn.fn, [*inputs, *grads], lib_fn.names,
                                 lib_fn.zero)
        else:
            lib = None if lib_fn is None else library_ms(name, label, lib_fn, plain_fn())
        merge(results, name, {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bnd,
                              "library_ms": lib})


def train_config(fused: bool, attention_impl: str = "auto"):
    from soccerdiffusion_tpu_torch.config import Config, TrainConfig

    model = dataclasses.replace(bench_config(), encoder_fused_stack=fused, decoder_fused_block=fused,
                                attention_impl=attention_impl)
    return Config(model=model, train=TrainConfig(batch_size=TRAIN_BATCH, lr=1e-4,
                                                 log_every=TRAIN_LOG_EVERY,
                                                 ema_decay=0.999))


def timed_training(config, tmp, label, packed=False):
    """training/train.py's loop on synthetic data for TRAIN_STEPS steps in two
    epochs. ms/step is the host clock from the second epoch's first logging
    window's end to the last window's end, over the steps between: each
    window ends in a device sync and the windows run back to back, so this
    times whole steps from one sync to another, past the epoch start (the
    prefetch thread's start) and the warm-up of the first epoch."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    metrics = f"{tmp}/metrics_{label}.jsonl"
    state = train(config, RunOptions(
        output=f"{tmp}/ckpt_{label}", dummy_data=True, packed=packed, epochs=2,
        steps_per_epoch=TRAIN_STEPS // 2, seed=0, metrics=metrics))
    torch.cuda.synchronize()
    records = [json.loads(line) for line in open(metrics)]
    losses = [r["loss"] for r in records]
    if state.step != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training ran {state.step} steps, logged losses {losses}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after training (a step's loss was not finite)")
    second = [r for r in records if r["epoch"] == 1]
    steps = [b["step"] - a["step"] for a, b in zip(second, second[1:])]
    seconds = [n / r["steps_per_sec"] for n, r in zip(steps, second[1:])]
    if sum(steps) < 2 * TRAIN_LOG_EVERY:
        raise AssertionError(f"too few timed steps: {steps}")
    return 1e3 * sum(seconds) / sum(steps), losses


def training_path_phase():
    with tempfile.TemporaryDirectory() as tmp:
        zero_counters()
        ms_fused, losses = timed_training(train_config(True), tmp, "fused")
        counts = read_counters()
        no_flash(counts)
        launches = {name: n for name, n in counts.items()
                    if name.startswith(("fused_encoder_stack", "fused_decoder_layer"))}
        log(f"training main path (train.py loop, synthetic data, bf16, B={TRAIN_BATCH}, "
            f"{TRAIN_STEPS} steps, fused knobs on): {ms_fused:.3f} ms/step, "
            f"{TRAIN_BATCH * 1e3 / ms_fused:.1f} samples/s; logged losses {losses}; launches {launches}")
        want = {"fused_encoder_stack_fwd": 3, "fused_encoder_stack_fwd_hd64": 0,
                "fused_encoder_stack_bwd": 3, "fused_encoder_stack_bwd_hd64": 0,
                "fused_decoder_layer_fwd": 4, "fused_decoder_layer_fwd_hd64": 0,
                "fused_decoder_layer_bwd": 4, "fused_decoder_layer_bwd_hd64": 0}
        for name, per_step in want.items():
            if launches[name] != per_step * TRAIN_STEPS:
                raise AssertionError(f"{name}: {launches[name]} launches on the training path, "
                                     f"expected {per_step} per step")
        zero_counters()
        ms_plain, _ = timed_training(train_config(False), tmp, "plain")
        no_flash(read_counters())
        log(f"unfused training step (knobs off, bf16 cuBLAS + torch ops), same loop: "
            f"{ms_plain:.3f} ms/step, {TRAIN_BATCH * 1e3 / ms_plain:.1f} samples/s")
        # the same unfused step with every attention through the flash kernel (head_dim 32)
        config = train_config(False, "pallas")
        zero_counters()
        ms_flash, _ = timed_training(config, tmp, "flash")
        flash = check_flash_launches("h128 unfused training, attention_impl=\"pallas\"",
                                     read_counters(), flash_per_pass(config.model) * TRAIN_STEPS,
                                     flash_per_pass(config.model) * TRAIN_STEPS)
        log(f"unfused training step with attention_impl=\"pallas\", same loop: {ms_flash:.3f} "
            f"ms/step, {TRAIN_BATCH * 1e3 / ms_flash:.1f} samples/s; launches {flash}")
    return launches, {"fused": ms_fused, "unfused": ms_plain, "unfused_pallas": ms_flash}, flash


def training_reference_phase(device, cfg, batches, seed):
    """The kernel path's training steps on the card against the same steps of
    the plain versions on the CPU, one per batch of ``batches`` (dicts of CPU
    tensors with the target ``joint_command``), from the same init, t and
    noise: the losses, the update norm and the BatchNorm running
    statistics."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    rng = np.random.default_rng(seed)
    base = DiffusionPolicy(cfg)
    base = load_jax_params(base, *flax_init_params(base, 3))
    runs = {}
    for dev in (device, "cpu"):
        model = copy.deepcopy(base).to(dev)
        opt = make_optimizer(model, 1e-3, 10, grad_clip_norm=1.0)
        runs[dev] = (model, create_train_state(model, opt),
                     make_train_step(model, make_schedule(1000), opt,
                                     Normalizer.identity(cfg.num_joints)), [])
    for batch in batches:
        target = batch["joint_command"]
        t = torch.from_numpy(rng.integers(0, 1000, (target.shape[0],)))
        noise = torch.from_numpy(rng.normal(size=tuple(target.shape)).astype(np.float32))
        for dev, (model, state, step, losses) in runs.items():
            on = lambda x: x.to(dev)
            metrics = step.apply(state, {k: on(v) for k, v in batch.items()}, on(t), on(noise))
            losses.append(metrics["loss"].item())
    (gm, _, _, gl), (cm, _, _, cl) = runs[device], runs["cpu"]
    ok = True
    for i, (lg, lc) in enumerate(zip(gl, cl)):
        rel = abs(lg - lc) / abs(lc)
        ok &= rel <= STEP_LOSS_TOL
        log(f"training step {i}: loss on {device} (kernels) {lg:.6f}, on cpu (plain versions) "
            f"{lc:.6f}, relative difference {rel:.3e} (tol {STEP_LOSS_TOL})")
    p0 = dict(base.named_parameters())
    num = den = max_diff = scale = 0.0
    for (name, pg), pc in zip(gm.named_parameters(), cm.parameters()):
        pg, pc = pg.detach().cpu(), pc.detach()
        num += ((pg - pc) ** 2).sum().item()
        den += ((pc - p0[name].detach()) ** 2).sum().item()
        max_diff, scale = max(max_diff, (pg - pc).abs().max().item()), max(scale, pc.abs().max().item())
    upd = (num / den) ** 0.5
    ok &= upd <= STEP_UPDATE_TOL
    log(f"after {len(batches)} steps: |params(card) - params(cpu)| / |update(cpu)| = {upd:.3e} "
        f"(tol {STEP_UPDATE_TOL}); max |param difference| / max|param| = {max_diff / scale:.3e}")
    # the BatchNorm running statistics (a model with a ResNet): each within TRAIN_TOL of scale
    cpu_buffers = dict(cm.named_buffers())
    worst = 0.0
    for name, bg in gm.named_buffers():
        if name.endswith((".mean", ".var")):
            bc = cpu_buffers[name]
            rel = (bg.cpu() - bc).abs().max().item() / max(bc.abs().max().item(), 1e-30)
            worst = max(worst, rel)
            ok &= rel <= TRAIN_TOL
    if any(n.endswith((".mean", ".var")) for n in cpu_buffers):
        log(f"after {len(batches)} steps: BatchNorm running statistics, card vs cpu: max "
            f"|difference| / max|cpu| = {worst:.3e} (tol {TRAIN_TOL})")
    if not ok:
        raise AssertionError("the kernel training path disagrees with the plain path")


def h128_reference_batches(b=8, steps=3):
    """Random h128 batches (CPU tensors) with their targets."""
    cfg, rng = train_config(True).model, np.random.default_rng(11)
    batches = []
    for _ in range(steps):
        batch = random_batch(cfg, b, "cpu", rng)
        target = rng.uniform(0, 2 * np.pi, (b, 10, 20)).astype(np.float32)
        batch["joint_command"] = torch.from_numpy(target)
        batches.append(batch)
    return batches


# ------------------------------------------------------- the flagship

def flagship_config():
    """vit_flagship.yaml's model (the port's copy of the JAX package's YAML)."""
    from soccerdiffusion_tpu_torch.config import Config

    return Config.from_yaml(str(FLAG_YAML)).model


def flagship_train_config(batch: int):
    """vit_flagship.yaml at ``batch`` robots, logging every TRAIN_LOG_EVERY steps."""
    from soccerdiffusion_tpu_torch.config import Config

    config = Config.from_yaml(str(FLAG_YAML))
    return dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=batch, log_every=TRAIN_LOG_EVERY))


def flagship_kernel_phase(model, device):
    """At B=64 and B=256 robots, against their plain versions: the fused ViT
    block (block 0's weights, 2 frames per robot of 64 tokens), the
    encoder-stack forward at head_dim 64 (the action-history stack) and at
    head_dim 32 (the image-frame stack: 10 tokens, 8 heads, 1 layer), and
    the head_dim-64 chunk sampler and denoiser (on the context of a random
    batch with cached image tokens); then the ViT block at the raw-frame
    lane's 10 frames per robot at B=FLAG_B. The ViT block and the stacks
    beside their torch.nn layers."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    vit = model.image_sequence_encoder.image_encoder
    T, W, H = (cfg.image_resolution // cfg.vit_patch_size) ** 2, cfg.vit_width, vit.num_heads
    gelu = cfg.vit_fused_gelu
    bf16 = lambda ts: [t.detach().to(torch.bfloat16) for t in ts]
    vit_w = bf16(fes.encoder_layer_weights(vit.blocks.layers[0]))
    vit_lib = torch_encoder([t[None] for t in vit_w], H, quick_gelu if gelu == "quick" else "gelu")
    stack_w = bf16(fes.stack_weights(model.action_history_encoder.seq.encoder.layers))
    seq_enc = model.image_sequence_encoder.seq.encoder
    seq_w, Hs = bf16(fes.stack_weights(seq_enc.layers)), seq_enc.num_heads
    stack_lib, seq_lib = torch_encoder(stack_w, 4), torch_encoder(seq_w, Hs)
    E, Ts, L = cfg.hidden_dim, cfg.action_context_length, cfg.num_action_history_encoder_layers
    Ti, Li = cfg.image_context_length, cfg.num_image_sequence_encoder_layers
    results = {}

    def vit_check(name, x, b):
        return compare(name, lambda: fvb.forward_kernel(x, vit_w, H, gelu),
                       lambda: fvb.forward_plain(x, vit_w, H, gelu), b,
                       x.shape[0] * enc_layer_flops(T, W, 4 * W), [x, vit_w], lambda: vit_lib(x))

    for b in FLAG_BATCHES:
        rng = np.random.default_rng(300 + b)
        t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, torch.bfloat16)
        x, xs, xi = t(2 * b, T, W), t(b, Ts, E), t(b, Ti, E)
        with torch.no_grad():
            merge(results, "fused_vit_block_fwd", vit_check("fused_vit_block_fwd", x, b))
            merge(results, "fused_encoder_stack_fwd_hd64", compare(
                "fused_encoder_stack_fwd_hd64", lambda: fes.forward_kernel(xs, stack_w, 4)[0],
                lambda: fes.forward_plain(xs, stack_w, 4), b,
                b * L * enc_layer_flops(Ts, E, E), [xs, stack_w], lambda: stack_lib(xs)))
            merge(results, "fused_encoder_stack_fwd_imgseq", compare(
                "fused_encoder_stack_fwd_imgseq", lambda: fes.forward_kernel(xi, seq_w, Hs)[0],
                lambda: fes.forward_plain(xi, seq_w, Hs), b,
                b * Li * enc_layer_flops(Ti, E, E), [xi, seq_w], lambda: seq_lib(xi)))
            batch = random_batch(cfg, b, device, rng)
            batch["image_tokens"] = t(b, cfg.image_context_length, E).float()
            context = model.encode_context(batch)
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, b, "_hd64")
        merge(results, "fused_chunk_hd64", r_chunk)
        merge(results, "fused_denoise_hd64", r_den)
        merge(results, "fused_denoise_pack_hd64", r_pack)
    rng = np.random.default_rng(400)
    x = torch.from_numpy(rng.normal(size=(10 * FLAG_B, T, W)).astype(np.float32)).to(
        device, torch.bfloat16)
    with torch.no_grad():
        results["fused_vit_block_fwd_raw_frames"] = vit_check("fused_vit_block_fwd_raw_frames",
                                                              x, FLAG_B)
    return results


# launches per replan period of each flagship lane: the 8 ViT blocks over the
# frames that arrived (cache) or all 10 per robot (raw); 3 proprioceptive
# stacks (head_dim 64) + the image-frame stack (8 heads, head_dim 32); the sampler
FLAG_LANES = {
    "ddim30": (dict(fused="chunk"), {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
                                     "fused_encoder_stack_fwd_hd64": 3, "fused_chunk": 1}),
    "ddim30_raw_frames": (dict(fused="chunk", cache_image_tokens=False),
                          {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
                           "fused_encoder_stack_fwd_hd64": 3, "fused_chunk": 1}),
    "distilled1": (dict(distilled=True, fused="chunk"),
                   {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
                    "fused_encoder_stack_fwd_hd64": 3, "fused_denoise": 1,
                    "fused_denoise_pack": 4}),  # the K/V pack: a launch per decoder layer
}


def flagship_path_phase(model, device):
    """The three serving lanes of the flagship at B=FLAG_B through
    RolloutEngine.make_rollout_fn, CHUNKS periods each, every launch counter
    zeroed just before each lane and read just after; each kernel of a lane
    must run exactly its count per period and no other kernel may run.
    Returns each lane's launches and ms per period."""
    cfg = model.config
    periods, launches = {}, {}
    for lane, (kw, per_period) in FLAG_LANES.items():
        eng = engine(model, cfg, device, fused_encoder=False, **kw)
        eng.make_rollout_fn(1)(eng.init(FLAG_B, torch.Generator(device=device).manual_seed(0)))
        ms, got = timed_rollout(eng, device, 1, FLAG_B, CHUNKS)
        want = {name: per_period.get(name, 0) * CHUNKS for name in got}
        log(f"flagship lane {lane} B={FLAG_B}, {CHUNKS} periods: {ms:.2f} ms/period, "
            f"{FLAG_B * 1e3 / ms:.1f} chunks/s; launches {got}")
        if got != want:
            raise AssertionError(f"flagship lane {lane}: launches {got}, expected {want}")
        periods[lane], launches[lane] = ms, got
    return launches, periods


def flagship_training_kernel_phase(model, device):
    """The flagship training step's kernels against their plain versions:
    the ViT block's backward (block 0's weights, quick GELU) at
    FLAG_VIT_FRAMES frames; at B=64 and B=256 robots the head_dim-64
    encoder-stack backward (the action-history stack, T=100, L=2), the
    image-frame stack's backward (head_dim 32, 8 heads, T=10, L=1) and the
    head_dim-64 decoder layer (layer 0) forward and backward over the
    training memory: the 311 context tokens and the step token. Every
    output, input gradient and weight gradient within TRAIN_TOL of scale."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    vit = model.image_sequence_encoder.image_encoder
    T, W, H = (cfg.image_resolution // cfg.vit_patch_size) ** 2, cfg.vit_width, vit.num_heads
    gelu, E = cfg.vit_fused_gelu, cfg.hidden_dim
    act = quick_gelu if gelu == "quick" else "gelu"
    bf16 = lambda ts: [t.detach().to(torch.bfloat16) for t in ts]
    vit_w = bf16(fes.encoder_layer_weights(vit.blocks.layers[0]))
    stack_w = bf16(fes.stack_weights(model.action_history_encoder.seq.encoder.layers))
    seq_enc = model.image_sequence_encoder.seq.encoder
    seq_w, Hs = bf16(fes.stack_weights(seq_enc.layers)), seq_enc.num_heads
    layer = model.diffusion_action_generator.decoder.layers[0]
    dec_w, Hd, FF = bf16(fdl.layer_weights(layer)), layer.num_heads, layer.mlp.linear1.out_features
    Ts, L = cfg.action_context_length, cfg.num_action_history_encoder_layers
    Ti, Li = cfg.image_context_length, cfg.num_image_sequence_encoder_layers
    S = Ts + cfg.imu_context_length + cfg.joint_state_context_length + Ti + 2
    dec_lib = torch_decoder_layer(dec_w, Hd)
    rng = np.random.default_rng(500)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)
    results = {}
    for n in FLAG_VIT_FRAMES:
        x, dy = t(n, T, W), t(n, T, W)
        log(f"fused ViT block backward N={n} frames T={T} W={W} ({gelu} GELU):")
        dx, grads = fvb.backward_kernel(x, dy, vit_w, H, gelu)
        dx_ref, grads_ref = fvb.backward_plain(x, dy, vit_w, H, gelu)
        err = max(err_line("dx", dx, dx_ref),
                  grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(W, 2 * W)}))
        # backward: recompute the forward, then two products per forward product
        time_checked(results, f"N={n} frames", {"fused_vit_block_bwd": (
            err, lambda: fvb.backward_kernel(x, dy, vit_w, H, gelu),
            lambda: fvb.backward_plain(x, dy, vit_w, H, gelu),
            3 * n * enc_layer_flops(T, W, 4 * W), [x, dy, vit_w, dx, grads],
            LibraryGrad(encoder_grad_fn([t[None] for t in vit_w], H, x, dy, act, stacked=False),
                        fes.STACK_WEIGHTS, {"bqkv": slice(W, 2 * W)}))})
    for b in FLAG_BATCHES:
        xs, dys, xi, dyi = t(b, Ts, E), t(b, Ts, E), t(b, Ti, E), t(b, Ti, E)
        xd, mem, dyd = t(b, 10, E), t(b, S, E), t(b, 10, E)
        times = {}
        for name, x, dy, w, heads, layers in (
                ("fused_encoder_stack_bwd_hd64", xs, dys, stack_w, 4, L),
                ("fused_encoder_stack_bwd_imgseq", xi, dyi, seq_w, Hs, Li)):
            log(f"{name} B={b} T={x.shape[1]} L={layers} {heads} heads:")
            _, acts = fes.forward_kernel(x, w, heads)
            dx, grads = fes.backward_kernel(acts, dy, w, heads)
            dx_ref, grads_ref = fes.backward_plain(x, dy, w, heads)
            err = max(err_line("dx", dx, dx_ref),
                      grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(E, 2 * E)}))
            times[name] = (err,
                           lambda a=acts, dy=dy, w=w, h=heads: fes.backward_kernel(a, dy, w, h),
                           lambda x=x, dy=dy, w=w, h=heads: fes.backward_plain(x, dy, w, h),
                           3 * b * layers * enc_layer_flops(x.shape[1], E, E),
                           [acts, dy, w, dx, grads],
                           LibraryGrad(encoder_grad_fn(w, heads, x, dy), fes.STACK_WEIGHTS,
                                       {"bqkv": slice(E, 2 * E)}))
        log(f"decoder layer B={b} T=10 S={S} E={E} {Hd} heads:")
        y = fdl.forward_kernel(xd, mem, dec_w, Hd)
        e_fwd = err_line("y", y, fdl.forward_plain(xd, mem, dec_w, Hd))
        ddx, dmem, dgrads = fdl.backward_kernel(xd, mem, dyd, dec_w, Hd)
        ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(xd, mem, dyd, dec_w, Hd)
        e_bwd = max(err_line("dx", ddx, ddx_ref), err_line("dmem", dmem, dmem_ref),
                    grads_check(fdl.WEIGHT_NAMES, dgrads, dgrads_ref,
                                {"bqkv": slice(E, 2 * E), "bck": slice(None)}))
        dec_flops = b * (dec_layer_flops(10, S, E, FF) + 4 * S * E * E)  # + memory K/V
        times["fused_decoder_layer_fwd_hd64"] = (
            e_fwd, lambda: fdl.forward_kernel(xd, mem, dec_w, Hd),
            lambda: fdl.forward_plain(xd, mem, dec_w, Hd), dec_flops, [xd, mem, dec_w, y],
            lambda: dec_lib(xd, mem))
        times["fused_decoder_layer_bwd_hd64"] = (
            e_bwd, lambda: fdl.backward_kernel(xd, mem, dyd, dec_w, Hd),
            lambda: fdl.backward_plain(xd, mem, dyd, dec_w, Hd), 3 * dec_flops,
            [xd, mem, dyd, dec_w, ddx, dmem, dgrads],
            LibraryGrad(decoder_grad_fn(dec_w, Hd, xd, mem, dyd), fdl.WEIGHT_NAMES, dec_zero(E)))
        time_checked(results, f"B={b}", times)
    return results


def flagship_training_path_phase():
    """training/train.py on vit_flagship.yaml with packed dummy data: TRAIN_STEPS
    steps at FLAG_TRAIN_B with every launch counter zeroed just before and
    read just after (each kernel exactly its FLAG_TRAIN_LAUNCHES per step, no
    other kernel), then 3 steps at the YAML's FLAG_TRAIN_FULL_B: the last
    step's host time between device syncs and the peak device memory.
    Returns the launches, ms per step at both batches and the peak bytes."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        ms, losses = timed_training(flagship_train_config(FLAG_TRAIN_B), tmp, "flagship",
                                    packed=True)
        launches = read_counters()
        want = {name: FLAG_TRAIN_LAUNCHES.get(name, 0) * TRAIN_STEPS for name in launches}
        log(f"flagship training main path (train.py, vit_flagship.yaml, --packed dummy data, "
            f"B={FLAG_TRAIN_B}, {TRAIN_STEPS} steps): {ms:.3f} ms/step, "
            f"{FLAG_TRAIN_B * 1e3 / ms:.1f} samples/s; logged losses {losses}; launches {launches}")
        if launches != want:
            raise AssertionError(f"flagship training: launches {launches}, expected {want}")
        config = flagship_train_config(FLAG_TRAIN_FULL_B)
        config = dataclasses.replace(config, train=dataclasses.replace(config.train, log_every=1))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        metrics = f"{tmp}/metrics_full.jsonl"
        state = train(config, RunOptions(output=f"{tmp}/ckpt_full", dummy_data=True, packed=True,
                                         epochs=1, steps_per_epoch=3, seed=1, metrics=metrics))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        last = [json.loads(line) for line in open(metrics)][-1]
        ms_full = 1e3 / last["steps_per_sec"]
        if state.step != 3 or not np.isfinite(last["loss"]):
            raise AssertionError(f"B={FLAG_TRAIN_FULL_B}: {state.step} steps, "
                                 f"last loss {last['loss']}")
        log(f"flagship training at the YAML's B={FLAG_TRAIN_FULL_B}, 3 steps: the last "
            f"{ms_full:.3f} ms, {FLAG_TRAIN_FULL_B * 1e3 / ms_full:.1f} samples/s, loss "
            f"{last['loss']:.6f}; peak device memory {peak / 2**30:.2f} GiB")
    return launches, {f"B{FLAG_TRAIN_B}": ms, f"B{FLAG_TRAIN_FULL_B}": ms_full}, peak


def flagship_reference_batches(b=2, steps=3):
    """The first shuffled packed batches of the flagship's dummy data at B=b."""
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    dataset = build_dataset(flagship_train_config(b), 0, True, packed=True)
    return [to_tensors(batch) for batch in itertools.islice(dataset.batches(b, seed=0), steps)]


# ------------------------------------------------------- flash attention

def flash_flagship_config():
    """vit_flagship.yaml's model with every attention through the flash
    kernel: attention_impl="pallas" and the three fused knobs off."""
    return dataclasses.replace(flagship_config(), attention_impl="pallas", vit_fused_block=False,
                               encoder_fused_stack=False, decoder_fused_block=False)


def flash_train_config(batch: int):
    return dataclasses.replace(flagship_train_config(batch), model=flash_flagship_config())


def flash_per_pass(cfg) -> int:
    """Attention calls of one forward of ``cfg``'s model with every layer
    unfused: the proprioceptive stacks' layers, the ViT blocks and the
    image-frame stack's layers, each decoder layer's self- and
    cross-attention."""
    n = (cfg.num_action_history_encoder_layers + cfg.num_imu_encoder_layers
         + cfg.joint_state_encoder_layers + 2 * cfg.num_decoder_layers)
    if cfg.use_images:
        n += cfg.vit_depth + cfg.num_image_sequence_encoder_layers
    return n


def check_flash_launches(label, got, fwd, bwd) -> dict:
    """Exactly ``fwd`` / ``bwd`` flash launches and no other kernel's."""
    want = {name: 0 for name in got}
    want.update(flash_attention_fwd=fwd, flash_attention_bwd=bwd)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def flash_kernel_phase(device):
    """The flash kernel's forward (o) and backward (dq, dk, dv) against the
    plain versions on the same inputs (the backward on the plain forward's
    o and log-sum-exp) at every FLASH_SHAPES entry in fp32 and bf16, with
    CUDA-event times of both, of F.scaled_dot_product_attention's forward
    and of one autograd.grad through it on the same inputs, and the bound
    (bf16: the tensor-core peak; fp32: the fp32 peak). Returns the JSON entries (errors: the largest over every
    check; times: the first shape's in bf16) and every shape's numbers."""
    from torch.nn import functional as F

    from soccerdiffusion_tpu_torch.ops import flash_attention as fa

    shapes = {}
    for dtype in (torch.float32, torch.bfloat16):
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        for label, (B, Tq, Tk, H, D) in FLASH_SHAPES.items():
            rng = np.random.default_rng(len(shapes))
            t = lambda T: torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32)).to(
                device, dtype)
            q, k, v, do = t(Tq), t(Tk), t(Tk), t(Tq)
            name = f"{label} {str(dtype).removeprefix('torch.')}"
            log(f"flash attention {name} (B={B}, Tq={Tq}, Tk={Tk}, H={H}, D={D}):")
            o, lse = fa.forward_kernel(q, k, v)
            o_ref, lse_ref = fa.plain_forward(q, k, v)
            grads = fa.backward_kernel(q, k, v, o_ref, lse_ref, do)
            grads_ref = fa.plain_backward(q, k, v, o_ref, lse_ref, do)
            torch.cuda.synchronize()
            e_fwd = err_line("o", o, o_ref)  # TRAIN_TOL = TOL x max|plain|
            e_bwd = max(err_line(f"d{n}", g, r) for n, g, r in zip("qkv", grads, grads_ref))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, D) views
            lib = library_ms("flash_attention_fwd", name,
                             lambda: F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2),
                             o_ref)
            lib_bwd = sdpa_bwd_ms("flash_attention_bwd", name, q, k, v, do, grads_ref)
            flops = 4 * B * H * Tq * Tk * D
            row = {}
            for key, err, kernel_fn, plain_fn, fl, io, lib_ms in (
                    ("fwd", e_fwd, lambda: fa.forward_kernel(q, k, v),
                     lambda: fa.plain_forward(q, k, v), flops, [q, k, v, o, lse], lib),
                    ("bwd", e_bwd, lambda: fa.backward_kernel(q, k, v, o_ref, lse_ref, do),
                     lambda: fa.plain_backward(q, k, v, o_ref, lse_ref, do), 3 * flops,
                     [q, k, v, o_ref, lse_ref, do, grads], lib_bwd)):
                k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
                bnd = bound(fl, nbytes(io), peak)
                log(f"  {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
                    f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                row[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bnd,
                            "library_ms": lib_ms}
            shapes[name] = row
    first = f"{next(iter(FLASH_SHAPES))} bfloat16"
    results = {f"flash_attention_{key}": {
        **shapes[first][key], "max_abs_err": max(r[key]["max_abs_err"] for r in shapes.values())}
        for key in ("fwd", "bwd")}
    return results, shapes


def flash_serving_phase(model, device):
    """The flash flagship's cached 30-step DDIM lane at B=FLAG_B through
    RolloutEngine(fused=False), CHUNKS periods with every counter zeroed
    before and read after (exactly the model's attention calls per period
    on the flash kernel, no other kernel), then 2 periods on the card
    against the same engine on the CPU."""
    cfg = model.config
    eng = engine(model, cfg, device, fused=False, fused_encoder=False)
    eng.make_rollout_fn(1)(eng.init(FLAG_B, torch.Generator(device=device).manual_seed(0)))
    ms, got = timed_rollout(eng, device, 1, FLAG_B, CHUNKS)
    # encoders once per period (the ViT on the arrived frames), the decoder at every step
    per_period = flash_per_pass(cfg) + (eng.num_inference_steps - 1) * 2 * cfg.num_decoder_layers
    launches = check_flash_launches("flash flagship serving", got, per_period * CHUNKS, 0)
    log(f"flash flagship lane ddim30 (attention_impl=\"pallas\", fused=False) B={FLAG_B}, "
        f"{CHUNKS} periods: {ms:.2f} ms/period, {FLAG_B * 1e3 / ms:.1f} chunks/s; {per_period} "
        f"flash launches per period")
    reference_phase(cfg, model, device, b=4, fused=False, fused_encoder=False)
    return launches, ms


def flash_training_path_phase():
    """training/train.py on the flash flagship with packed dummy data:
    TRAIN_STEPS steps at FLAG_TRAIN_B, every counter zeroed before and read
    after (exactly flash_per_pass forward and backward launches per step,
    no other kernel). Returns the launches and ms per step."""
    config = flash_train_config(FLAG_TRAIN_B)
    per_step = flash_per_pass(config.model)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        ms, losses = timed_training(config, tmp, "flash_flagship", packed=True)
        launches = check_flash_launches("flash flagship training", read_counters(),
                                        per_step * TRAIN_STEPS, per_step * TRAIN_STEPS)
    log(f"flash flagship training (train.py, attention_impl=\"pallas\", fused knobs off, --packed "
        f"dummy data, B={FLAG_TRAIN_B}, {TRAIN_STEPS} steps): {ms:.3f} ms/step, "
        f"{FLAG_TRAIN_B * 1e3 / ms:.1f} samples/s; logged losses {losses}; {per_step} flash "
        f"launches per step, forward and backward")
    return launches, ms


# ------------------------------------------------------- the ResNet / Swin slice

CONFIG_DIR = Path(__file__).resolve().parent / "soccerdiffusion_tpu_torch" / "training" / "configs"
# the ResNet serving lanes at RESNET_B robots: the chunk sampler or the
# distilled denoiser and its K/V pack (a launch per decoder layer), no
# fused encoder (an image config takes the model's context encoder), no
# ViT block and no fused stack (default_tpu.yaml's knobs are off)
RESNET_B, RESNET_FRAMES = 64, (128, 640)
RESNET_LANES = {
    "ddim30": (dict(fused="chunk"), {"fused_chunk": 1}),
    "ddim30_raw_frames": (dict(fused="chunk", cache_image_tokens=False), {"fused_chunk": 1}),
    "distilled1": (dict(distilled=True, fused=True), {"fused_denoise": 1,
                                                      "fused_denoise_pack": 4}),
}
RESNET_TRAIN_B, RESNET_TRAIN_FULL_B = 64, 128
# ResNet50 / Swin-T forwards on the card against the CPU in float32 (TF32 off):
# cuDNN's and the CPU's convolution algorithms sum in other orders
ENCODER_F32_TOL = 1e-3
# the decoder-only tier's checks (S=0 context tokens) and lanes
DECODER_ONLY_BATCHES, DECODER_ONLY_B = (64, 256), 64


def yaml_config(name: str, **train):
    """The port's copy of training/configs/<name>.yaml, its train section's
    fields replaced by ``train``."""
    from soccerdiffusion_tpu_torch.config import Config

    config = Config.from_yaml(str(CONFIG_DIR / name))
    return dataclasses.replace(config, train=dataclasses.replace(config.train, **train))


def forward_flops(module, x) -> int:
    """Multiply-add FLOPs (2 per MAC) of the convolutions and dense layers of
    one forward of ``module`` on ``x``, counted from their shapes by hooks."""
    total = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def image_encoder_phase(model, device) -> dict:
    """The per-frame image encoder of ``model`` (eval mode, bf16, no grad)
    timed with CUDA events over RESNET_FRAMES frames, with its convolution
    and dense FLOPs per ms against the bf16 tensor-core peak."""
    enc = model.image_sequence_encoder.image_encoder
    res = model.config.image_resolution
    rng = np.random.default_rng(600)
    out = {}
    with torch.no_grad():
        for n in RESNET_FRAMES:
            x = torch.from_numpy(rng.normal(size=(n, res, res, 3)).astype(np.float32)).to(
                device, torch.bfloat16)
            flops = forward_flops(enc, x)
            ms = median_ms(lambda: enc(x))
            rate = flops / (ms * 1e-3)
            log(f"{model.config.image_encoder_type} per-frame encoder, {n} frames at {res} px "
                f"(bf16, eval): {ms:.3f} ms, {flops / n / 1e9:.3f} GFLOP a frame, "
                f"{rate / 1e12:.1f} TFLOP/s = {rate / BF16_FLOPS:.3f} of 989 TFLOP/s")
            out[f"N{n}"] = {"ms": ms, "gflop": flops / 1e9, "tflops": rate / 1e12,
                            "share_of_bf16_peak": rate / BF16_FLOPS}
    return out


def resnet_kernel_phase(model, device) -> dict:
    """The decoder kernels at the ResNet lanes' shape (head_dim 32, S=311
    context tokens: 300 proprioceptive, 10 image tokens, the game state)
    against their plain versions at RESNET_B robots, on the context of a
    random batch with cached image tokens."""
    cfg = model.config
    rng = np.random.default_rng(900)
    with torch.no_grad():
        batch = random_batch(cfg, RESNET_B, device, rng)
        batch["image_tokens"] = torch.from_numpy(rng.normal(
            size=(RESNET_B, cfg.image_context_length, cfg.hidden_dim)).astype(np.float32)).to(device)
        context = model.encode_context(batch)
        noise = torch.from_numpy(rng.normal(size=(RESNET_B, 10, 20)).astype(np.float32)).to(device)
        r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, RESNET_B,
                                                "_resnet")
    return {"fused_chunk_resnet": r_chunk, "fused_denoise_resnet": r_den,
            "fused_denoise_pack_resnet": r_pack}


def lanes_phase(model, device, lanes, b, label) -> tuple[dict, dict]:
    """Each lane of ``lanes`` at B=b through RolloutEngine.make_rollout_fn,
    CHUNKS periods, every counter zeroed just before and read just after;
    each kernel exactly its count per period, no other kernel."""
    cfg = model.config
    periods, launches = {}, {}
    for lane, (kw, per_period) in lanes.items():
        eng = engine(model, cfg, device, fused_encoder=False, **kw)
        eng.make_rollout_fn(1)(eng.init(b, torch.Generator(device=device).manual_seed(0)))
        ms, got = timed_rollout(eng, device, 1, b, CHUNKS)
        want = {name: per_period.get(name, 0) * CHUNKS for name in got}
        log(f"{label} lane {lane} B={b}, {CHUNKS} periods: {ms:.2f} ms/period, "
            f"{b * 1e3 / ms:.1f} chunks/s; launches {got}")
        if got != want:
            raise AssertionError(f"{label} lane {lane}: launches {got}, expected {want}")
        periods[lane], launches[lane] = ms, got
    return launches, periods


def peak_training(config, tmp, label) -> tuple[float, int]:
    """3 steps of training/train.py (packed dummy data, a sync each step): the
    last step's ms and the peak device memory."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    config = dataclasses.replace(config, train=dataclasses.replace(config.train, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = f"{tmp}/metrics_{label}.jsonl"
    state = train(config, RunOptions(output=f"{tmp}/ckpt_{label}", dummy_data=True, packed=True,
                                     epochs=1, steps_per_epoch=3, seed=1, metrics=metrics))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    last = [json.loads(line) for line in open(metrics)][-1]
    if state.step != 3 or not np.isfinite(last["loss"]):
        raise AssertionError(f"{label}: {state.step} steps, last loss {last['loss']}")
    ms = 1e3 / last["steps_per_sec"]
    log(f"{label}, 3 steps: the last {ms:.3f} ms, "
        f"{config.train.batch_size * 1e3 / ms:.1f} samples/s, loss {last['loss']:.6f}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    return ms, peak


def resnet_training_phase() -> dict:
    """training/train.py on default_tpu.yaml (ResNet18 at 224 px, bf16,
    remat_image_encoder "conv_only") with packed whole-frame uint8 dummy
    data: TRAIN_STEPS steps at RESNET_TRAIN_B with every counter zeroed
    before and read after (no kernel of the port runs: the ResNet is
    cuDNN's, the layers are unfused), then 3 steps at the YAML's own
    RESNET_TRAIN_FULL_B with "conv_only" and with remat off: the last
    step's ms and the peak device memory of each."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        config = yaml_config("default_tpu.yaml", batch_size=RESNET_TRAIN_B,
                             log_every=TRAIN_LOG_EVERY)
        ms, losses = timed_training(config, tmp, "resnet", packed=True)
        launches = read_counters()
        log(f"ResNet training main path (train.py, default_tpu.yaml, --packed whole-frame uint8 "
            f"dummy data, B={RESNET_TRAIN_B}, {TRAIN_STEPS} steps): {ms:.3f} ms/step, "
            f"{RESNET_TRAIN_B * 1e3 / ms:.1f} samples/s; logged losses {losses}; launches "
            f"{launches}")
        if any(launches.values()):
            raise AssertionError(f"a kernel of the port ran on the ResNet training path: {launches}")
        out[f"B{RESNET_TRAIN_B}"] = ms
        for remat in ("conv_only", False):
            config = yaml_config("default_tpu.yaml", batch_size=RESNET_TRAIN_FULL_B)
            config = dataclasses.replace(config, model=dataclasses.replace(
                config.model, remat_image_encoder=remat))
            label = f"B{RESNET_TRAIN_FULL_B}_remat_{remat or 'off'}"
            ms, peak = peak_training(config, tmp, f"default_tpu.yaml {label}")
            out[label] = {"ms": ms, "peak_bytes": peak}
    return out


def reference_batches(config, b=2, steps=3):
    """The first shuffled packed batches of ``config``'s dummy data at B=b."""
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    dataset = build_dataset(config, 0, True, packed=True)
    return [to_tensors(batch) for batch in itertools.islice(dataset.batches(b, seed=0), steps)]


def encoders_reference_phase(device) -> dict:
    """ResNet50 and Swin-T per-frame forwards at 224 px (seeded random
    params and BatchNorm statistics, eval mode): float32 on the card
    against the CPU on 4 frames (ENCODER_F32_TOL of scale; TF32 off), and
    the bf16 forward timed over 128 frames on the card."""
    from soccerdiffusion_tpu_torch.models.vision import make_image_encoder
    from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

    out = {}
    for kind in ("resnet50", "swin_transformer_tiny"):
        cpu = make_image_encoder(kind, 128, 224, use_final_avgpool=False)
        load_jax_params(cpu, *random_jax_params(cpu, seed=7))
        cpu.eval()
        gpu = copy.deepcopy(cpu).to(device)
        rng = np.random.default_rng(700)
        x = torch.from_numpy(rng.normal(size=(4, 224, 224, 3)).astype(np.float32))
        with torch.no_grad():
            ref = cpu(x)
            got = gpu(x.to(device)).cpu()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        log(f"{kind} forward, 4 frames at 224 px, float32: card vs cpu max_abs_err={err:.4e} "
            f"max|cpu|={scale:.4e} (tol {ENCODER_F32_TOL} x max|cpu|)")
        if not (torch.isfinite(got).all() and err <= ENCODER_F32_TOL * scale):
            raise AssertionError(f"{kind}: the card's forward disagrees with the CPU's")
        bf = make_image_encoder(kind, 128, 224, use_final_avgpool=False, dtype=torch.bfloat16)
        bf.load_state_dict(cpu.state_dict())
        bf = bf.to(device).eval()
        x = torch.from_numpy(rng.normal(size=(128, 224, 224, 3)).astype(np.float32)).to(
            device, torch.bfloat16)
        flops = forward_flops(bf, x)
        with torch.no_grad():
            ms = median_ms(lambda: bf(x))
        rate = flops / (ms * 1e-3)
        log(f"{kind} per-frame encoder, 128 frames (bf16, eval): {ms:.3f} ms, "
            f"{flops / 128 / 1e9:.3f} GFLOP a frame, {rate / 1e12:.1f} TFLOP/s = "
            f"{rate / BF16_FLOPS:.3f} of 989 TFLOP/s")
        out[kind] = {"max_abs_err_f32": err, "ms_128_frames_bf16": ms,
                     "share_of_bf16_peak": rate / BF16_FLOPS}
    return out


def decoder_only_phase(device) -> tuple[dict, dict, dict, float]:
    """decoder_only.yaml's model (h256, 4 heads of 64, every context
    modality off; bf16): the chunk sampler, the K/V pack and the denoiser
    against their plain versions at S=0 context tokens (only the step
    token's key) at DECODER_ONLY_BATCHES robots; its serving lanes (the
    chunk sampler, the distilled denoiser) at DECODER_ONLY_B with exact
    launches per period; then TRAIN_STEPS training steps through
    training/train.py at TRAIN_BATCH."""
    cfg = dataclasses.replace(yaml_config("decoder_only.yaml").model, compute_dtype="bfloat16")
    model = build_model(cfg, device, seed=8)
    results = {}
    for b in DECODER_ONLY_BATCHES:
        rng = np.random.default_rng(800 + b)
        with torch.no_grad():
            context = model.encode_context({"joint_command": torch.zeros((b, 0, 0),
                                                                         device=device)})
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, b, "_s0")
        merge(results, "fused_chunk_s0", r_chunk)
        merge(results, "fused_denoise_s0", r_den)
        merge(results, "fused_denoise_pack_s0", r_pack)
    lanes = {"ddim30": RESNET_LANES["ddim30"], "distilled1": RESNET_LANES["distilled1"]}
    launches, periods = lanes_phase(model, device, lanes, DECODER_ONLY_B, "decoder-only")
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(yaml_config("decoder_only.yaml", batch_size=TRAIN_BATCH,
                                                 log_every=TRAIN_LOG_EVERY), model=cfg)
        zero_counters()
        ms, losses = timed_training(config, tmp, "decoder_only")
        no_flash(read_counters())
    log(f"decoder-only training (train.py, decoder_only.yaml in bf16, synthetic data, "
        f"B={TRAIN_BATCH}, {TRAIN_STEPS} steps): {ms:.3f} ms/step; logged losses {losses}")
    return results, launches, periods, ms


def sass_phase() -> dict:
    """cuobjdump -sass of the built kernel library: every instance of each
    TENSOR_CORE_KERNELS kernel (bf16 only where it says so) must hold
    tensor-core instructions; the fp32 flash instances, which stay scalar,
    are logged. Returns per kernel its instances and the fewest HMMA / HGMMA
    instructions of one."""
    from soccerdiffusion_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise AssertionError("cuobjdump not found: the tensor-core check needs the CUDA toolkit's")
    lib = _build.build_dir() / "libsd_kernels.so"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        counts[chunk.split(None, 1)[0]] = len(re.findall(r"\bHG?MMA\b", chunk))
    found = {}
    for kernel, only in TENSOR_CORE_KERNELS:
        n = [c for fn, c in counts.items() if kernel in fn and only in fn]
        label = f"{kernel} ({only} instances)" if only else kernel
        log(f"SASS {label}: {len(n)} instance(s), HMMA/HGMMA instructions {n}")
        if not n or min(n) == 0:
            raise AssertionError(f"{label}: an instance without tensor-core instructions "
                                 f"(HMMA/HGMMA counts {n})")
        found[label] = {"instances": len(n), "min_mma_instructions": min(n)}
    for kernel in SCALAR_KERNELS:
        n = {fn: c for fn, c in counts.items() if kernel in fn and "__nv_bfloat16" not in fn}
        log(f"SASS {kernel} (float instances, scalar fp32): {len(n)} instance(s), HMMA/HGMMA "
            f"instructions {sorted(n.values())}")
    return found


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def trace(label, run, steps, out):
    """One torch.profiler trace of ``steps`` calls of ``run``: per call the
    host wall clock, the device busy time (union of the device ops'
    intervals) and idle share, both from this trace, and the largest device
    ops; the full table goes to ``out``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the trace holds no device ops: torch.profiler saw no device time")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3 / steps
    per_name: dict[str, list] = {}
    for e in dev:
        tot = per_name.setdefault(e.name, [0.0, 0])
        tot[0] += (e.time_range.end - e.time_range.start) / 1e3 / steps
        tot[1] += 1
    launch_ms = sum(e.self_cpu_time_total for e in prof.key_averages()
                    if e.key.startswith(("cudaLaunch", "cuLaunch"))) / 1e3 / steps
    log(f"=== {label}, {steps} under torch.profiler: wall {wall_ms:.3f} ms each, device busy "
        f"{busy_ms:.3f} ms ({len(dev) / steps:.0f} device ops each), device idle share "
        f"{1 - busy_ms / wall_ms:.3f}, host in kernel-launch calls {launch_ms:.3f} ms each")
    for op, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:8.3f} ms each {n / steps:6.1f} each  {op[:110]}")
    if out:
        with open(out, "a") as f:
            f.write(f"=== {label}\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
            f.write("\n")


def profile_serving(device, out, periods=3, flash=False, resnet=False):
    """A trace of ``periods`` replan periods of each flagship lane at
    B=FLAG_B, or (``flash``) of the flash flagship's cached ddim30 lane, or
    (``resnet``) of each default_tpu.yaml lane at RESNET_B."""
    if resnet:
        model = build_model(yaml_config("default_tpu.yaml").model, device, seed=4)
        lanes = {lane: kw for lane, (kw, _) in RESNET_LANES.items()}
    elif flash:
        model = build_model(flash_flagship_config(), device, seed=3)
        lanes = {"ddim30 flash (fused=False)": dict(fused=False)}
    else:
        model = build_model(flagship_config(), device, seed=3)
        lanes = {lane: kw for lane, (kw, _) in FLAG_LANES.items()}
    for lane, kw in lanes.items():
        b = RESNET_B if resnet else FLAG_B
        eng = engine(model, model.config, device, fused_encoder=False, **kw)
        carry = [eng.init(b, torch.Generator(device=device).manual_seed(0))]

        def period():
            carry[0] = eng.replan_period(carry[0])[0]

        period()  # warm-up
        trace(f"{'ResNet' if resnet else 'flagship'} lane {lane}, B={b}, replan periods", period,
              periods, out)


def profile_training(config, label, out, packed=False, steps=5, warm=5):
    """One torch.profiler trace of ``steps`` steps of training/train.py's step
    (its dataset and data path for ``config``) after ``warm`` steps outside
    it. Wall and device busy time both come from this trace."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.data.pipeline import prefetch_to_device
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.train import build_dataset
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    tc, device = config.train, torch.device("cuda")
    dataset = build_dataset(config, 0, True, packed)
    normalizer = Normalizer.fit(dataset.sample_targets(tc.num_normalization_samples, seed=0))
    model = DiffusionPolicy(config.model)
    model = load_jax_params(model, *flax_init_params(model, 0)).to(device)
    opt = make_optimizer(model, tc.lr, warm + steps, tc.weight_decay, grad_clip_norm=tc.grad_clip_norm)
    state = create_train_state(model, opt, ema=tc.ema_decay > 0.0)
    step = make_train_step(model, make_schedule(tc.train_denoising_timesteps), opt, normalizer,
                           ema_decay=tc.ema_decay)
    generator = torch.Generator(device=device).manual_seed(0)
    batches = prefetch_to_device(dataset.batches(tc.batch_size, shuffle=True, seed=0), device)
    try:
        for _ in range(warm):
            step(state, next(batches), generator)
        trace(f"training step {label}, B={tc.batch_size}, steps",
              lambda: step(state, next(batches), generator), steps, out)
    finally:
        batches.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-training", action="store_true",
                        help="trace the training step with torch.profiler instead of the smoke run")
    parser.add_argument("--flagship", action="store_true",
                        help="with --profile-training: trace the flagship's training step instead")
    parser.add_argument("--flash", action="store_true",
                        help="with --profile-training --flagship or --profile-serving: the "
                             "flash flagship (every attention through the flash kernel)")
    parser.add_argument("--profile-serving", action="store_true",
                        help="trace the flagship's serving lanes with torch.profiler instead")
    parser.add_argument("--resnet", action="store_true",
                        help="with --profile-training or --profile-serving: default_tpu.yaml's "
                             "ResNet18 model (training step at B=64, serving lanes at B=64)")
    parser.add_argument("--profile-out", default=None, help="file for the full profiler tables")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from soccerdiffusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s ({_build.build_dir()})")
    build_log = _build.build_dir() / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(line.strip(), file=sys.stderr)

    if args.profile_training or args.profile_serving:
        if args.profile_training and args.resnet:
            profile_training(yaml_config("default_tpu.yaml", batch_size=RESNET_TRAIN_B),
                             "ResNet (default_tpu.yaml, packed whole-frame uint8 dummy data)",
                             args.profile_out, packed=True)
        elif args.profile_training and args.flagship and args.flash:
            profile_training(flash_train_config(FLAG_TRAIN_B), "flash flagship (vit_flagship.yaml, "
                             "attention_impl=pallas, fused knobs off, packed dummy data)",
                             args.profile_out, packed=True)
        elif args.profile_training and args.flagship:
            profile_training(flagship_train_config(FLAG_TRAIN_B), "flagship (vit_flagship.yaml, "
                             "packed dummy data)", args.profile_out, packed=True)
        elif args.profile_training:
            for fused in (True, False):
                profile_training(train_config(fused), "fused" if fused else "unfused",
                                 args.profile_out)
        if args.profile_serving:
            profile_serving(device, args.profile_out, flash=args.flash, resnet=args.resnet)
        return 0
    tensor_cores = sass_phase()
    cfg = bench_config()
    model = build_model(cfg, device)
    results = kernel_phase(cfg, model, device)
    launches, periods = main_path_phase(cfg, model, device)
    reference_phase(cfg, model, device)
    train_model = build_model(train_config(True).model, device, seed=2)
    results.update(training_kernel_phase(cfg, train_model, device))
    train_launches, step_ms, h128_flash = training_path_phase()
    training_reference_phase(device, train_config(True).model, h128_reference_batches(), 11)
    del model, train_model
    torch.cuda.empty_cache()

    flagship = build_model(flagship_config(), device, seed=3)
    results.update(flagship_kernel_phase(flagship, device))
    flag_launches, flag_periods = flagship_path_phase(flagship, device)
    reference_phase(flagship.config, flagship, device, b=4, fused="chunk", fused_encoder=False)
    results.update(flagship_training_kernel_phase(flagship, device))
    del flagship
    torch.cuda.empty_cache()
    flag_train_launches, flag_train_ms, flag_train_peak = flagship_training_path_phase()
    training_reference_phase(device, flagship_config(), flagship_reference_batches(), 12)

    flash_results, flash_shapes = flash_kernel_phase(device)
    results.update(flash_results)
    flash = build_model(flash_flagship_config(), device, seed=3)
    flash_serve, flash_period_ms = flash_serving_phase(flash, device)
    del flash
    torch.cuda.empty_cache()
    flash_train, flash_train_ms = flash_training_path_phase()
    training_reference_phase(device, flash_flagship_config(), flagship_reference_batches(), 13)

    # the ResNet / Swin slice: default_tpu.yaml's model, then the decoder-only tier
    resnet = build_model(yaml_config("default_tpu.yaml").model, device, seed=4)
    resnet_encoder = image_encoder_phase(resnet, device)
    results.update(resnet_kernel_phase(resnet, device))
    resnet_launches, resnet_periods = lanes_phase(resnet, device, RESNET_LANES, RESNET_B, "ResNet")
    reference_phase(resnet.config, resnet, device, b=4, fused="chunk", fused_encoder=False)
    del resnet
    torch.cuda.empty_cache()
    resnet_train = resnet_training_phase()
    # in float32 (TF32 off): no kernel of the port runs on this step, and in bf16
    # cuDNN's and the CPU's roundings break the ResNet's ReLU / max-pool ties
    # differently, which AdamW turns into +-lr steps of the entries whose
    # gradient is rounding noise (update norm 0.23 in bf16, PERF.md)
    training_reference_phase(device, dataclasses.replace(
        yaml_config("default_tpu.yaml").model, compute_dtype="float32"),
        reference_batches(yaml_config("default_tpu.yaml")), 14)
    other_encoders = encoders_reference_phase(device)
    s0_results, s0_launches, s0_periods, s0_train_ms = decoder_only_phase(device)
    results.update(s0_results)

    # where each kernel instance ran: (source, the TPU kernel it replaces (the
    # pack: the JAX denoiser's pack_context_kv, whose layout the kernel's
    # K/V stream needs), its launches over the main paths that run it at the
    # checked shapes)
    csrc, tpu = "soccerdiffusion_tpu_torch/csrc/", "soccerdiffusion_tpu/ops/"
    flag = lambda name, lanes=tuple(FLAG_LANES): sum(flag_launches[lane][name] for lane in lanes)
    hd32_stack = flag("fused_encoder_stack_fwd") - flag("fused_encoder_stack_fwd_hd64")
    table = {
        "fused_encoder": ("fused_encoder.cu", "fused_encoder.py:319", launches["fused_encoder"]),
        "fused_chunk": ("fused_chunk.cu", "fused_chunk.py:518", launches["fused_chunk"]),
        "fused_denoise": ("fused_denoise.cu", "fused_denoise.py:382", launches["fused_denoise"]),
        "fused_denoise_pack": ("fused_denoise.cu", "fused_denoise.py:310",
                               launches["fused_denoise_pack"]),
        "fused_encoder_stack_fwd": ("fused_encoder_stack.cu", "fused_encoder_stack.py:274",
                                    train_launches["fused_encoder_stack_fwd"]),
        "fused_encoder_stack_bwd": ("fused_encoder_stack.cu", "fused_encoder_stack.py:300",
                                    train_launches["fused_encoder_stack_bwd"]),
        "fused_decoder_layer_fwd": ("fused_decoder_layer.cu", "fused_decoder_layer.py:343",
                                    train_launches["fused_decoder_layer_fwd"]),
        "fused_decoder_layer_bwd": ("fused_decoder_layer.cu", "fused_decoder_layer.py:371",
                                    train_launches["fused_decoder_layer_bwd"]),
        "fused_vit_block_fwd": ("fused_vit_block.cu", "fused_vit_block.py:703",
                                flag("fused_vit_block_fwd", ("ddim30", "distilled1"))),
        "fused_vit_block_fwd_raw_frames": ("fused_vit_block.cu", "fused_vit_block.py:703",
                                           flag("fused_vit_block_fwd", ("ddim30_raw_frames",))),
        "fused_chunk_hd64": ("fused_chunk.cu", "fused_chunk.py:518", flag("fused_chunk")),
        "fused_denoise_hd64": ("fused_denoise.cu", "fused_denoise.py:382", flag("fused_denoise")),
        "fused_denoise_pack_hd64": ("fused_denoise.cu", "fused_denoise.py:310",
                                    flag("fused_denoise_pack")),
        "fused_encoder_stack_fwd_hd64": ("fused_encoder_stack.cu", "fused_encoder_stack.py:274",
                                         flag("fused_encoder_stack_fwd_hd64")),
        "fused_encoder_stack_fwd_imgseq": ("fused_encoder_stack.cu", "fused_encoder_stack.py:274",
                                           hd32_stack),
        # the flagship's training path
        "fused_vit_block_bwd": ("fused_vit_block.cu", "fused_vit_block.py:722",
                                flag_train_launches["fused_vit_block_bwd"]),
        "fused_encoder_stack_bwd_hd64": ("fused_encoder_stack.cu", "fused_encoder_stack.py:300",
                                         flag_train_launches["fused_encoder_stack_bwd_hd64"]),
        "fused_encoder_stack_bwd_imgseq": ("fused_encoder_stack.cu", "fused_encoder_stack.py:300",
                                           flag_train_launches["fused_encoder_stack_bwd"]
                                           - flag_train_launches["fused_encoder_stack_bwd_hd64"]),
        "fused_decoder_layer_fwd_hd64": ("fused_decoder_layer.cu", "fused_decoder_layer.py:343",
                                         flag_train_launches["fused_decoder_layer_fwd_hd64"]),
        "fused_decoder_layer_bwd_hd64": ("fused_decoder_layer.cu", "fused_decoder_layer.py:371",
                                         flag_train_launches["fused_decoder_layer_bwd_hd64"]),
        # the flash paths: flagship serving and training, the h128 unfused step
        "flash_attention_fwd": ("flash_attention.cu", "flash_attention.py:228",
                                sum(p["flash_attention_fwd"] for p in (flash_serve, flash_train,
                                                                       h128_flash))),
        "flash_attention_bwd": ("flash_attention.cu", "flash_attention.py:284",
                                sum(p["flash_attention_bwd"] for p in (flash_serve, flash_train,
                                                                       h128_flash))),
        # the ResNet lanes (default_tpu.yaml): the decoder kernels at hd32, S=311
        "fused_chunk_resnet": ("fused_chunk.cu", "fused_chunk.py:518",
                               sum(n["fused_chunk"] for n in resnet_launches.values())),
        "fused_denoise_resnet": ("fused_denoise.cu", "fused_denoise.py:382",
                                 sum(n["fused_denoise"] for n in resnet_launches.values())),
        "fused_denoise_pack_resnet": ("fused_denoise.cu", "fused_denoise.py:310",
                                      sum(n["fused_denoise_pack"]
                                          for n in resnet_launches.values())),
        # the decoder-only tier's lanes: the decoder kernels at S=0 context tokens
        "fused_chunk_s0": ("fused_chunk.cu", "fused_chunk.py:518",
                           sum(n["fused_chunk"] for n in s0_launches.values())),
        "fused_denoise_s0": ("fused_denoise.cu", "fused_denoise.py:382",
                             sum(n["fused_denoise"] for n in s0_launches.values())),
        "fused_denoise_pack_s0": ("fused_denoise.cu", "fused_denoise.py:310",
                                  sum(n["fused_denoise_pack"] for n in s0_launches.values())),
    }
    kernels = [{"name": name, "route": "cuda", "source": csrc + table[name][0],
                "replaces": tpu + table[name][1], "launches": table[name][2], **r}
               for name, r in results.items()]
    missing = sorted(set(table) - set(results)) + [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels not checked or not launched on a main path: {missing}")
    log(json.dumps({"kernels": kernels, "ms_per_replan_period": periods, "batch": BENCH_B,
                    "flagship_ms_per_replan_period": flag_periods, "flagship_batch": FLAG_B,
                    "train_ms_per_step": step_ms, "train_batch": TRAIN_BATCH,
                    "flagship_train_ms_per_step": flag_train_ms,
                    "flagship_train_batch": FLAG_TRAIN_B,
                    "flagship_train_peak_bytes": flag_train_peak,
                    "flash_flagship_ms_per_replan_period": flash_period_ms,
                    "flash_flagship_train_ms_per_step": flash_train_ms,
                    "flash_launches": {"flagship_serving": flash_serve,
                                       "flagship_training": flash_train, "h128_training": h128_flash},
                    "flash_shapes": flash_shapes, "tensor_core_sass": tensor_cores,
                    "resnet": {"yaml": "default_tpu.yaml", "encoder": resnet_encoder,
                               "ms_per_replan_period": resnet_periods, "batch": RESNET_B,
                               "launches": resnet_launches, "train": resnet_train,
                               "other_encoders": other_encoders},
                    "decoder_only": {"ms_per_replan_period": s0_periods, "batch": DECODER_ONLY_B,
                                     "train_ms_per_step": s0_train_ms},
                    "gpu": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
