"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes off the main paths (serving: patch 2, five-dim IMU, no game state,
short contexts, 5-step chunks, a batch that is no multiple of anything,
decoder head_dim 64 at h128; training: B=5, T=7, S=33, head_dim 32 and 64;
the ViT block forward and backward: T=49 tokens, N=7 frames, exact GELU at
head_dim 64, quick GELU at head_dim 32; the tensor-core layer code of the
ViT block and the encoder stack at ragged T = 1, 10, 49, 64, 100 with one
and odd counts of frames or robots, and their backwards bit-identical over
two launches).

Needs an NVIDIA GPU and nvcc; skipped elsewhere. JAX-free, so it runs on a
machine without jax: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance: max |kernel - plain| <= 2e-2 x max |plain| (both round to bf16 at
the same points; see chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table, solver_timesteps
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

pytestmark = pytest.mark.cuda

TOL = 2e-2
CFG = ModelConfig(
    num_joints=12, hidden_dim=128, trajectory_prediction_length=7,
    action_context_length=24, joint_state_context_length=24, imu_context_length=24,
    use_images=False, use_gamestate=True, num_action_history_encoder_layers=1,
    num_imu_encoder_layers=2, joint_state_encoder_layers=1, num_decoder_layers=2,
    compute_dtype="bfloat16", attention_impl="xla")
VARIANTS = [
    {},
    {"encoder_patch_size": 2, "imu_orientation_embedding_method": "five_dim",
     "use_gamestate": False},
    {"num_decoder_heads": 2},  # the chunk and denoiser kernels at head_dim 64
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def setup(variant, device, b=13):
    cfg = dataclasses.replace(CFG, **variant)
    model = DiffusionPolicy(cfg)
    model = load_jax_params(model, random_jax_params(model, seed=2)).to(device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device)
    batch = {
        "joint_command_history": t(rng.uniform(0, 6.28, (b, 24, 12)).astype(np.float32)),
        "rotation": t(rng.normal(size=(b, 24, cfg.imu_input_dim)).astype(np.float32)),
        "joint_state": t(rng.uniform(0, 6.28, (b, 24, 12)).astype(np.float32)),
        "game_state": t(rng.integers(0, 4, (b,))),
    }
    noise = t(rng.normal(size=(b, 7, 12)).astype(np.float32))
    return cfg, model, batch, noise


def assert_close(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernels_match_plain_versions(variant, device):
    cfg, model, batch, noise = setup(variant, device)
    with torch.no_grad():
        enc = FusedContextEncoder(model)
        n0 = FusedContextEncoder.launches
        assert_close(enc.encode_kernel(batch), enc.encode_plain(batch))
        assert FusedContextEncoder.launches == n0 + 1
        context = enc.encode_plain(batch)
        schedule = make_schedule(100)
        for solver in ("ddim", "dpmpp"):
            ts = solver_timesteps(schedule, 5)
            chunk = FusedChunkSampler(model)
            stk, stv = chunk.step_tables(model.step_encoding(torch.as_tensor(ts, device=device).long())[:, 0])
            coefs = solver_coef_table(schedule, 5, solver)
            assert_close(chunk.sample_kernel(context, noise, stk, stv, coefs),
                         chunk.sample_plain(context, noise, stk, stv, coefs))
        den = FusedDenoiser(model)
        packed = den.pack_context_kv(model.precompute_context_kv(context))
        for coefs in (None, [1.1, 0.5, 0.9, 0.3]):
            assert_close(den.run_kernel(packed, noise, stk[1], stv[1], coefs),
                         den.run_plain(packed, noise, stk[1], stv[1], coefs))


def test_wrapper_rejects_float32_weights(device):
    cfg, model, batch, _ = setup({"compute_dtype": "float32"}, device)
    with pytest.raises(ValueError, match="bfloat16"):
        FusedContextEncoder(model).encode(batch)


# ------------------------------------------------------- training kernels
# A and B: the fused decoder layer fwd / bwd; C and D: the fused encoder
# stack fwd / bwd, at B=5, T=7 chunk / context rows, S=33 memory rows. Each
# output and every weight gradient within TOL x max|plain|; the two
# gradients that are zero in exact arithmetic (the key third of bqkv, bck)
# against the largest weight gradient of the layer.

def training_weights(device):
    cfg = dataclasses.replace(CFG, num_action_history_encoder_layers=2, compute_dtype="bfloat16",
                              encoder_fused_stack=True, decoder_fused_block=True)
    model = DiffusionPolicy(cfg)
    model = load_jax_params(model, random_jax_params(model, seed=4)).to(device)
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import layer_weights
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import stack_weights

    enc = [t.detach().to(torch.bfloat16) for t in
           stack_weights(model.action_history_encoder.seq.encoder.layers)]
    dec = [t.detach().to(torch.bfloat16) for t in
           layer_weights(model.diffusion_action_generator.decoder.layers[0])]
    return enc, dec


def assert_grads_close(names, got, ref, zero):
    top = max(r.abs().max().item() for r in ref)
    for name, g, r in zip(names, got, ref):
        g, r = g.float(), r.float()
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        err = (g - r).abs()
        if name in zero:
            cut = zero[name]
            assert err[..., cut].max().item() <= TOL * top, name
            err[..., cut] = 0
        assert err.max().item() <= TOL * r.abs().max().item(), (name, err.max().item())


def test_encoder_stack_kernels_match_plain_versions(device):
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    w, _ = training_weights(device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(5, 7, 128)).astype(np.float32)).to(device, torch.bfloat16)
    dy = torch.from_numpy(rng.normal(size=(5, 7, 128)).astype(np.float32)).to(device, torch.bfloat16)
    n_fwd, n_bwd = fes.FusedEncoderStack.fwd_launches, fes.FusedEncoderStack.bwd_launches
    y, acts = fes.forward_kernel(x, w, 4)
    assert_close(y, fes.forward_plain(x, w, 4))
    dx, grads = fes.backward_kernel(acts, dy, w, 4)
    dx_ref, grads_ref = fes.backward_plain(x, dy, w, 4)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(128, 256)})
    assert (fes.FusedEncoderStack.fwd_launches, fes.FusedEncoderStack.bwd_launches) == (n_fwd + 1, n_bwd + 1)


def test_decoder_layer_kernels_match_plain_versions(device):
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    _, w = training_weights(device)
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, mem, dy = t(5, 7, 128), t(5, 33, 128), t(5, 7, 128)
    n_fwd, n_bwd = fdl.FusedDecoderLayer.fwd_launches, fdl.FusedDecoderLayer.bwd_launches
    assert_close(fdl.forward_kernel(x, mem, w, 4), fdl.forward_plain(x, mem, w, 4))
    dx, dmem, grads = fdl.backward_kernel(x, mem, dy, w, 4)
    dx_ref, dmem_ref, grads_ref = fdl.backward_plain(x, mem, dy, w, 4)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_close(dmem, dmem_ref)
    assert_grads_close(fdl.WEIGHT_NAMES, grads, grads_ref,
                       {"bqkv": slice(128, 256), "bck": slice(None)})
    assert (fdl.FusedDecoderLayer.fwd_launches, fdl.FusedDecoderLayer.bwd_launches) == (n_fwd + 1, n_bwd + 1)


def test_training_kernels_at_head_dim_64(device):
    """The training kernels take head_dim 32 and 64 (the flagship's): at 64
    the encoder-stack backward and the decoder layer's forward and backward
    agree with their plain versions; head_dim 16 is refused."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    enc, dec = training_weights(device)
    rng = np.random.default_rng(9)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy, mem = t(5, 7, 128), t(5, 7, 128), t(5, 33, 128)
    n = (fes.FusedEncoderStack.bwd_launches_hd64, fdl.FusedDecoderLayer.fwd_launches_hd64,
         fdl.FusedDecoderLayer.bwd_launches_hd64)
    _, acts = fes.forward_kernel(x, enc, 2)
    dx, grads = fes.backward_kernel(acts, dy, enc, 2)
    dx_ref, grads_ref = fes.backward_plain(x, dy, enc, 2)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(128, 256)})
    assert_close(fdl.forward_kernel(x, mem, dec, 2), fdl.forward_plain(x, mem, dec, 2))
    ddx, dmem, dgrads = fdl.backward_kernel(x, mem, dy, dec, 2)
    ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(x, mem, dy, dec, 2)
    torch.cuda.synchronize()
    assert_close(ddx, ddx_ref)
    assert_close(dmem, dmem_ref)
    assert_grads_close(fdl.WEIGHT_NAMES, dgrads, dgrads_ref,
                       {"bqkv": slice(128, 256), "bck": slice(None)})
    assert (fes.FusedEncoderStack.bwd_launches_hd64, fdl.FusedDecoderLayer.fwd_launches_hd64,
            fdl.FusedDecoderLayer.bwd_launches_hd64) == tuple(k + 1 for k in n)
    with pytest.raises(ValueError, match="head_dim 32"):
        fes.forward_kernel(x, enc, 8)  # head_dim 16
    with pytest.raises(ValueError, match="head_dim 32"):
        fdl.forward_kernel(x, mem, dec, 8)


def test_decoder_layer_kernels_reject_an_mlp_width_off_8(device):
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    _, dec = training_weights(device)
    ff = 12
    dec[18], dec[19], dec[20] = (torch.zeros(s, device=device, dtype=torch.bfloat16)
                                 for s in ((128, ff), (ff,), (ff, 128)))
    x = torch.zeros((2, 7, 128), device=device, dtype=torch.bfloat16)
    mem = torch.zeros((2, 33, 128), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8, got 12"):
        fdl.forward_kernel(x, mem, dec, 4)
    with pytest.raises(ValueError, match="multiple of 8, got 12"):
        fdl.backward_kernel(x, mem, x, dec, 4)


def test_training_weight_grads_are_deterministic(device):
    """The weight gradients are summed over the batch in a fixed order: two
    backward launches on the same inputs agree bit for bit."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    _, w = training_weights(device)
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, mem, dy = t(37, 10, 128), t(37, 302, 128), t(37, 10, 128)
    first, second = (fdl.backward_kernel(x, mem, dy, w, 4) for _ in range(2))
    for a, b in zip([first[0], first[1], *first[2]], [second[0], second[1], *second[2]]):
        assert torch.equal(a, b)


# ------------------------------------------------------------ ViT block
def vit_weights(device, W, FF, seed=6):
    rng = np.random.default_rng(seed)
    shapes = [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,), (W,), (W,), (W, FF), (FF,), (FF, W),
              (W,)]
    w = []
    for i, s in enumerate(shapes):
        a = rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s)
        w.append(torch.from_numpy((a + (1.0 if i in (0, 6) else 0.0)).astype(np.float32)).to(device))
    return w


@pytest.mark.parametrize("W,H,gelu", [(256, 4, "exact"), (128, 4, "quick")])
def test_vit_block_kernel_matches_plain_version(W, H, gelu, device):
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    w = [t.to(torch.bfloat16) for t in vit_weights(device, W, 4 * W)]
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(7, 49, W)).astype(np.float32))
    x = x.to(device, torch.bfloat16)
    n0 = fvb.forward_kernel.launches
    with torch.no_grad():
        got = fvb.vit_block(x, w, H, gelu)
    torch.cuda.synchronize()
    assert fvb.forward_kernel.launches == n0 + 1
    assert_close(got, fvb.forward_plain(x, w, H, gelu))


@pytest.mark.parametrize("W,H,gelu", [(256, 4, "exact"), (128, 4, "quick")])
def test_vit_block_backward_kernel_matches_plain_version(W, H, gelu, device):
    """The backward kernel through FusedVitBlock (float32 masters, as in
    training): dx and every weight gradient against backward_plain."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    masters = [t.requires_grad_(True) for t in vit_weights(device, W, 4 * W, seed=8)]
    rng = np.random.default_rng(10)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(7, 49, W).requires_grad_(True), t(7, 49, W)
    n0 = fvb.backward_kernel.launches
    fvb.vit_block(x, masters, H, gelu).backward(dy)
    w = [m.detach().to(torch.bfloat16) for m in masters]
    dx_ref, grads_ref = fvb.backward_plain(x.detach(), dy, w, H, gelu)
    torch.cuda.synchronize()
    assert fvb.backward_kernel.launches == n0 + 1
    assert_close(x.grad, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, [m.grad for m in masters], grads_ref,
                       {"bqkv": slice(W, 2 * W)})


def test_encoder_stack_head_dim_64(device):
    """The forward at head_dim 64 against its plain version, and a backward
    through the autograd function on the float32 masters."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    enc, _ = training_weights(device)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(5, 7, 128)).astype(np.float32))
    x = x.to(device, torch.bfloat16)
    y, _ = fes.forward_kernel(x, enc, 2)
    assert_close(y, fes.forward_plain(x, enc, 2))
    masters = [t.float().requires_grad_(True) for t in enc]
    n0 = fes.FusedEncoderStack.bwd_launches_hd64
    fes.encoder_stack(x, masters, 2).float().sum().backward()
    torch.cuda.synchronize()
    assert fes.FusedEncoderStack.bwd_launches_hd64 == n0 + 1
    assert all(torch.isfinite(m.grad).all() for m in masters)


# ------------------------------------------ tensor-core layer code, ragged
# encoder_layer.cuh / mma.cuh mask T at the m16 / n8 / k16 tile edges and
# loop over key blocks past 64 (ViT forward) or 32 keys (backwards); T=1
# makes dk exactly zero. (T, frames or robots); the ViT forward of a
# 256-wide frame fits shared memory up to T=74.
RAGGED = [(1, 1), (10, 5), (49, 7), (64, 1), (100, 3)]
VIT_CASES = [(W, H, gelu, T, n) for W, H, gelu in ((128, 4, "quick"), (128, 4, "exact"),
                                                   (256, 4, "exact"), (256, 4, "quick"))
             for T, n in RAGGED if W * T <= 256 * 74]


@pytest.mark.parametrize("W,H,gelu,T,n", VIT_CASES)
def test_vit_block_kernels_at_ragged_shapes(W, H, gelu, T, n, device):
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    w = [t.to(torch.bfloat16) for t in vit_weights(device, W, 4 * W, seed=T)]
    rng = np.random.default_rng(T + n)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(n, T, W), t(n, T, W)
    assert_close(fvb.forward_kernel(x, w, H, gelu), fvb.forward_plain(x, w, H, gelu))
    dx, grads = fvb.backward_kernel(x, dy, w, H, gelu)
    dx_ref, grads_ref = fvb.backward_plain(x, dy, w, H, gelu)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(W, 2 * W)})


@pytest.mark.parametrize("T,b", RAGGED)
@pytest.mark.parametrize("H", [4, 2])  # head_dim 32, 64 at E=128
def test_encoder_stack_kernels_at_ragged_shapes(T, b, H, device):
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    w, _ = training_weights(device)
    rng = np.random.default_rng(T + b)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(b, T, 128), t(b, T, 128)
    y, acts = fes.forward_kernel(x, w, H)
    assert_close(y, fes.forward_plain(x, w, H))
    dx, grads = fes.backward_kernel(acts, dy, w, H)
    dx_ref, grads_ref = fes.backward_plain(x, dy, w, H)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(128, 256)})


@pytest.mark.parametrize("op", ["vit_block", "encoder_stack"])
def test_layer_backward_is_deterministic(op, device):
    """Two backward launches on the same inputs agree bit for bit (the
    attention backward owns query and key rows by warp, the weight
    gradients are summed in a fixed order): the ViT block at the flagship's
    frame (T=64, W=256, quick GELU), the encoder stack at T=100, head_dim 64."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    if op == "vit_block":
        w = [m.to(torch.bfloat16) for m in vit_weights(device, 256, 1024)]
        x, dy = t(37, 64, 256), t(37, 64, 256)
        run = lambda: fvb.backward_kernel(x, dy, w, 4, "quick")
    else:
        w, _ = training_weights(device)
        x, dy = t(37, 100, 128), t(37, 100, 128)
        _, acts = fes.forward_kernel(x, w, 2)
        run = lambda: fes.backward_kernel(acts, dy, w, 2)
    (dx1, g1), (dx2, g2) = run(), run()
    torch.cuda.synchronize()
    for a, b in zip([dx1, *g1], [dx2, *g2]):
        assert torch.equal(a, b)


# ------------------------------------------------------- flash attention
# Off the main path: unaligned lengths, head_dim 8 / 48 / 128 (the 32-, 64-
# and 128-lane instances with masked lanes), the TPU kernel's streamed
# regime (Tk = 1536), one row and one key; fp32 and bf16; forward and
# backward through the autograd function. q, k, v arrive as (B, H, T, D)
# transposes, so the kernels read them through their strides.

FLASH_SHAPES = [(3, 7, 13, 2, 8), (2, 196, 196, 4, 48), (1, 16, 1536, 2, 16), (2, 65, 130, 3, 128),
                (2, 1, 3, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernels_match_plain_versions(shape, dtype, device):
    from soccerdiffusion_tpu_torch.ops import flash_attention as fa

    b, tq, tk, h, d = shape
    rng = np.random.default_rng(11)
    t = lambda T: torch.from_numpy(rng.normal(size=(b, h, T, d)).astype(np.float32)).to(
        device, dtype).transpose(1, 2)
    q, k, v, do = t(tq), t(tk), t(tk), t(tq)
    o_ref, lse_ref = fa.plain_forward(q, k, v)
    grads_ref = fa.plain_backward(q, k, v, o_ref, lse_ref, do)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    n = fa.FlashAttention.launches, fa.FlashAttention.backward_launches
    o = fa.flash_attention(*leaves)
    _, lse = fa.forward_kernel(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa.FlashAttention.launches, fa.FlashAttention.backward_launches) == (n[0] + 2, n[1] + 1)
    assert o.dtype == dtype
    assert_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    for leaf, ref in zip(leaves, grads_ref):
        assert_close(leaf.grad, ref)


def test_flash_attention_refuses_head_dim_over_128(device):
    from soccerdiffusion_tpu_torch.ops import flash_attention as fa

    x = torch.zeros((1, 4, 2, 129), device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.forward_kernel(x, x, x)
