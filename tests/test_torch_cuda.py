"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes off the main paths (serving: patch 2, five-dim IMU, no game state,
short contexts, 5-step chunks, a batch that is no multiple of anything,
decoder head_dim 64 at h128; training: B=5, T=7, S=33, head_dim 32 and 64,
the decoder layer at T = 7 / 10 / 13 over S = 19 / 302 / 312 memory rows;
the ViT block forward and backward: T=49 tokens, N=7 frames, exact GELU at
head_dim 64, quick GELU at head_dim 32; the tensor-core layer code of the
ViT block and the encoder stack at ragged T = 1, 10, 49, 64, 100 with one
and odd counts of frames or robots, and their backwards bit-identical over
two launches and to tests/data/layer_kernels_golden.json with the serving
denoiser; the decoder-layer and flash backwards bit-identical over two
launches; the tensor-core chunk sampler over S = 17 / 301 / 311 / 312 at
head_dim 32 and 64, DDIM and DPM-Solver++, B = 1 / 13 / 133, a robot in
one block or in a 2-block cluster over an odd layer count, the serving
denoiser on the same pass at the same shapes in its eps and DDIM forms and
its per-step sampler, and the context encoder at T = 24 / 100 / 128, patch
1 and 2, with and without the game state, all bit-identical over two
launches; the decoder kernels and the pack at S=0 context tokens, the
decoder-only tier; their head_dim-128 instances (hidden 512, larger_model)
at S = 17 / 311 / 312 / 383, B = 1 / 13 / 64 / 133, over 3 and 8 layers;
the chunk sampler's int8 form at every cluster shape (R = 1 to 32 robots a
block) and head dim, and its "qstat" form in one block and in a cluster;
the ViT block's "poly" and "bf16" GELUs at ragged shapes;
the ViT block's row-tiled backward at the flagship's frame over N=301
frames (a ragged last row tile), head_dim 64 and 32, bit-identical over two
launches, its path counter, and the per-frame backward at the W=256 ragged
shapes that backward_kernel now hands to the row-tiled path;
the ViT block, the encoder stack and the decoder layer at the camera
ledger's shapes (T=36 x W=128 frames, the head_dim-16 image-sequence stack
at T=5 and ragged T, T=100 stacks, S=307);
the decoder kernels at the shared-memory limits check_kernel_shapes names,
and refused one 32-key block past them;
the ResNet18 / ResNet50 / Swin-T encoders' train and eval modes, running
statistics and gradients on the card against the CPU in float64, with and
without remat).

Needs an NVIDIA GPU and nvcc; skipped elsewhere. JAX-free, so it runs on a
machine without jax: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance: max |kernel - plain| <= 2e-2 x max |plain| (both round to bf16 at
the same points; see chip_smoke.py); the image encoders, float64 on both
devices (cuDNN's and the CPU's convolutions sum in other orders, and in
float32 a ReLU or max-pool near-tie may go either way), 1e-9 of scale.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table, solver_timesteps
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler, int8_scale, quantise
from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
from soccerdiffusion_tpu_torch.models.layers import BatchNorm
from soccerdiffusion_tpu_torch.models.vision import make_image_encoder
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
    model = load_jax_params(model, *random_jax_params(model, seed=2)).to(device)
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
    model = load_jax_params(model, *random_jax_params(model, seed=4)).to(device)
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
    agree with their plain versions; head_dim 16 is refused by the decoder
    layer (the stack takes it: test_encoder_stack_kernels_at_the_ledger_shapes)
    and head_dim 8 by the stack."""
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
    with pytest.raises(ValueError, match="head_dim 16 or 32 or 64, got 8"):
        fes.forward_kernel(x, enc, 16)
    with pytest.raises(ValueError, match="head_dim 32"):
        fdl.forward_kernel(x, mem, dec, 8)  # head_dim 16


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
                                                   (256, 4, "exact"), (256, 4, "quick"),
                                                   (128, 4, "poly"), (256, 4, "bf16"))
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


@pytest.mark.parametrize("W,H,gelu,T,n", [c for c in VIT_CASES if c[0] == 256])
def test_vit_block_per_frame_backward_at_ragged_shapes(W, H, gelu, T, n, device):
    """The per-frame backward kernel at the width whose shapes backward_kernel
    hands to the row-tiled kernels: both paths stay held to the plain
    version there."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    w = [t.to(torch.bfloat16) for t in vit_weights(device, W, 4 * W, seed=T)]
    rng = np.random.default_rng(T + n)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(n, T, W), t(n, T, W)
    assert fvb.row_tiled(T, W, H, 4 * W)
    n0 = fvb.backward_kernel.row_tiled
    dx, grads = fvb.backward_per_frame(x, dy, w, H, gelu)
    dx_ref, grads_ref = fvb.backward_plain(x, dy, w, H, gelu)
    torch.cuda.synchronize()
    assert fvb.backward_kernel.row_tiled == n0
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(W, 2 * W)})


@pytest.mark.parametrize("H", [4, 8])  # head_dim 64 (the flagship), 32
def test_vit_block_row_tiled_backward_at_the_flagship_shape(H, device):
    """The row-tiled backward at the flagship's frame (T=64, W=256, quick
    GELU) over N=301 frames, 150.5 row tiles of 128: dx and every weight
    gradient against backward_plain, the path counter one up a launch, and
    a second launch bit-identical."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    w = [t.to(torch.bfloat16) for t in vit_weights(device, 256, 1024, seed=64)]
    rng = np.random.default_rng(301)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(301, 64, 256), t(301, 64, 256)
    n0, r0 = fvb.backward_kernel.launches, fvb.backward_kernel.row_tiled
    dx, grads = fvb.backward_kernel(x, dy, w, H, "quick")
    torch.cuda.synchronize()
    assert (fvb.backward_kernel.launches, fvb.backward_kernel.row_tiled) == (n0 + 1, r0 + 1)
    dx_ref, grads_ref = fvb.backward_plain(x, dy, w, H, "quick")
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(256, 512)})
    dx2, grads2 = fvb.backward_row_tiled(x, dy, w, H, "quick")
    torch.cuda.synchronize()
    assert fvb.backward_kernel.row_tiled == r0 + 2
    for a, b in zip([dx, *grads], [dx2, *grads2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [1, 65, 301, 2560])
def test_vit_block_row_tiled_partials(N, device):
    """The row-tiled backward's weight-gradient partials as the C side sizes
    them (sd_vit_block_bwd_rows_partials): a split of the N T rows for each
    4096 begun, no more than the card's SMs hold blocks of the 24 output
    tiles once, each split's 4 products over 128 x 256 tiles."""
    from soccerdiffusion_tpu_torch.ops import _build

    T, W, FF = 64, 256, 1024
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(sms // 24, -(-N * T // 4096)))
    rows = 64 * -(-N * T // (64 * splits))
    got = _build.library().sd_vit_block_bwd_rows_partials(_build.ints(N, T, W, FF))
    assert got == -(-N * T // rows) * (4 * W * W + 2 * W * FF)


def test_vit_block_backward_path_counter(device):
    """backward_kernel counts a row-tiled launch at W=256 and none at the
    camera ledger's W=128, through FusedVitBlock as in training."""
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    rng = np.random.default_rng(5)
    for W, T, expect in ((256, 64, 1), (128, 36, 0)):
        masters = [m.requires_grad_(True) for m in vit_weights(device, W, 4 * W, seed=W)]
        x = torch.from_numpy(rng.normal(size=(3, T, W)).astype(np.float32)).to(device, torch.bfloat16)
        n0, r0 = fvb.backward_kernel.launches, fvb.backward_kernel.row_tiled
        fvb.vit_block(x.requires_grad_(True), masters, 4, "quick").float().sum().backward()
        torch.cuda.synchronize()
        assert fvb.backward_kernel.launches == n0 + 1
        assert fvb.backward_kernel.row_tiled == r0 + expect
        assert all(torch.isfinite(m.grad).all() for m in masters)


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
# regime (Tk = 1536), one row and one key, Tq != Tk with Tk no multiple of
# 64 (the decoder's cross-attention, Tq = 10 over Tk = 312), head_dim 1 and
# 12 (the bf16 kernels' element copies instead of 16-byte ones); fp32 and
# bf16; forward and backward through the autograd function. q, k, v arrive
# as (B, H, T, D) transposes, so the kernels read them through their strides.

FLASH_SHAPES = [(3, 7, 13, 2, 8), (2, 196, 196, 4, 48), (1, 16, 1536, 2, 16), (2, 65, 130, 3, 128),
                (2, 1, 3, 1, 1), (2, 10, 312, 4, 64), (3, 13, 100, 2, 32), (2, 20, 70, 3, 12)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(dtype, device):
    """Two backward launches agree bit for bit (dq and dk / dv are owned by
    query and key rows, no atomics), at Tq != Tk."""
    from soccerdiffusion_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(13)
    t = lambda T: torch.from_numpy(rng.normal(size=(4, T, 4, 64)).astype(np.float32)).to(
        device, dtype)
    q, k, v, do = t(64), t(130), t(130), t(64)
    o, lse = fa.forward_kernel(q, k, v)
    first, second = (fa.backward_kernel(q, k, v, o, lse, do) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ------------------------------------------ the decoder layer, ragged
# The tensor-core decoder layer: T = 7 / 10 / 13 chunk rows (one m16 tile,
# and a second one) over S = 19 (one 32-key chunk of the forward's split
# cross-attention), 302 (h128) and 312 (the flagship) memory rows, head_dim
# 32 and 64 at E = 128, and the flagship's E = 256 with 4 heads of 64.

def decoder_weights(device, E, FF, seed):
    """The 22 bf16 weights in WEIGHT_NAMES order: Dense kernels ~ 1/sqrt(fan_in),
    LayerNorm gains near 1, small biases."""
    rng = np.random.default_rng(seed)
    shapes = [(E,), (E,), (E, 3 * E), (3 * E,), (E, E), (E,), (E,), (E,), (E, E), (E,), (E, E),
              (E,), (E, E), (E,), (E, E), (E,), (E,), (E,), (E, FF), (FF,), (FF, E), (E,)]
    w = []
    for i, s in enumerate(shapes):
        a = rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s)
        a = a + (1.0 if i in (0, 6, 16) else 0.0)
        w.append(torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16))
    return w


DEC_RAGGED = [(T, S, E, H) for T, S in ((7, 19), (10, 302), (13, 312))
              for E, H in ((128, 4), (128, 2))] + [(10, 312, 256, 4)]


@pytest.mark.parametrize("T,S,E,H", DEC_RAGGED)
def test_decoder_layer_kernels_at_ragged_shapes(T, S, E, H, device):
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    w = decoder_weights(device, E, E, seed=T + S)
    rng = np.random.default_rng(T * S)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, mem, dy = t(3, T, E), t(3, S, E), t(3, T, E)
    assert_close(fdl.forward_kernel(x, mem, w, H), fdl.forward_plain(x, mem, w, H))
    dx, dmem, grads = fdl.backward_kernel(x, mem, dy, w, H)
    dx_ref, dmem_ref, grads_ref = fdl.backward_plain(x, mem, dy, w, H)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_close(dmem, dmem_ref)
    assert_grads_close(fdl.WEIGHT_NAMES, grads, grads_ref,
                       {"bqkv": slice(E, 2 * E), "bck": slice(None)})


# ------------------------------------------ the camera ledger's bf16 shapes
# evaluation/ledger.py's run F model (96 px frames in patches of 16: T=36
# tokens; the width-128 ViT of 4 heads of 32, exact GELU; 5 frames a window;
# hidden 128): the ViT block over a B=64 step's 320 frames, a report batch's
# and one frame; the image-sequence stack (8 heads of 16: the stack's
# head_dim-16 instances) at T=5 and ragged T, a proprioceptive stack (4
# heads of 32) at T=100, one layer (--fast's depth) and two; the decoder
# layer at T=10 over S=307 memory rows (300 proprioceptive tokens, 5 image
# tokens, the game state and the step token).
LEDGER_FRAMES = [320, 13, 1]
LEDGER_STACKS = [(5, 64, 1, 8), (5, 13, 1, 8), (5, 64, 2, 8), (1, 3, 1, 8), (49, 7, 2, 8),
                 (100, 3, 1, 8), (100, 64, 1, 4), (100, 3, 2, 4)]
LEDGER_ROBOTS = [64, 13, 1]


@pytest.mark.parametrize("n", LEDGER_FRAMES)
def test_vit_block_kernels_at_the_ledger_shapes(n, device):
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    w = [t.to(torch.bfloat16) for t in vit_weights(device, 128, 512, seed=36)]
    rng = np.random.default_rng(n)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(n, 36, 128), t(n, 36, 128)
    assert_close(fvb.forward_kernel(x, w, 4, "exact"), fvb.forward_plain(x, w, 4, "exact"))
    dx, grads = fvb.backward_kernel(x, dy, w, 4, "exact")
    dx_ref, grads_ref = fvb.backward_plain(x, dy, w, 4, "exact")
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(128, 256)})


@pytest.mark.parametrize("T,b,layers,H", LEDGER_STACKS)
def test_encoder_stack_kernels_at_the_ledger_shapes(T, b, layers, H, device):
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    w, _ = training_weights(device)
    w = [t[:layers] for t in w]
    rng = np.random.default_rng(T * b + layers + H)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, dy = t(b, T, 128), t(b, T, 128)
    y, acts = fes.forward_kernel(x, w, H)
    assert_close(y, fes.forward_plain(x, w, H))
    dx, grads = fes.backward_kernel(acts, dy, w, H)
    dx_ref, grads_ref = fes.backward_plain(x, dy, w, H)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_grads_close(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(128, 256)})


@pytest.mark.parametrize("b", LEDGER_ROBOTS)
def test_decoder_layer_kernels_at_the_ledger_shapes(b, device):
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    w = decoder_weights(device, 128, 128, seed=307)
    rng = np.random.default_rng(b)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, mem, dy = t(b, 10, 128), t(b, 307, 128), t(b, 10, 128)
    assert_close(fdl.forward_kernel(x, mem, w, 4), fdl.forward_plain(x, mem, w, 4))
    dx, dmem, grads = fdl.backward_kernel(x, mem, dy, w, 4)
    dx_ref, dmem_ref, grads_ref = fdl.backward_plain(x, mem, dy, w, 4)
    torch.cuda.synchronize()
    assert_close(dx, dx_ref)
    assert_close(dmem, dmem_ref)
    assert_grads_close(fdl.WEIGHT_NAMES, grads, grads_ref,
                       {"bqkv": slice(128, 256), "bck": slice(None)})


def test_decoder_layer_backward_is_deterministic_at_head_dim_64(device):
    """The flagship's shape (E=256, 4 heads of 64, T=10 over S=312): two
    backward launches agree bit for bit."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl

    w = decoder_weights(device, 256, 256, seed=5)
    rng = np.random.default_rng(14)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, torch.bfloat16)
    x, mem, dy = t(9, 10, 256), t(9, 312, 256), t(9, 10, 256)
    first, second = (fdl.backward_kernel(x, mem, dy, w, 4) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip([first[0], first[1], *first[2]], [second[0], second[1], *second[2]]):
        assert torch.equal(a, b)


def test_layer_kernels_bit_identical_to_record(device):
    """The ViT-block and encoder-stack kernels, forward and backward, give
    the outputs recorded before their shared attention tiles
    (csrc/mma.cuh) took separate q and k / v operands for the decoder layer
    and flash attention, the chunk sampler the outputs recorded before its
    pass moved into csrc/decoder_pass.cuh, and the serving denoiser those
    recorded from its kernel on that pass, bit for bit
    (tests/cuda_golden.py)."""
    import importlib.util
    import json
    from pathlib import Path

    here = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("cuda_golden", here / "cuda_golden.py")
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    record = json.loads((here / "data" / "layer_kernels_golden.json").read_text())
    assert golden.fingerprints(device) == record["fingerprints"]


# ------------------------------------- the serving kernels on tensor cores
# The chunk sampler over S = 17 (one 32-key chunk with the step token), 301
# (h128), 311 (the flagship) and 312 context tokens (a chunk of one key),
# head_dim 32 (E=128) and 64 (E=256, the flagship's widths), DDIM and
# DPM-Solver++, B = 1, 13 and 133 (past the 132 SMs; below 67 a robot's
# heads split over a 2-block cluster), P=10, J=20, 5 steps; a robot in one
# block and in a cluster at B=13 over 3 layers;
# the context encoder at T = 24, 100 and 128 tokens per stack, patch 1 and
# 2, with and without the game-state token. Both bit-identical over two
# launches.

SERVING_WIDTHS = {32: (128, 4), 64: (256, 4), 128: (512, 4)}


def serving_model(device, head_dim, **changes):
    E, H = SERVING_WIDTHS[head_dim]
    cfg = dataclasses.replace(CFG, hidden_dim=E, num_decoder_heads=H, num_joints=20,
                              trajectory_prediction_length=10, **changes)
    model = DiffusionPolicy(cfg)
    return cfg, load_jax_params(model, *random_jax_params(model, seed=head_dim)).to(device)


def chunk_inputs(cfg, model, device, b, S, solver, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    chunk = FusedChunkSampler(model)
    stk, stv = chunk.step_tables(t(5, cfg.hidden_dim))
    coefs = solver_coef_table(make_schedule(100), 5, solver)
    return chunk, (t(b, S, cfg.hidden_dim).to(torch.bfloat16), t(b, 10, 20), stk, stv, coefs)


@pytest.mark.parametrize("b", [1, 13, 133])
@pytest.mark.parametrize("solver", ["ddim", "dpmpp"])
@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("S", [0, 17, 301, 311, 312])
def test_chunk_kernel_matches_plain_version(S, head_dim, solver, b, device):
    cfg, model = serving_model(device, head_dim)
    chunk, args = chunk_inputs(cfg, model, device, b, S, solver, seed=S + b)
    n = FusedChunkSampler.launches
    with torch.no_grad():
        got = chunk.sample_kernel(*args)
        assert FusedChunkSampler.launches == n + 1
        assert_close(got, chunk.sample_plain(*args))


@pytest.mark.parametrize("head_dim,b", [(32, 13), (32, 64), (32, 133), (64, 13), (64, 64),
                                        (128, 13), (128, 64)])
def test_chunk_kernel_is_deterministic(head_dim, b, device):
    """Bit-identical over two launches, at both block sizes (B=133 runs two
    head_dim-32 robots an SM) and with a robot's heads split over a 2-block
    cluster (B <= 66)."""
    cfg, model = serving_model(device, head_dim)
    chunk, args = chunk_inputs(cfg, model, device, b, 311, "dpmpp", seed=7)
    with torch.no_grad():
        first, second = chunk.sample_kernel(*args), chunk.sample_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("S", [17, 312])
def test_chunk_kernel_block_split_matches_plain_version(S, head_dim, cluster, device):
    """A robot in one block, or its heads split over a 2-block cluster,
    whatever the batch, over an odd layer count (the cluster's two output
    buffers taken in turn across the steps)."""
    cfg, model = serving_model(device, head_dim, num_decoder_layers=3)
    chunk, args = chunk_inputs(cfg, model, device, 13, S, "dpmpp", seed=S + cluster)
    chunk.cluster_size = lambda batch, device: cluster
    with torch.no_grad():
        assert_close(chunk.sample_kernel(*args), chunk.sample_plain(*args))


@pytest.mark.parametrize("head_dim,b", [(64, 2), (32, 133)])
def test_chunk_kernel_refuses_contexts_past_its_registers(head_dim, b, device):
    """Only the 16-warp block's limit refuses a context: past the SMs at
    head_dim 32 too, where a short context runs two 8-warp blocks an SM."""
    cfg, model = serving_model(device, head_dim)
    chunk, args = chunk_inputs(cfg, model, device, b, 1024, "ddim", seed=1)
    with pytest.raises(ValueError, match="at most 1023 context tokens"):
        chunk.sample_kernel(*args)


def test_chunk_kernel_takes_long_contexts_past_the_sms(device):
    """S=600 outgrows the 8-warp block's 511 tokens: at B=133 the kernel
    then runs a robot a 16-warp block, as it does at B=64."""
    cfg, model = serving_model(device, 32)
    chunk, args = chunk_inputs(cfg, model, device, 133, 600, "ddim", seed=3)
    assert chunk.block_threads(133, 600, device) == 512
    with torch.no_grad():
        assert_close(chunk.sample_kernel(*args), chunk.sample_plain(*args))


# int8 context K/V (csrc/fused_chunk_int8.cu) at every cluster shape: R = 1,
# 2, 3, 4, 6, 8, 32 robots a block run C = 1, 2, 1, 4, 2, 8, 8 blocks of 1
# to 4 robots each; within chip_smoke.py's INT8_TOL (a quantisation flip moves
# a value by 1/127 of its range, twice a bf16 rounding step) and bit-identical
# over two launches (integer sums, fixed orders); the kernel's record of every
# (step, layer): its query scales bit for bit the block's max |q| / 127 over
# its own queries, and its int8 queries the plain quantiser's at that scale
INT8_TOL = 2 * TOL
INT8_CASES = [(32, 13, 1), (32, 24, 3), (32, 24, 6), (32, 64, 32), (64, 16, 2), (64, 16, 4),
              (64, 16, 8), (128, 16, 8), (128, 32, 32)]


@pytest.mark.parametrize("head_dim,b,robots", INT8_CASES)
def test_int8_chunk_kernel_matches_plain_version(head_dim, b, robots, device):
    cfg, model = serving_model(device, head_dim)
    sampler = FusedChunkSampler(model, block_robots=robots, context_kv_quant="int8")
    _, args = chunk_inputs(cfg, model, device, b, 311, "ddim", seed=b + robots)
    n = FusedChunkSampler.int8_launches
    with torch.no_grad():
        got = sampler.sample_kernel(*args, robots)
        again = sampler.sample_kernel(*args, robots)
        assert FusedChunkSampler.int8_launches == n + 2
        ref = sampler.sample_plain(*args, robots)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= INT8_TOL * scale, (err, scale)
    with torch.no_grad():
        _, rec = sampler.sample_int8_kernel(*args, robots, record=True)
    q2 = rec["q2"].float()
    B, T, L = rec["sq"].shape
    amax = q2.abs().amax((3, 4))
    block = int8_scale(amax.view(B // robots, robots, T, L).amax(1)).repeat_interleave(robots, 0)
    assert torch.equal(rec["sq"], block)
    assert torch.equal(rec["qq"].float(), quantise(q2, rec["sq"][..., None, None]))


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("S", [17, 311])
def test_qstat_chunk_kernel_matches_plain_version(S, head_dim, cluster, device):
    """The "qstat" numerics in one block and in a 2-block cluster."""
    cfg, model = serving_model(device, head_dim)
    chunk, args = chunk_inputs(cfg, model, device, 13, S, "dpmpp", seed=S + head_dim)
    sampler = FusedChunkSampler(model, cross_orientation="qstat")
    sampler.cluster_size = lambda batch, device: cluster
    with torch.no_grad():
        assert_close(sampler.sample_kernel(*args), sampler.sample_plain(*args))


def encoder_case(device, tokens, patch, gamestate, b=13):
    length = tokens * patch
    cfg, model = serving_model(device, 32, action_context_length=length,
                               joint_state_context_length=length, imu_context_length=length,
                               encoder_patch_size=patch, use_gamestate=gamestate,
                               num_action_history_encoder_layers=2)
    rng = np.random.default_rng(tokens + patch)
    t = lambda a: torch.from_numpy(a).to(device)
    batch = {
        "joint_command_history": t(rng.uniform(0, 6.28, (b, length, 20)).astype(np.float32)),
        "rotation": t(rng.normal(size=(b, length, cfg.imu_input_dim)).astype(np.float32)),
        "joint_state": t(rng.uniform(0, 6.28, (b, length, 20)).astype(np.float32)),
        "game_state": t(rng.integers(0, 4, (b,))),
    }
    return FusedContextEncoder(model), batch


@pytest.mark.parametrize("gamestate", [True, False])
@pytest.mark.parametrize("patch", [1, 2])
@pytest.mark.parametrize("tokens", [24, 100, 128])
def test_encoder_kernel_matches_plain_version(tokens, patch, gamestate, device):
    enc, batch = encoder_case(device, tokens, patch, gamestate)
    n = FusedContextEncoder.launches
    with torch.no_grad():
        got = enc.encode_kernel(batch)
        assert FusedContextEncoder.launches == n + 1
        assert_close(got, enc.encode_plain(batch))


def test_encoder_kernel_is_deterministic(device):
    enc, batch = encoder_case(device, 100, 1, True)
    with torch.no_grad():
        first, second = enc.encode_kernel(batch), enc.encode_kernel(batch)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ------------------------------------------- the denoiser on the chunk's pass
# One pass against the packed context K/V (pack_context_kv) at the chunk
# sampler's shapes: S = 17 / 301 / 311 / 312, head_dim 32 (E=128) and 64
# (E=256), B = 1 / 13 / 133, eps and in-kernel DDIM forms; a robot in one
# block and in a 2-block cluster over 3 layers; bit-identical over two
# launches; the context limit; the per-step sampler over 5 steps, each
# launch writing its step token into key S of the packed K/V; the pack
# kernel bit for bit the plain pack.

DDIM_COEFS = [1.3, 0.8, 0.9, 0.4]


def denoise_inputs(cfg, model, device, b, S, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    den = FusedDenoiser(model)
    H, D = den.num_heads, den.head_dim
    kv = [(t(b, S, H, D).to(torch.bfloat16), t(b, S, H, D).to(torch.bfloat16))
          for _ in range(cfg.num_decoder_layers)]
    stk, stv = den.step_tables(t(5, cfg.hidden_dim))
    return den, den.pack_context_kv(kv), t(b, 10, 20), stk, stv


@pytest.mark.parametrize("b", [1, 13])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("S", [0, 17, 31, 301, 311, 312])
def test_pack_kernel_is_the_plain_pack(S, head_dim, b, device):
    cfg, model = serving_model(device, head_dim)
    rng = np.random.default_rng(S * b)
    den = FusedDenoiser(model)
    kv = [tuple(torch.from_numpy(rng.normal(size=(b, S, den.num_heads, head_dim)).astype(
        np.float32)).to(device, torch.bfloat16) for _ in range(2))
        for _ in range(cfg.num_decoder_layers)]
    n = FusedDenoiser.pack_launches
    got = den.pack_kernel(kv)
    assert FusedDenoiser.pack_launches == n + cfg.num_decoder_layers
    ref = den.pack_plain(kv)
    assert got.context_len == S and torch.equal(got.kv, ref.kv)


@pytest.mark.parametrize("coefs", [None, DDIM_COEFS], ids=["eps", "ddim"])
@pytest.mark.parametrize("b", [1, 13, 133])
@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("S", [0, 17, 301, 311, 312])
def test_denoise_kernel_matches_plain_version(S, head_dim, b, coefs, device):
    cfg, model = serving_model(device, head_dim)
    den, packed, noisy, stk, stv = denoise_inputs(cfg, model, device, b, S, seed=S + b)
    n = FusedDenoiser.launches
    with torch.no_grad():
        got = den.run_kernel(packed, noisy, stk[2], stv[2], coefs)
        assert FusedDenoiser.launches == n + 1
        assert_close(got, den.run_plain(packed, noisy, stk[2], stv[2], coefs))


@pytest.mark.parametrize("coefs", [None, DDIM_COEFS], ids=["eps", "ddim"])
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("head_dim", [32, 64])
def test_denoise_kernel_block_split_matches_plain_version(head_dim, cluster, coefs, device):
    """A robot in one block, or its heads split over a 2-block cluster, over
    an odd layer count (the cluster's two output buffers taken in turn)."""
    cfg, model = serving_model(device, head_dim, num_decoder_layers=3)
    den, packed, noisy, stk, stv = denoise_inputs(cfg, model, device, 13, 301, seed=cluster)
    den.cluster_size = lambda batch, device: cluster
    with torch.no_grad():
        assert_close(den.run_kernel(packed, noisy, stk[0], stv[0], coefs),
                     den.run_plain(packed, noisy, stk[0], stv[0], coefs))


@pytest.mark.parametrize("head_dim,b", [(32, 13), (32, 64), (32, 133), (64, 13), (64, 133),
                                        (128, 13), (128, 64)])
def test_denoise_kernel_is_deterministic(head_dim, b, device):
    cfg, model = serving_model(device, head_dim)
    den, packed, noisy, stk, stv = denoise_inputs(cfg, model, device, b, 311, seed=9)
    with torch.no_grad():
        first = den.run_kernel(packed, noisy, stk[1], stv[1], DDIM_COEFS)
        second = den.run_kernel(packed, noisy, stk[1], stv[1], DDIM_COEFS)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("head_dim,b", [(64, 2), (32, 133)])
def test_denoise_kernel_refuses_contexts_past_its_registers(head_dim, b, device):
    """The pack kernel and the denoiser both refuse S=1024 (a 16-warp
    block's 32-key chunks hold 1023 keys and the step token)."""
    cfg, model = serving_model(device, head_dim)
    den = FusedDenoiser(model)
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    kv = [(t(b, 1024, den.num_heads, head_dim).to(torch.bfloat16),
           t(b, 1024, den.num_heads, head_dim).to(torch.bfloat16))
          for _ in range(cfg.num_decoder_layers)]
    stk, stv = den.step_tables(t(1, cfg.hidden_dim))
    with pytest.raises(ValueError, match="at most 1023 context tokens"):
        den.pack_context_kv(kv)
    with pytest.raises(ValueError, match="at most 1023 context tokens"):
        den.run_kernel(den.pack_plain(kv), t(b, 10, 20), stk[0], stv[0])


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_denoise_per_step_sampler_matches_plain_version(head_dim, device):
    """FusedDenoiser.sample over 5 DDIM steps, one launch a step, against
    the same loop over the plain pass; each launch rewrites key S of the
    packed K/V with its step's token (the last step's is left there)."""
    from soccerdiffusion_tpu_torch.ops.fused_denoise import kfrag, vfrag

    cfg, model = serving_model(device, head_dim)
    den, packed, noisy, _, _ = denoise_inputs(cfg, model, device, 13, 301, seed=4)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(5, cfg.hidden_dim)).astype(np.float32)).to(device)
    plain = copy.copy(den)
    plain.run = plain.run_plain
    n = FusedDenoiser.launches
    with torch.no_grad():
        got = den.sample(packed, noisy, table, make_schedule(100), 5)
        assert FusedDenoiser.launches == n + 5
        assert_close(got, plain.sample(packed, noisy, table, make_schedule(100), 5))
        stk, stv = den.step_tables(table)
    S, H, D = 301, den.num_heads, den.head_dim
    d = torch.arange(D)
    for l in range(cfg.num_decoder_layers):
        for h in range(H):
            assert torch.equal(packed.kv[:, l, h, 0, kfrag(S, d, D)],
                               stk[4, l, h * D:(h + 1) * D].expand(13, D))
            assert torch.equal(packed.kv[:, l, h, 1, vfrag(S, d, D)],
                               stv[4, l, h * D:(h + 1) * D].expand(13, D))


# ------------------------------- head_dim 128: larger_model.yaml's decoder
# The decoder kernels' head_dim-128 instances (hidden 512, 4 heads:
# csrc/decoder_pass.cuh's plan of its own, 8-warp blocks, the K / V in 32-key
# chunks) against their plain versions: the chunk sampler over S = 17 / 311
# / 312, B = 1 / 13 / 64 (a 2-block cluster) / 133, DDIM and DPM-Solver++;
# the denoiser at the same shapes in its eps and DDIM forms; a robot in one
# block and in a cluster over 3 and 8 layers; the context limit (383
# tokens: the ring's 12 chunks hold a head's whole K) and S = 383 itself.
# The pack, the determinism over two launches and the per-step sampler are
# cases of the tests above.

@pytest.mark.parametrize("b", [1, 13, 64, 133])
@pytest.mark.parametrize("solver", ["ddim", "dpmpp"])
@pytest.mark.parametrize("S", [17, 311, 312])
def test_chunk_kernel_head_dim_128_matches_plain_version(S, solver, b, device):
    test_chunk_kernel_matches_plain_version(S, 128, solver, b, device)


@pytest.mark.parametrize("coefs", [None, DDIM_COEFS], ids=["eps", "ddim"])
@pytest.mark.parametrize("b", [1, 13, 64, 133])
@pytest.mark.parametrize("S", [17, 311, 312])
def test_denoise_kernel_head_dim_128_matches_plain_version(S, b, coefs, device):
    test_denoise_kernel_matches_plain_version(S, 128, b, coefs, device)


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("layers", [3, 8])
def test_head_dim_128_block_split_matches_plain_version(layers, cluster, device):
    """A robot in one block or its heads split over a 2-block cluster, over
    3 layers (the cluster's output buffers in turn) and larger_model's 8."""
    cfg, model = serving_model(device, 128, num_decoder_layers=layers)
    chunk, args = chunk_inputs(cfg, model, device, 13, 311, "dpmpp", seed=layers + cluster)
    den, packed, noisy, stk, stv = denoise_inputs(cfg, model, device, 13, 311, seed=cluster)
    chunk.cluster_size = den.cluster_size = lambda batch, device: cluster
    with torch.no_grad():
        assert_close(chunk.sample_kernel(*args), chunk.sample_plain(*args))
        for coefs in (None, DDIM_COEFS):
            assert_close(den.run_kernel(packed, noisy, stk[0], stv[0], coefs),
                         den.run_plain(packed, noisy, stk[0], stv[0], coefs))


def test_head_dim_128_context_limit(device):
    """S = 383 (12 chunks with the step token) runs; S = 384 is refused by
    the chunk sampler, the pack and the denoiser."""
    cfg, model = serving_model(device, 128)
    chunk, args = chunk_inputs(cfg, model, device, 5, 383, "ddim", seed=2)
    den, packed, noisy, stk, stv = denoise_inputs(cfg, model, device, 5, 383, seed=3)
    with torch.no_grad():
        assert_close(chunk.sample_kernel(*args), chunk.sample_plain(*args))
        assert_close(den.run_kernel(packed, noisy, stk[0], stv[0]),
                     den.run_plain(packed, noisy, stk[0], stv[0]))
    chunk, args = chunk_inputs(cfg, model, device, 5, 384, "ddim", seed=2)
    with pytest.raises(ValueError, match="at most 383 context tokens"):
        chunk.sample_kernel(*args)
    kv = [(args[0].view(5, 384, 4, 128), args[0].view(5, 384, 4, 128))] * cfg.num_decoder_layers
    with pytest.raises(ValueError, match="at most 383 context tokens"):
        den.pack_context_kv(kv)
    with pytest.raises(ValueError, match="at most 383 context tokens"):
        den.run_kernel(den.pack_plain(kv), noisy, stk[0], stv[0])


@pytest.mark.parametrize("head_dim,layers,b,most", [(32, 4, 1, 639), (64, 4, 1, 415),
                                                     (64, 4, 100, 447), (64, 8, 100, 351)])
def test_decoder_kernels_at_their_shared_memory_limit(head_dim, layers, b, most, device):
    """At the most context tokens check_kernel_shapes lets through (B=1: a
    2-block cluster; B=100: a block a robot), the chunk sampler, the pack
    and the denoiser launch and match their plain versions; one 32-key
    block past it all three raise ValueError, before any launch."""
    cfg, model = serving_model(device, head_dim, num_decoder_layers=layers)
    chunk, args = chunk_inputs(cfg, model, device, b, most, "ddim", seed=most)
    den, packed, noisy, stk, stv = denoise_inputs(cfg, model, device, b, most, seed=most)
    with torch.no_grad():
        assert_close(chunk.sample_kernel(*args), chunk.sample_plain(*args))
        assert_close(den.run_kernel(packed, noisy, stk[0], stv[0]),
                     den.run_plain(packed, noisy, stk[0], stv[0]))
    counts = (FusedChunkSampler.launches, FusedDenoiser.launches, FusedDenoiser.pack_launches)
    chunk, args = chunk_inputs(cfg, model, device, b, most + 32, "ddim", seed=1)
    kv = [(t.view(b, most + 32, den.num_heads, den.head_dim),) * 2
          for t in [args[0]] * layers]
    for run in (lambda: chunk.sample_kernel(*args), lambda: den.pack_context_kv(kv),
                lambda: den.run_kernel(den.pack_plain(kv), noisy, stk[0], stv[0])):
        with pytest.raises(ValueError, match=f"at most {most} context tokens there"):
            run()
    assert counts == (FusedChunkSampler.launches, FusedDenoiser.launches,
                      FusedDenoiser.pack_launches)


# ------------------------------------------------ the ResNet / Swin encoders

@pytest.mark.parametrize("kind,remat", [("resnet18", False), ("resnet18", "conv_only"),
                                        ("resnet50", True), ("swin_transformer_tiny", True)])
def test_image_encoders_on_the_card_match_the_cpu(kind, remat, device):
    """Train mode (output, input and weight gradients, the updated running
    statistics) and then eval mode, float64 on the card against the CPU."""
    res = 224 if kind.startswith("swin") else 64
    cpu = make_image_encoder(kind, 32, res, use_final_avgpool=False, dtype=torch.float64,
                             remat=remat).double()
    load_jax_params(cpu, *random_jax_params(cpu, seed=3))
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, res, res, 3)))
    dy = torch.from_numpy(rng.normal(size=(2, 32)))
    results = []
    for enc, dev in ((cpu, "cpu"), (gpu, device)):
        enc.train()
        xt = x.detach().to(dev).requires_grad_(True)  # a leaf on each device
        out = enc(xt)
        (out * dy.to(dev)).sum().backward()
        enc.eval()
        with torch.no_grad():
            evaluated = enc(x.to(dev))
        stats = [t for m in enc.modules() if isinstance(m, BatchNorm) for t in (m.mean, m.var)]
        results.append([out, xt.grad, evaluated, *[p.grad for p in enc.parameters()], *stats])
    for got, ref in zip(results[1], results[0]):
        got, ref = got.detach().cpu(), ref.detach()
        assert (got - ref).abs().max().item() <= 1e-9 * max(ref.abs().max().item(), 1e-30)

