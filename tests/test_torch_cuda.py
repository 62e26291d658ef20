"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes off the serving path (patch 2, five-dim IMU, no game state, short
contexts, 5-step chunks, a batch that is no multiple of anything).

Needs an NVIDIA GPU and nvcc; skipped elsewhere. JAX-free, so it runs on a
machine without jax: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance: max |kernel - plain| <= 2e-2 x max |plain| (both round to bf16 at
the same points; see chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
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
