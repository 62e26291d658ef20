"""Plain version of the port's FusedContextEncoder (the CPU path of
ops/fused_encoder.py) against the JAX FusedContextEncoder in interpret mode
and against the JAX encode_context, float32. Tolerance: float32 summation
order through two encoder layers (2e-5 absolute at unit-scale outputs)."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.ops.fused_encoder import FusedContextEncoder as JaxFusedEncoder
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from tests.test_torch_jax_params import (F32_ATOL, SMALL, build_pair, make_batch, port_config,
                                         to_jax, to_torch)


@pytest.mark.parametrize("patch,imu_method,gamestate", [
    (1, "quaternion", True),
    (2, "five_dim", True),
    (2, "quaternion", False),
])
def test_plain_matches_jax_kernel_and_encode_context(patch, imu_method, gamestate):
    cfg = ModelConfig(**{**SMALL.__dict__, "encoder_patch_size": patch,
                         "imu_orientation_embedding_method": imu_method,
                         "use_gamestate": gamestate,
                         "num_action_history_encoder_layers": 2})
    jmodel, variables, model, batch, _ = build_pair(cfg, b=4)
    ref = np.asarray(jmodel.apply(variables, to_jax(batch), False, method=jmodel.encode_context))
    ref_kernel = np.asarray(JaxFusedEncoder(jmodel, variables["params"], interpret=True,
                                            block_robots=2).encode(to_jax(batch)))
    before = FusedContextEncoder.launches
    with torch.no_grad():
        got = FusedContextEncoder(model).encode(to_torch(batch)).numpy()
    assert FusedContextEncoder.launches == before  # CPU tensors take the plain version
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref_kernel, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


def test_bf16_plain_close_to_float32():
    """bf16 weights and roundings stay within bf16 error of the float32 path
    (0.1 absolute: a few bf16 ulps at the context's |x| <= ~8)."""
    cfg16 = ModelConfig(**{**SMALL.__dict__, "compute_dtype": "bfloat16"})
    _, variables, model16, batch, _ = build_pair(cfg16, b=2)
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils import load_jax_params

    model32 = load_jax_params(DiffusionPolicy(port_config(SMALL)), jax.tree.map(np.asarray, variables["params"]))
    with torch.no_grad():
        got16 = FusedContextEncoder(model16).encode(to_torch(batch))
        got32 = FusedContextEncoder(model32).encode(to_torch(batch))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), got32.numpy(), atol=0.1, rtol=0)


@pytest.mark.parametrize("patch,imu_method", [(1, "quaternion"), (2, "five_dim")])
def test_kernel_weights_hold_the_plain_weights(patch, imu_method):
    """The layouts the CUDA kernel reads (transposed Dense kernels, the
    patch-conv kernel transposed with zero columns up to a multiple of 8) are
    a permutation of the plain version's weights: the plain context from the
    unpacked tensors is the plain context, bit for bit."""
    cfg = ModelConfig(**{**SMALL.__dict__, "encoder_patch_size": patch,
                         "imu_orientation_embedding_method": imu_method,
                         "num_action_history_encoder_layers": 2})
    torch.manual_seed(0)
    enc = FusedContextEncoder(DiffusionPolicy(port_config(cfg)))
    t = lambda w: w.transpose(-1, -2)
    stacks = []
    for st, (emb_t, emb_b, pos, qkv_t, qkv_b, o_t, o_b, ln_s, ln_b, m1_t, m1_b, m2_t, m2_b) in zip(
            enc.stacks, enc.kernel_weights):
        assert emb_t.shape[1] == st.in_pad and st.in_pad % 8 == 0
        assert not emb_t[:, st.in_dim:].any()
        stacks.append(dataclasses.replace(
            st, emb_w=t(emb_t[:, : st.in_dim]), emb_b=emb_b, pos=pos, qkv_w=t(qkv_t), qkv_b=qkv_b,
            o_w=t(o_t), o_b=o_b, ln_s=ln_s, ln_b=ln_b, m1_w=t(m1_t), m1_b=m1_b, m2_w=t(m2_t),
            m2_b=m2_b))
    unpacked = copy.copy(enc)
    unpacked.stacks = stacks
    batch = to_torch(make_batch(cfg, 3, np.random.default_rng(4)))
    with torch.no_grad():
        assert torch.equal(unpacked.encode_plain(batch), enc.encode_plain(batch))
