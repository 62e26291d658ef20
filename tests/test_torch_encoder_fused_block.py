"""``encoder_fused_block: true``: the three proprioceptive stacks run each
layer as one fused ViT block (ops/fused_vit_block.py, exact GELU), against
the JAX policy with the same config (its FusedTransformerEncoderLayer, the
Pallas block in interpret mode), both filled from one flax parameter tree
(utils/jax_params.load_jax_params, which takes the tree unchanged).

Float32, the SMALL configuration (hidden 64, 12-token stacks of one layer,
2 decoder layers), B=3: the eps prediction within 2e-5 absolute (float32
summation order, as tests/test_torch_jax_params.py), and the gradient of
sum(eps * W) for every parameter within TOL = 1e-4 of its own scale; the
key biases, whose gradient is zero in exact arithmetic, within TOL of the
largest gradient of the model instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.models.transformer import FusedTransformerEncoderLayer
from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb
from soccerdiffusion_tpu_torch.utils.jax_params import flax_parameters, load_jax_params
from tests.test_torch_jax_params import F32_ATOL, SMALL, make_batch, port_config, to_jax, to_torch

B, TOL = 3, 1e-4
FUSED = dataclasses.replace(SMALL, encoder_fused_block=True)


def setup():
    rng = np.random.default_rng(4)
    batch = make_batch(FUSED, B, rng)
    noisy = rng.standard_normal((B, FUSED.trajectory_prediction_length,
                                 FUSED.num_joints)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    jmodel = JaxPolicy(FUSED)
    variables = jmodel.init(jax.random.key(0), to_jax(batch), jnp.asarray(noisy), jnp.asarray(t))
    params = jax.tree.map(np.asarray, variables["params"])
    model = load_jax_params(DiffusionPolicy(port_config(FUSED)), params, {})
    return jmodel, variables, model, batch, noisy, t


def test_proprio_stacks_run_the_fused_block():
    """Every layer of the three proprioceptive stacks is a fused ViT block
    on exact GELU; the same config with the fused stack on runs the stack
    (it wins, as in the JAX package); the image path is not involved."""
    model = DiffusionPolicy(port_config(FUSED))
    stacks = [model.action_history_encoder, model.imu_encoder, model.joint_states_encoder]
    for enc in stacks:
        layers = enc.seq.encoder.layers
        assert layers and all(isinstance(l, FusedTransformerEncoderLayer) and l.gelu == "exact"
                              for l in layers)
    both = DiffusionPolicy(port_config(FUSED, encoder_fused_stack=True))
    assert all(enc.seq.encoder.fused_stack for enc in
               (both.action_history_encoder, both.imu_encoder, both.joint_states_encoder))
    # the parameter tree is the unfused one's
    plain = DiffusionPolicy(port_config(SMALL))
    assert model.state_dict().keys() == plain.state_dict().keys()


def test_fused_block_policy_forward_and_gradients_match_jax():
    jmodel, variables, model, batch, noisy, t = setup()
    w = np.random.default_rng(9).standard_normal(noisy.shape).astype(np.float32)

    def loss(params):
        out = jmodel.apply({**variables, "params": params}, to_jax(batch), jnp.asarray(noisy),
                           jnp.asarray(t), False)
        return jnp.sum(out * w), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    launches = (fvb.forward_kernel.launches, fvb.backward_kernel.launches)
    out = model(to_torch(batch), torch.from_numpy(noisy), torch.from_numpy(t.astype(np.int64)))
    (out * torch.from_numpy(w)).sum().backward()
    assert (fvb.forward_kernel.launches, fvb.backward_kernel.launches) == launches  # CPU: plain
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0)
    want = flax_parameters(model, jax.tree.map(np.asarray, grads))
    got = dict(model.named_parameters())
    assert want.keys() == got.keys()
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        diff = float((got[name].grad - g).abs().max())
        bound = TOL * (top if name.endswith("k_proj.bias") else float(g.abs().max()))
        assert diff <= bound, (name, diff, bound)
