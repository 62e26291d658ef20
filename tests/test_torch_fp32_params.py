"""Float32 master parameters.

The JAX package keeps float32 params and casts them to the compute dtype at
use. The port once stored every parameter in the compute dtype, which would
make AdamW update bf16 weights and round every weight gradient to bf16.
Now the parameters stay float32; a bf16 model serves exactly the outputs of
a model whose weights were rounded to bf16 up front; and a weight gradient
from the fused ops reaches its float32 parameter unrounded.
"""

import copy
import dataclasses

import numpy as np
import torch

from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import decoder_layer
from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import encoder_stack
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

from tests.test_torch_jax_params import SMALL, make_batch, port_config, to_torch

BF16 = port_config(SMALL, compute_dtype="bfloat16")


def models():
    model = DiffusionPolicy(BF16)
    model = load_jax_params(model, random_jax_params(model, seed=5))
    rounded = copy.deepcopy(model)
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    return model, rounded


def test_parameters_are_float32_in_bf16_compute():
    model, _ = models()
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert DiffusionPolicy(dataclasses.replace(BF16, encoder_fused_stack=True,
                                               decoder_fused_block=True)).step_encoding.token.dtype == torch.float32


def test_bf16_serving_is_bit_identical_to_rounded_weights():
    rng = np.random.default_rng(0)
    batch = to_torch(make_batch(BF16, 3, rng))
    noise = torch.from_numpy(rng.normal(size=(3, 5, 6)).astype(np.float32))
    outs = []
    for m in models():
        with torch.no_grad():
            ctx = FusedContextEncoder(m).encode_plain(batch)
            chunk = FusedChunkSampler(m)
            ts = ddim_timesteps(100, 3)
            stk, stv = chunk.step_tables(m.step_encoding(torch.as_tensor(ts.astype(np.int64)))[:, 0])
            sampled = chunk.sample_plain(ctx, noise, stk, stv, solver_coef_table(make_schedule(100), 3, "ddim"))
            eps = chunk.run_plain(chunk.pack_context_kv(m.precompute_context_kv(ctx)), noise, stk[0], stv[0])
            engine = RolloutEngine(m, make_schedule(100), Normalizer.identity(6), num_inference_steps=3,
                                   fused="chunk", fused_encoder=True, device="cpu")
            _, executed = engine.replan_period(engine.init(3, torch.Generator().manual_seed(0)), noise)
        outs.append((ctx, sampled, eps, executed))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


class _Float32Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        return w.float()

    @staticmethod
    def backward(ctx, g):
        return torch.full(g.shape, 2.001)


def test_autograd_rounds_a_float32_grad_of_a_bf16_input():
    """The fault the float32 masters avoid: a Function whose input is bf16
    has its float32 gradient rounded to bf16 (a JAX custom_vjp passes it on)."""
    w = torch.ones(1, dtype=torch.bfloat16, requires_grad=True)
    _Float32Grad.apply(w).sum().backward()
    assert w.grad.dtype == torch.bfloat16 and w.grad.item() == 2.0
    w32 = torch.ones(1, requires_grad=True)
    _Float32Grad.apply(w32).sum().backward()
    assert w32.grad.item() == np.float32(2.001)


def test_weight_gradient_reaches_the_float32_param_unrounded():
    """The fused ops take the float32 masters and cast inside, so a weight
    gradient keeps the digits a bf16 value would drop."""
    torch.manual_seed(0)
    E, H = 64, 2
    scale = torch.ones(1, E, requires_grad=True)  # the encoder stack's g1, one layer
    others = [torch.zeros(1, E), torch.randn(1, E, 3 * E) * 0.1, torch.zeros(1, 3 * E),
              torch.randn(1, E, E) * 0.1, torch.zeros(1, E), torch.ones(1, E), torch.zeros(1, E),
              torch.randn(1, E, E) * 0.1, torch.zeros(1, E), torch.randn(1, E, E) * 0.1,
              torch.zeros(1, E)]
    x = torch.randn(2, 5, E).to(torch.bfloat16)
    encoder_stack(x, [scale, *others], H).float().sum().backward()
    grad = scale.grad
    assert grad.dtype == torch.float32
    assert not torch.equal(grad, grad.to(torch.bfloat16).float())  # digits beyond bf16 survive

    layer = DiffusionPolicy(dataclasses.replace(BF16, decoder_fused_block=True)) \
        .diffusion_action_generator.decoder.layers[0]
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import layer_weights

    w = layer_weights(layer)
    xs, mem = torch.randn(2, 5, E).to(torch.bfloat16), torch.randn(2, 9, E).to(torch.bfloat16)
    decoder_layer(xs, mem, w, 4).float().sum().backward()
    g = layer.mlp.linear2.weight.grad
    assert g.dtype == torch.float32 and not torch.equal(g, g.to(torch.bfloat16).float())
