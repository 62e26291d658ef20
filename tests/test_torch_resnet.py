"""The port's ResNet18 / ResNet50 image encoders (models/vision.py) against
flax's ResNetImageEncoder at 64 px (a 2x2 final map, so the spatial head's
(h, w, c) flatten order matters), both heads: the eval-mode output on the
same batch_stats (float32); the train-mode output, the updated running
statistics and the input and weight gradients against jax.value_and_grad
(float64 on both sides); the remat modes (True, "conv_only") against no
remat (float32).

Params and running statistics come from random_jax_params (the flax
layout, seeded), inputs from numpy with a seed. Tolerances: the eval
output within 1e-4 of its largest magnitude (float32 summation order
through 20-53 conv / BatchNorm layers); the float64 comparisons within
1e-9 of each tensor's largest magnitude. Train mode is compared in float64
(jax.enable_x64, the port's encoder built with dtype float64) because in
float32 it is ill-conditioned at this size: BatchNorm over the 8 values a
channel holds at the 2x2 final map divides rounding by small batch
deviations, and a ReLU whose input lies within rounding of 0 takes either
side, so either package's float32 train-mode output and gradients stray
0.3-0.6% from the float64 ones at some seeds and batch sizes (measured);
a float32 comparison could not tell a wrong function from that. The remat
modes rerun the same CPU ops in the same order: their gradients and
statistics are compared exactly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.models.vision import ResNetImageEncoder as JaxResNet
from soccerdiffusion_tpu_torch.models.layers import BatchNorm
from soccerdiffusion_tpu_torch.models.vision import ResNetImageEncoder, make_image_encoder
from soccerdiffusion_tpu_torch.utils.jax_params import (
    _flatten,
    load_jax_params,
    random_jax_params,
)

HIDDEN, RES, N = 16, 64, 2
REL_TOL, F64_TOL = 1e-4, 1e-9
STAGES = {"resnet18": ((2, 2, 2, 2), False), "resnet50": ((3, 4, 6, 3), True)}
CASES = [(kind, avgpool) for kind in STAGES for avgpool in (True, False)]
IDS = [f"{kind}-{'avgpool' if a else 'spatial'}" for kind, a in CASES]


def close(got, want, rel=REL_TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0, err_msg=what)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """For one (kind, head): the JAX encoder's float32 eval output, and in
    float64 its train-mode output, updated statistics and gradients; the
    port encoder (float32) loaded with the same variables."""
    kind, avgpool = request.param
    stages, bottleneck = STAGES[kind]
    rng = np.random.default_rng(len(stages) * 10 + avgpool)
    x = rng.standard_normal((N, RES, RES, 3)).astype(np.float32)
    dy = rng.standard_normal((N, HIDDEN)).astype(np.float32)
    enc = make_image_encoder(kind, HIDDEN, RES, use_final_avgpool=avgpool)
    params, stats = random_jax_params(enc, seed=len(stages) + avgpool)
    load_jax_params(enc, params, stats)
    jmodel = JaxResNet(HIDDEN, stages, bottleneck, use_final_avgpool=avgpool)
    eval_out = jax.jit(lambda v, xx: jmodel.apply(v, xx, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with jax.enable_x64(True):
        j64 = JaxResNet(HIDDEN, stages, bottleneck, use_final_avgpool=avgpool, dtype=jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)

        def loss(p, xx):
            out, mutated = j64.apply({"params": p, "batch_stats": f64(stats)}, xx, True,
                                     mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(dy, jnp.float64)), (out, mutated["batch_stats"])

        (_, (train_out, new_stats)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(f64(params), jnp.asarray(x, jnp.float64))
        np64 = lambda t: jax.tree.map(np.asarray, t)
        train_out, new_stats, gp, gx = np64(train_out), np64(new_stats), np64(gp), np64(gx)
    return dict(kind=kind, avgpool=avgpool, x=x, dy=dy, params=params, stats=stats, enc=enc,
                eval_out=np.asarray(eval_out), train_out=train_out, new_stats=new_stats,
                grads=gp, dx=gx)


def stats_tree(enc):
    """The port encoder's running statistics as a flat flax-path dict."""
    return {f"{name.replace('.', '/')}/{leaf}": getattr(m, leaf).detach().numpy()
            for name, m in enc.named_modules() if isinstance(m, BatchNorm)
            for leaf in ("mean", "var")}


def train_step(enc, x, dy, dtype=torch.float32):
    """One train-mode forward and backward: (output, dx, {param: grad})."""
    enc.train()
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = enc(xt)
    (out * torch.from_numpy(dy).to(dtype)).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in enc.named_parameters()}
    return out.detach(), xt.grad.detach(), grads


def test_eval_output_matches_flax(case):
    enc = case["enc"].eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(case["x"])).numpy()
    close(got, case["eval_out"])
    assert isinstance(enc, ResNetImageEncoder)


def float64_step(case):
    """The port encoder in float64 on the case's variables: one train-mode
    forward and backward (output, dx, grads) and the encoder after it."""
    enc = make_image_encoder(case["kind"], HIDDEN, RES, use_final_avgpool=case["avgpool"],
                             dtype=torch.float64).double()
    load_jax_params(enc, case["params"], case["stats"])
    return (*train_step(enc, case["x"], case["dy"], torch.float64), enc)


def test_train_output_and_running_stats_match_flax(case):
    out, _, _, enc = float64_step(case)
    close(out.numpy(), case["train_out"], F64_TOL, "train-mode output")
    want = _flatten(case["new_stats"])
    got = stats_tree(enc)
    assert got.keys() == want.keys()
    for key, value in want.items():  # 0.9 ra + 0.1 * the biased batch variance
        close(got[key], value, F64_TOL, key)


def test_gradients_match_jax_grad(case):
    _, dx, grads, _ = float64_step(case)
    close(dx.numpy(), case["dx"], F64_TOL, "dx")
    flat = _flatten(case["grads"])
    assert len(grads) == len(flat)
    for name, g in grads.items():
        module, attr = name.rsplit(".", 1)
        is_bn = isinstance(dict(case["enc"].named_modules())[module], BatchNorm)
        leaf = flat[module.replace(".", "/") + "/" + {"bias": "bias", "weight": "scale" if is_bn
                                                      else "kernel"}[attr]]
        want = leaf.T if g.ndim == 2 else (leaf.transpose(3, 2, 0, 1) if g.ndim == 4 else leaf)
        close(g.numpy(), want, F64_TOL, name)


@pytest.mark.parametrize("remat", [True, "conv_only"])
def test_remat_gives_the_same_step(case, remat):
    """remat_image_encoder True / "conv_only": the same output, input and
    weight gradients, and the running statistics updated exactly once."""
    base = copy.deepcopy(case["enc"])
    want_out, want_dx, want_grads = train_step(base, case["x"], case["dy"])
    enc = make_image_encoder(case["kind"], HIDDEN, RES, use_final_avgpool=case["avgpool"],
                             remat=remat)
    load_jax_params(enc, case["params"], case["stats"])
    out, dx, grads = train_step(enc, case["x"], case["dy"])
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    torch.testing.assert_close(dx, want_dx, atol=0, rtol=0)
    for name, g in grads.items():
        torch.testing.assert_close(g, want_grads[name], atol=0, rtol=0, msg=name)
    want_stats = stats_tree(base)
    for key, value in stats_tree(enc).items():
        np.testing.assert_array_equal(value, want_stats[key], err_msg=key)
