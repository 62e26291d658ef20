"""The port's evaluation/ against the JAX package's, float32 on the CPU, on
the "vision" dummy task at the size of ``examples/quality_ledger.py --fast
--vision`` (hidden 32, one layer each, 20-step contexts, a depth-1 ViT over
32 px frames, T=50): the same flax-initialised weights in both packages,
the same windows (the numpy streams), and the JAX package's own noise
handed to the port through ``noise_fn``.

Tolerances: trajectories within 1e-4 of their scale (max |x|, at least 1:
float32 summation order over a few denoiser passes); every reported number
within 1e-4 relative or 1e-6 absolute; the oracle (numpy on both sides)
within 1e-6 relative, or equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.data import WindowedDataset as JaxWindowed
from soccerdiffusion_tpu.data.dummy import generate_dummy_arrays as jax_dummy
from soccerdiffusion_tpu.data.normalizer import Normalizer as JaxNormalizer
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.diffusion import solver_label as jax_solver_label
from soccerdiffusion_tpu.evaluation import divergence as jdiv
from soccerdiffusion_tpu.evaluation import openloop as jopen
from soccerdiffusion_tpu.evaluation import oracle as joracle
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_label
from soccerdiffusion_tpu_torch.evaluation import divergence, openloop, oracle
from tests.test_torch_jax_params import build_pair, port_config, to_jax
from tests.test_torch_rollout import jax_noise

RTOL, ATOL = 1e-4, 1e-6
T_TRAIN, STEPS, WINDOWS, BATCH, CHUNKS = 50, 5, 16, 8, 2

# examples/quality_ledger.py --fast --vision
FAST_VISION = ModelConfig(
    num_joints=20, hidden_dim=32, trajectory_prediction_length=10, action_context_length=20,
    joint_state_context_length=20, imu_context_length=20, num_action_history_encoder_layers=1,
    num_imu_encoder_layers=1, joint_state_encoder_layers=1, num_decoder_layers=1,
    use_images=True, use_gamestate=True, image_encoder_type="vit",
    image_sequence_encoder_type="transformer", num_image_sequence_encoder_layers=1,
    image_context_length=2, image_resolution=32, vit_patch_size=8, vit_width=32, vit_depth=1,
    encoder_patch_size=1)


class JitPolicy(JaxPolicy):
    """The JAX policy with each ``apply`` jitted per method and per value of
    its Python-scalar arguments: the JAX evaluation functions apply the
    model op by op, which takes most of these tests' time on the CPU.
    Inside a trace (the JAX rollout engine's jitted period) the jitted
    apply is inlined."""

    def apply(self, variables, *args, method=None, **kwargs):
        if kwargs or method is None:
            return super().apply(variables, *args, method=method, **kwargs)
        static = {i: a for i, a in enumerate(args) if isinstance(a, (bool, int, float, str))}
        key = (self, method.__name__, tuple(static.items()))
        if key not in _JITTED:
            name, n = method.__name__, len(args)

            def run(v, *dynamic):
                it = iter(dynamic)
                full = [static[i] if i in static else next(it) for i in range(n)]
                return JaxPolicy.apply(self, v, *full, method=getattr(self, name))

            _JITTED[key] = jax.jit(run)
        return _JITTED[key](variables, *[a for i, a in enumerate(args) if i not in static])


_JITTED: dict = {}


def datasets(cfg=FAST_VISION, task="vision", num_samples=300):
    """The same dummy recordings windowed by each package: (jax, port)."""
    kw = dict(num_recordings=2, num_samples=num_samples, num_joints=cfg.num_joints,
              with_images=cfg.use_images, image_size=cfg.image_resolution, seed=0, task=task)
    return (JaxWindowed.from_dummy(jax_dummy(**kw), cfg),
            WindowedDataset.from_dummy(generate_dummy_arrays(**kw), port_config(cfg)))


def normalizers(j=20):
    """A non-trivial normaliser in both packages (mean pi, std 0.5)."""
    mean, std = np.full(j, np.pi, np.float32), np.full(j, 0.5, np.float32)
    return (JaxNormalizer(mean=jnp.asarray(mean), std=jnp.asarray(std)),
            Normalizer(mean=torch.from_numpy(mean), std=torch.from_numpy(std)))


def pair(seed=0, cfg=FAST_VISION):
    """(jitted jax model, jax variables, port model) from flax's init at ``seed``."""
    _, variables, model, _, _ = build_pair(cfg, b=2, seed=seed)
    return JitPolicy(cfg), variables, model


def jax_noise_fn(cfg=FAST_VISION):
    """The JAX package's noise for a port ``noise_fn``: a (B, P, J) stream is
    ``normal(key(stream_seed))``; a (periods, B, P, J) stream is the JAX
    rollout engine's per-period draws from ``key(stream_seed)``."""
    def noise_fn(stream_seed, shape):
        if len(shape) == 4:
            draws = jax_noise(cfg, jax.random.key(stream_seed), shape[0], b=shape[1])
            return torch.from_numpy(np.stack(draws))
        return torch.from_numpy(np.array(jax.random.normal(jax.random.key(stream_seed), shape,
                                                           jnp.float32)))

    return noise_fn


def assert_close(got, want, path="result"):
    """Every number of ``got`` within RTOL relative or ATOL absolute of
    ``want``; the same keys, strings and lengths."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(want, bool):
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert abs(got - want) <= max(ATOL, RTOL * abs(want)), f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.fixture(scope="module")
def setup():
    jds, ds = datasets()
    jnorm, norm = normalizers()
    jmodel, jvars, model = pair(0)
    _, svars, student = pair(1)
    return dict(jds=jds, ds=ds, jnorm=jnorm, norm=norm, jmodel=jmodel, jvars=jvars, model=model,
                svars=svars, student=student,
                indices=openloop.held_out_indices(len(ds), WINDOWS, 0))


def test_windows_and_indices_match_jax(setup):
    jds, ds = setup["jds"], setup["ds"]
    assert len(jds) == len(ds)
    idx = openloop.held_out_indices(len(ds), WINDOWS, 3)
    np.testing.assert_array_equal(idx, jopen.held_out_indices(len(jds), WINDOWS, 3))
    for got, want in zip(openloop.eval_batches(ds, idx, BATCH), jopen.eval_batches(jds, idx, BATCH)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("solver,steps", [("ddim", 30), ("dpmpp", 10), ("dpmpp@lambda", 10)])
def test_solver_label_matches_jax(solver, steps):
    assert solver_label(solver, steps) == jax_solver_label(solver, steps)


CASES = {
    "ddim": dict(num_steps=STEPS, distilled=False),
    "dpmpp_lambda": dict(num_steps=STEPS, distilled=False, solver="dpmpp@lambda"),
    "distilled": dict(num_steps=1, distilled=True),
    "cfg": dict(num_steps=STEPS, distilled=False, guidance_scale=2.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_trajectories_matches_jax(setup, case):
    kw = dict(CASES[case])
    cfg, b = FAST_VISION, 4
    batch = next(openloop.eval_batches(setup["ds"], setup["indices"], b))
    noise = np.random.default_rng(1).standard_normal(
        (b, cfg.trajectory_prediction_length, cfg.num_joints)).astype(np.float32)
    jmodel, jvars, model = setup["jmodel"], setup["jvars"], setup["model"]
    jctx = jmodel.apply(jvars, to_jax(batch), False, method=jmodel.encode_context)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        ctx = model.eval().encode_context(tb)
    juncond = uncond = None
    if "guidance_scale" in kw:
        from soccerdiffusion_tpu.data.pipeline import null_modalities as jax_null
        from soccerdiffusion_tpu_torch.data.pipeline import null_modalities

        juncond = jmodel.apply(jvars, jax_null(to_jax(batch), ("image",)), False,
                               method=jmodel.encode_context)
        with torch.no_grad():
            uncond = model.encode_context(null_modalities(tb, ("image",)))
    want = np.asarray(jopen.sample_trajectories(
        jmodel, jvars, jax_make_schedule(T_TRAIN), jctx, jnp.asarray(noise),
        uncond_context=juncond, **kw))
    got = openloop.sample_trajectories(model, make_schedule(T_TRAIN), ctx, torch.from_numpy(noise),
                                       uncond_context=uncond, **kw).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=RTOL * scale, rtol=0)


def test_sample_trajectories_refuses_guided_distilled(setup):
    ctx = torch.zeros(2, 3, FAST_VISION.hidden_dim)
    with pytest.raises(ValueError, match="iterative sampler"):
        openloop.sample_trajectories(setup["model"], make_schedule(T_TRAIN), ctx,
                                     torch.zeros(2, 10, 20), 1, True, uncond_context=ctx,
                                     guidance_scale=2.0)


OPEN_LOOP = {
    "ddim": dict(num_steps=STEPS, distilled=False),
    "distilled": dict(num_steps=1, distilled=True),
    "shuffled_images": dict(num_steps=STEPS, distilled=False, shuffle_keys=openloop.IMAGE_KEYS),
    "cfg": dict(num_steps=STEPS, distilled=False, guidance_scale=2.0, guidance_null=("image",)),
    "mean_of": dict(num_steps=STEPS, distilled=False, mean_of=2, solver="dpmpp"),
}


@pytest.mark.parametrize("case", list(OPEN_LOOP))
def test_open_loop_metrics_matches_jax(setup, case):
    kw = dict(batch_size=BATCH, seed=2, **OPEN_LOOP[case])
    want = jopen.open_loop_metrics(setup["jmodel"], setup["jvars"], setup["jnorm"],
                                   jax_make_schedule(T_TRAIN), setup["jds"], setup["indices"], **kw)
    got = openloop.open_loop_metrics(setup["model"], setup["norm"], make_schedule(T_TRAIN),
                                     setup["ds"], setup["indices"], noise_fn=jax_noise_fn(),
                                     device="cpu", **kw)
    assert_close(got, want)


def test_context_sensitivity_matches_jax(setup):
    variants = {"context": jopen.CONTEXT_KEYS, "image": jopen.IMAGE_KEYS}
    want = jopen.context_sensitivity(setup["jmodel"], setup["jvars"], setup["jnorm"],
                                     jax_make_schedule(T_TRAIN), setup["jds"], setup["indices"],
                                     batch_size=BATCH, seed=4, variants=variants)
    got = openloop.context_sensitivity(setup["model"], setup["norm"], make_schedule(T_TRAIN),
                                       setup["ds"], setup["indices"], batch_size=BATCH, seed=4,
                                       variants={"context": openloop.CONTEXT_KEYS,
                                                 "image": openloop.IMAGE_KEYS},
                                       noise_fn=jax_noise_fn(), device="cpu")
    assert_close(got, want)
    single = openloop.context_sensitivity(setup["model"], setup["norm"], make_schedule(T_TRAIN),
                                          setup["ds"], setup["indices"], batch_size=BATCH, seed=4,
                                          keys=openloop.IMAGE_KEYS, noise_fn=jax_noise_fn(),
                                          device="cpu")
    assert single == got["image"]


@pytest.mark.parametrize("student_steps,distilled,solver", [(1, True, "ddim"),
                                                            (3, False, "dpmpp")])
def test_sampler_agreement_matches_jax(setup, student_steps, distilled, solver):
    kw = dict(batch_size=BATCH, seed=5, student_solver=solver)
    want = jopen.sampler_agreement(setup["jmodel"], setup["jvars"], setup["svars"], setup["jnorm"],
                                   jax_make_schedule(T_TRAIN), setup["jds"], setup["indices"],
                                   STEPS, student_steps, distilled, **kw)
    got = openloop.sampler_agreement(setup["model"], setup["student"], setup["norm"],
                                     make_schedule(T_TRAIN), setup["ds"], setup["indices"], STEPS,
                                     student_steps, distilled, noise_fn=jax_noise_fn(),
                                     device="cpu", **kw)
    assert_close(got, want)


def test_closed_loop_divergence_matches_jax(setup):
    kw = dict(batch_size=4, num_chunks=CHUNKS, seed=6)
    want = jdiv.closed_loop_divergence(setup["jmodel"], setup["jvars"], setup["svars"],
                                       jax_make_schedule(T_TRAIN), setup["jnorm"], STEPS, 1, True,
                                       **kw)
    got = divergence.closed_loop_divergence(setup["model"], setup["student"],
                                            make_schedule(T_TRAIN), setup["norm"], STEPS, 1, True,
                                            noise_fn=jax_noise_fn(), device="cpu", **kw)
    assert_close(got, want)


def test_self_consistency_matches_jax(setup):
    kw = dict(batch_size=4, num_chunks=CHUNKS, seed=7)
    want = jdiv.self_consistency(setup["jmodel"], setup["jvars"], jax_make_schedule(T_TRAIN),
                                 setup["jnorm"], 3, **kw)
    got = divergence.self_consistency(setup["model"], make_schedule(T_TRAIN), setup["norm"], 3,
                                      noise_fn=jax_noise_fn(), device="cpu", **kw)
    assert_close(got, want)


def test_rollouts_of_one_seed_draw_the_same_noise(setup):
    """Without a noise_fn both rollouts of a comparison start from generators
    of the same seed: the same sampler twice gives the same chunks, and a
    second seed others."""
    args = (setup["model"], make_schedule(T_TRAIN), setup["norm"], 2, False, 3, 2)
    a = divergence.rollout_chunks(*args, seed=1, device="cpu")
    assert a.shape == (2, 3, 10, 20) and np.isfinite(a).all()
    np.testing.assert_array_equal(divergence.rollout_chunks(*args, seed=1, device="cpu"), a)
    assert not np.array_equal(divergence.rollout_chunks(*args, seed=2, device="cpu"), a)


@pytest.mark.parametrize("boundary", [False, True])
def test_oracle_matches_jax(setup, boundary):
    jds, ds = setup["jds"], setup["ds"]
    idx = (np.sort(ds.image_boundary_indices()[:WINDOWS]) if boundary
           else openloop.held_out_indices(len(ds), WINDOWS, 0))
    if boundary:
        np.testing.assert_array_equal(ds.image_boundary_indices(), jds.image_boundary_indices())
    want = joracle.vision_oracle_open_loop(jds, idx, num_samples=4, seed=3)
    got = oracle.vision_oracle_open_loop(ds, idx, num_samples=4, seed=3)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_oracle_needs_the_vision_task():
    _, ds = datasets(dataclasses.replace(FAST_VISION, use_images=False), task="decorative",
                     num_samples=100)
    with pytest.raises(ValueError, match="vision"):
        oracle.vision_oracle_open_loop(ds, [0, 1])


def test_evaluation_defaults_to_the_card(setup):
    """Asked for CUDA (the default) where there is none, the evaluation
    raises; a model on another device than the one asked for is refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    args = (setup["model"], setup["norm"], make_schedule(T_TRAIN), setup["ds"], [0, 1], 2, False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        openloop.open_loop_metrics(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        divergence.rollout_chunks(setup["model"], make_schedule(T_TRAIN), setup["norm"], 2, False,
                                  2, 1)
