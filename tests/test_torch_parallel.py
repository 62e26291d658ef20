"""The port's parallel/ against the JAX package's, on the CPU.

Without a process group: the mesh layout, ``rules_for_mesh``, the hybrid
"dcn" grouping and the refusals, and ``param_placements`` leaf for leaf
against JAX's ``param_shardings`` (the port's Linear weight is (out, in),
flax's kernel (in, out): a column split is the port's dimension 0, a row
split dimension 1).

With one: ranks are subprocesses on a gloo group (tests/torch_parallel_worker.py,
one thread each, a time limit each); one group of four ranks and one of two
run every check below, and the results come back here:

  * data parallelism on 2 and 4 ranks, "dcn" x "data" and "data" x
    "model" (tensor parallelism) against the JAX single-device step at the
    global batch, float32, from the same numpy-made t / noise over three
    AdamW steps with clipping and EMA: the loss within 1e-5 relative (it is
    ~30 here: float32 rounds the mean of the ranks' means apart from the
    mean at ~1e-6 of it), the global gradient norm within 1e-5 relative, the clipped
    gradients within 1e-4, the parameters and EMA within 1e-5 (the key
    biases, whose gradient is zero in exact arithmetic, within 2 lr a step,
    as tests/test_torch_training.py);
  * tensor parallelism with the fused encoder stack and decoder layer (the
    weights all-gathered into the ops) against one process of the port:
    the loss within 1e-6, the gradients within 1e-5;
  * ring and head-sharded attention on four ranks against JAX's
    ``ring_attention`` and plain attention (2e-5) and their gradients
    against plain autograd (1e-5);
  * the sharded fleet rollout: each shard's chunks bit for bit those of an
    unsharded rollout over its robots with its folded generator;
  * a tensor-parallel checkpoint: rank 0 writes the single-process format
    (whole tensors), which one process loads, and a new split model resumes
    from it bit for bit (parameters, EMA, AdamW moments);
  * data-parallel distillation (a 2-step student) on 2 ranks against one
    process of the port: the loss and gradient norm within 1e-5 relative,
    the student's parameters within 1e-5 (the key biases within 2 lr);
    DeviceResidentData refuses a group of several ranks;
  * ``TrainStep.__call__`` on 2 ranks (t, noise and the modality-dropout
    masks drawn for the global batch from one seed, each rank keeping its
    rows) with the aux cue loss, whose valid labels differ between the
    ranks, against one process's ``__call__`` at the global batch: the
    loss, aux_cue_loss and gradient norm within 1e-5 relative over 2 steps,
    the parameters within 1e-5 (AdamW's noise-level entries within 2 lr).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.models.attention import xla_attention
from soccerdiffusion_tpu.parallel import mesh as jax_mesh
from soccerdiffusion_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from soccerdiffusion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference import RolloutEngine
from soccerdiffusion_tpu_torch.inference.rollout import fold_in
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.models.attention import plain_attention
from soccerdiffusion_tpu_torch.parallel import mesh as port_mesh
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import _flax_path, _leaves, load_jax_params

from tests.test_torch_jax_params import SMALL, make_batch, port_config, to_jax, to_torch
from tests.test_torch_training import grads_as_model, jax_loss_fn
from tests.torch_parallel_launch import run_ranks

pytestmark = pytest.mark.timeout(600)

B, STEPS, LR, TOTAL, CLIP, DECAY = 8, 3, 1e-3, 10, 0.5, 0.9
VIT = dataclasses.replace(SMALL, use_images=True, image_encoder_type="vit", image_resolution=32,
                          vit_patch_size=8, vit_width=32, vit_depth=2, image_context_length=2,
                          vit_fused_block=True)
FUSED = dataclasses.replace(SMALL, encoder_fused_stack=True, decoder_fused_block=True)


# ------------------------------------------------------------ no process group

def flax_paths(model) -> dict[str, str]:
    """Port parameter name -> flax params path."""
    out = {}
    for name, mod in model.named_modules():
        for attr, leaf, _ in _leaves(mod):
            out[f"{name}.{attr}" if name else attr] = f"{_flax_path(name)}/{leaf}"
    return out


def jax_placements(shape, params, rules):
    mesh = jax_mesh.make_mesh(shape)
    specs = jax.tree_util.tree_leaves_with_path(jax_mesh.param_shardings(mesh, params, rules))
    out = {}
    for path, sharding in specs:
        key = "/".join(p.key for p in path)
        spec = tuple(sharding.spec)
        if not spec or all(s is None for s in spec):
            out[key] = None
        elif key.endswith("/bias"):
            out[key] = (0, spec[0])
        else:  # a (in, out) kernel: the port's (out, in) weight splits the other dimension
            out[key] = (1, spec[0]) if spec[0] is not None else (0, spec[1])
    return out


@pytest.mark.parametrize("shape", [{"data": 4, "model": 2}, {"dcn": 2, "data": 2, "model": 2}],
                         ids=["data4-model2", "dcn2-data2-model2"])
@pytest.mark.parametrize("cfg", [SMALL, VIT], ids=["small", "vit"])
def test_param_placements_equal_jax_param_shardings(cfg, shape):
    b = 1
    batch = to_jax(make_batch(cfg, b, np.random.default_rng(0)))
    variables = jax.eval_shape(
        lambda: JaxPolicy(cfg).init(jax.random.key(0), batch,
                                    jnp.zeros((b, cfg.trajectory_prediction_length, cfg.num_joints)),
                                    jnp.zeros((b,), jnp.int32)))
    rules = jax_mesh.rules_for_mesh(jax_mesh.make_mesh(shape))
    want = jax_placements(shape, variables["params"], rules)
    model = DiffusionPolicy(port_config(cfg))
    got = port_mesh.param_placements(shape, model)
    paths = flax_paths(model)
    assert sorted(paths.values()) == sorted(want)
    assert {paths[name]: p for name, p in got.items()} == want
    assert sum(p is not None for p in got.values()) > 0


@pytest.mark.parametrize("shape", [{"data": 8}, {"dcn": 2, "data": 4}, {"data": 4, "model": 2},
                                   {"dcn": 2, "model": 4}, {"dcn": 8}, {"seq": 8},
                                   {"data": 2, "seq": 4}, {"dcn": 2, "data": 2, "model": 2}])
def test_rules_for_mesh_equal_jax(shape):
    want = jax_mesh.rules_for_mesh(jax_mesh.make_mesh(shape))
    mesh = port_mesh.make_mesh(shape, world_size=8, rank=0)
    got = port_mesh.rules_for_mesh(mesh)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_mesh.rules_for_mesh(mesh.shape) == got
    assert got.batch_axes() == (("dcn", want.data_axis) if want.dcn else (want.data_axis,))


def test_hybrid_mesh_groups_contiguous_slices(monkeypatch):
    """dcn outermost: slice 0's ranks precede slice 1's; every other axis's
    groups stay inside a slice (as tests/test_training.py::TestHybridMesh)."""
    meshes = [port_mesh.make_mesh({"dcn": 2, "data": 2, "model": 2}, world_size=8, rank=r)
              for r in range(8)]
    m = meshes[5]
    assert m.axis_names == ("dcn", "data", "model") and m.ranks.shape == (2, 2, 2)
    assert m.ranks[0].max() < m.ranks[1].min()
    assert m.coords == {"dcn": 1, "data": 0, "model": 1}
    assert m.group_ranks("model") == [4, 5] and m.group_ranks(("dcn", "data")) == [1, 3, 5, 7]
    for mesh in meshes:
        assert set(mesh.group_ranks("data")) <= set(range(4 * mesh.coords["dcn"],
                                                          4 * mesh.coords["dcn"] + 4))
        assert mesh.axis_index(("dcn", "data")) == 2 * mesh.coords["dcn"] + mesh.coords["data"]
    # torchrun's nodes: 2 nodes of 4 ranks give the same layout; 4 nodes refuse 2 slices
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    nodes = port_mesh.make_mesh({"dcn": 2, "data": 4}, world_size=8, rank=3)
    np.testing.assert_array_equal(nodes.ranks, np.arange(8).reshape(2, 4))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="requested 2 slices, topology has 4"):
        port_mesh.make_mesh({"dcn": 2, "data": 4}, world_size=8, rank=0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(ValueError, match="needs 4 ranks/slice, have 2"):
        port_mesh.make_hybrid_mesh({"data": 4}, 4, world_size=8, rank=0)


def test_model_axis_over_dcn_rejected_as_in_jax():
    with pytest.raises(ValueError) as want:
        jax_mesh.MeshRules(model_axis="dcn")
    with pytest.raises(ValueError) as got:
        port_mesh.MeshRules(model_axis="dcn")
    assert str(got.value) == str(want.value)


def test_mesh_must_match_the_world_and_the_batch_must_split():
    with pytest.raises(ValueError, match=r"needs 8 ranks, have 4"):
        port_mesh.make_mesh({"data": 4, "model": 2}, world_size=4, rank=0)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        port_mesh.make_mesh({"data": 2})  # no process group: one rank
    mesh = port_mesh.make_mesh({"data": 2, "model": 2}, world_size=4, rank=3)
    rows = port_mesh.shard_batch(mesh, {"x": np.arange(8), "y": torch.arange(16).reshape(8, 2)})
    np.testing.assert_array_equal(rows["x"], [4, 5, 6, 7])
    assert rows["y"].shape == (4, 2)
    with pytest.raises(ValueError, match="does not split over the 2 ranks"):
        port_mesh.shard_batch(mesh, {"x": np.arange(7)})
    assert port_mesh.make_mesh(None, world_size=3, rank=1).shape == {"data": 3}


CUE = dict(num_joints=6, hidden_dim=32, trajectory_prediction_length=5,
           action_context_length=12, joint_state_context_length=12, imu_context_length=12,
           use_images=True, image_encoder_type="vit", image_resolution=16,
           image_context_length=2, vit_patch_size=8, vit_width=32, vit_depth=1,
           num_image_sequence_encoder_layers=1, num_action_history_encoder_layers=1,
           num_imu_encoder_layers=1, joint_state_encoder_layers=1, num_decoder_layers=1,
           aux_cue_head=True, attention_impl="xla")


def cue_call_case():
    """The "vision" dummy task's first shuffled batch of 4 (labels, float
    frames), rank 1's rows with one label marked invalid, and flax-default
    weights: the arguments of the worker's check_call."""
    from soccerdiffusion_tpu_torch.config import ModelConfig as PortConfig
    from soccerdiffusion_tpu_torch.data import WindowedDataset, generate_dummy_arrays
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params

    cfg = PortConfig(**CUE)
    dummy = generate_dummy_arrays(num_recordings=2, num_samples=40, num_joints=6,
                                  image_size=16, seed=4, task="vision")
    batch = next(WindowedDataset.from_dummy(dummy, cfg).batches(4, seed=2))
    batch["vision_u_valid"] = np.ones_like(batch["vision_u"], np.float32)
    batch["vision_u_valid"][3] = 0.0
    params, _ = flax_init_params(DiffusionPolicy(cfg), 5)
    return dict(cfg=CUE, params=params, batch=batch, seed=13, steps=2, dropout=0.3,
                aux_weight=0.1)


def test_initialize_distributed_is_a_no_op_for_one_process(monkeypatch):
    from soccerdiffusion_tpu_torch.parallel import distributed

    for world in (None, "1"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        assert distributed.initialize_distributed(device="cpu") == torch.device("cpu")
        assert not distributed.is_initialized()
        assert (distributed.world_size(), distributed.rank()) == (1, 0)
    assert distributed.global_mesh().shape == {"data": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.initialize_distributed()


# ------------------------------------------------------ the ranks' results

def step_inputs(cfg, rng, b=B):
    target = rng.uniform(0, 2 * np.pi, (b, cfg.trajectory_prediction_length, cfg.num_joints))
    t = rng.integers(0, 100, (b,))
    noise = rng.standard_normal((b, cfg.trajectory_prediction_length, cfg.num_joints))
    return target.astype(np.float32), t.astype(np.int64), noise.astype(np.float32)


def init_params(cfg, seed=0):
    batch = make_batch(cfg, B, np.random.default_rng(seed))
    variables = JaxPolicy(cfg).init(jax.random.key(seed), to_jax(batch),
                                    jnp.zeros((B, cfg.trajectory_prediction_length,
                                               cfg.num_joints)), jnp.zeros((B,), jnp.int32))
    return jax.tree.map(np.asarray, variables["params"]), batch


@pytest.fixture(scope="module")
def train_case():
    params, batch = init_params(SMALL)
    rng = np.random.default_rng(11)
    steps = [step_inputs(SMALL, rng) for _ in range(STEPS)]
    kw = dict(cfg=dataclasses.asdict(port_config(SMALL)), params=params, batch=batch,
              steps=steps, lr=LR, total=TOTAL, clip=CLIP, ema_decay=DECAY)
    return kw


@pytest.fixture(scope="module")
def jax_trajectory(train_case):
    """The JAX single-device loop at the global batch: per step the loss,
    the global norm, the clipped gradients, the parameters and the EMA, laid
    out as the port's parameters."""
    jmodel, schedule = JaxPolicy(SMALL), jax_make_schedule(100)
    jopt = jax_make_optimizer(LR, TOTAL, weight_decay=1e-2, grad_clip_norm=CLIP)
    params = jax.tree.map(jnp.asarray, train_case["params"])
    opt_state, ema = jopt.init(params), params
    model = DiffusionPolicy(port_config(SMALL))
    out = []
    for i, (target, t, noise) in enumerate(train_case["steps"]):
        jbatch = {**to_jax(train_case["batch"]), "joint_command": jnp.asarray(target)}
        loss, grads = jax.value_and_grad(jax_loss_fn(jmodel, schedule, jbatch, target, noise,
                                                     t.astype(np.int32)))(params)
        clipped, _ = optax.clip_by_global_norm(CLIP).update(grads, optax.EmptyState())
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        d = min(DECAY, (1.0 + (i + 1)) / (10.0 + (i + 1)))
        ema = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), ema, params)
        out.append({"loss": float(loss), "grad_norm": float(optax.global_norm(grads)),
                    "grads": grads_as_model(model, clipped), "params": grads_as_model(model, params),
                    "ema": grads_as_model(model, ema)})
    return out


@pytest.fixture(scope="module")
def four_ranks(train_case, tmp_path_factory):
    rng = np.random.default_rng(5)
    q, k, v, dout = (rng.standard_normal((2, 16, 4, 8)).astype(np.float32) for _ in range(4))
    fused = dict(train_case, cfg=dataclasses.asdict(port_config(FUSED)), steps=train_case["steps"][:1])
    rollout_params, _ = init_params(SMALL, seed=3)
    ckpt = tmp_path_factory.mktemp("tp_checkpoint") / "ckpt"
    checks = [
        ("dp4", "train", dict(train_case, shape={"data": 4})),
        ("checkpoint", "checkpoint", dict(cfg=train_case["cfg"], shape={"data": 2, "model": 2},
                                          params=train_case["params"], batch=train_case["batch"],
                                          steps=train_case["steps"], path=str(ckpt))),
        ("dcn", "train", dict(train_case, shape={"dcn": 2, "data": 2})),
        ("tp", "train", dict(train_case, shape={"data": 2, "model": 2})),
        ("tp_flat", "train", dict(train_case, shape={"data": 2, "model": 2}, flat=True)),
        ("tp_fused", "train", dict(fused, shape={"data": 2, "model": 2})),
        ("attention", "attention", dict(q=q, k=k, v=v, dout=dout, shape={"seq": 4})),
        ("rollout", "rollout", dict(cfg=dataclasses.asdict(port_config(SMALL)),
                                    params=rollout_params, shape={"data": 4}, robots=8, chunks=2,
                                    steps=5, seed=7)),
    ]
    results = run_ranks(checks, 4, tmp_path_factory.mktemp("four_ranks"))
    return dict(results=results, qkv=(q, k, v, dout), fused=fused, rollout_params=rollout_params,
                ckpt=ckpt)


@pytest.fixture(scope="module")
def two_ranks(train_case, tmp_path_factory):
    target, _, noise = train_case["steps"][0]
    distill = dict(cfg=train_case["cfg"], params=train_case["params"],
                   batch={**train_case["batch"], "joint_command": target}, noise=noise,
                   teacher_steps=5)
    results = run_ranks([("dp2", "train", dict(train_case, shape={"data": 2})),
                         ("dp2_flat", "train", dict(train_case, shape={"data": 2}, flat=True)),
                         ("distill", "distill", dict(distill, shape={"data": 2})),
                         ("device_data", "device_data", dict(cfg=train_case["cfg"])),
                         ("call", "call", dict(cue_call_case(), shape={"data": 2}))], 2,
                        tmp_path_factory.mktemp("two_ranks"))
    return dict(results=results, distill=distill)


def assert_trajectory(ranks, name, want):
    for rank, result in enumerate(ranks):
        got = result[name]
        for i, ref in enumerate(want):
            where = f"{name} rank {rank} step {i}"
            np.testing.assert_allclose(got["loss"][i], ref["loss"], rtol=1e-5, err_msg=where)
            np.testing.assert_allclose(got["grad_norm"][i], ref["grad_norm"], rtol=1e-5,
                                       err_msg=where)
            noise_bound = 2 * sum(lr_at_step(LR, TOTAL, k) for k in range(i + 1))
            for pname, value in ref["params"].items():
                key_bias = pname.endswith("k_proj.bias")
                if not key_bias:
                    np.testing.assert_allclose(got["grads"][i][pname],
                                               ref["grads"][pname].detach().numpy(), atol=1e-4,
                                               rtol=0, err_msg=f"{where}: grad {pname}")
                tol = noise_bound if key_bias else 1e-5
                for kind in ("params", "ema"):
                    np.testing.assert_allclose(got[kind][i][pname],
                                               ref[kind][pname].detach().numpy(), atol=tol,
                                               rtol=0, err_msg=f"{where}: {kind} {pname}")


@pytest.mark.parametrize("name", ["dp2", "dp4", "dcn", "tp", "dp2_flat", "tp_flat"])
def test_parallel_steps_equal_the_jax_single_device_step(name, two_ranks, four_ranks,
                                                         jax_trajectory):
    """``*_flat``: with the flat optimizer (``flat_optimizer: true``), whose
    global norm sums in another order: the same bounds."""
    ranks = (two_ranks if name.startswith("dp2") else four_ranks)["results"]
    assert_trajectory(ranks, name, jax_trajectory)


def test_tensor_parallel_fused_ops_equal_one_process(four_ranks):
    """The fused encoder stack and decoder layer under data=2, model=2: the
    split weights are all-gathered into the ops and the gradients sliced
    back; the step equals one process of the port at the global batch."""
    kw = four_ranks["fused"]
    model = load_jax_params(DiffusionPolicy(port_config(FUSED)), kw["params"])
    opt = make_optimizer(model, LR, TOTAL, weight_decay=1e-2, grad_clip_norm=CLIP)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(FUSED.num_joints),
                           ema_decay=DECAY)
    target, t, noise = kw["steps"][0]
    batch = {**to_torch(kw["batch"]), "joint_command": torch.from_numpy(target)}
    metrics = step.apply(state, batch, torch.from_numpy(t), torch.from_numpy(noise))
    for result in four_ranks["results"]:
        got = result["tp_fused"]
        np.testing.assert_allclose(got["loss"][0], metrics["loss"].item(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["grad_norm"][0], metrics["grad_norm"].item(), rtol=1e-5)
        for name, p in model.named_parameters():
            if not name.endswith("k_proj.bias"):
                np.testing.assert_allclose(got["grads"][0][name], p.grad.numpy(), atol=1e-5,
                                           rtol=0, err_msg=name)


def test_ring_and_head_sharded_attention_equal_jax(four_ranks):
    q, k, v, dout = four_ranks["qkv"]
    want_ring = np.asarray(jax_ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                              jax.sharding.Mesh(np.array(jax.devices()[:4]),
                                                                ("seq",)), axis="seq"))
    want_plain = np.asarray(xla_attention(*(jnp.asarray(a) for a in (q, k, v))))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (plain_attention(qt, kt, vt) * torch.from_numpy(dout)).sum().backward()
    for result in four_ranks["results"]:
        got = result["attention"]
        np.testing.assert_allclose(got["ring"]["out"], want_ring, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["heads"]["out"], want_plain, atol=2e-5, rtol=0)
        for form in ("ring", "heads"):
            for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
                np.testing.assert_allclose(got[form][name], t.grad.numpy(), atol=1e-5, rtol=0,
                                           err_msg=f"{form} {name}")


def test_sharded_rollout_shards_equal_unsharded_rollouts(four_ranks):
    """Each rank's shard of the gathered chunks is an unsharded rollout over
    its 2 robots with fold_in(the seeded generator, rank), bit for bit; the
    second call folds fresh noise from the advanced generator."""
    cfg = port_config(SMALL)
    model = load_jax_params(DiffusionPolicy(cfg), four_ranks["rollout_params"])
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(cfg.num_joints),
                           num_inference_steps=5, device="cpu")
    results = [r["rollout"] for r in four_ranks["results"]]
    for r in results[1:]:
        np.testing.assert_array_equal(r["chunks"], results[0]["chunks"])
    gathered, again = results[0]["chunks"], results[0]["again"]
    assert gathered.shape == (2, 8, cfg.trajectory_prediction_length, cfg.num_joints)
    base = engine.init(8, torch.Generator().manual_seed(7))
    for rank in range(4):
        generator = torch.Generator().manual_seed(7)
        first = fold_in(generator, rank)
        second = fold_in(generator, rank)
        rows = slice(2 * rank, 2 * rank + 2)
        carry = dataclasses.replace(
            base, controller=base.controller.replace(**{
                f: getattr(base.controller, f)[rows] for f in (
                    "joint_command_history", "joint_state_history", "imu_history",
                    "game_state")}),
            plant=type(base.plant)(positions=base.plant.positions[rows],
                                   phase=base.plant.phase[rows]),
            generator=first)
        carry, chunks = engine.make_rollout_fn(2)(carry)
        np.testing.assert_array_equal(gathered[:, rows], chunks.numpy())
        np.testing.assert_array_equal(results[rank]["positions"], carry.plant.positions.numpy())
        carry = dataclasses.replace(carry, generator=second)
        _, chunks = engine.make_rollout_fn(2)(carry)
        np.testing.assert_array_equal(again[:, rows], chunks.numpy())
    assert not np.array_equal(gathered[:, 0:2], gathered[:, 2:4])


def test_tensor_parallel_checkpoint_is_whole_and_resumes(four_ranks):
    from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint

    results = [r["checkpoint"] for r in four_ranks["results"]]
    raw = load_checkpoint(four_ranks["ckpt"])
    model = DiffusionPolicy(port_config(SMALL))
    model.load_state_dict(raw["params"])  # whole tensors: one process loads them
    names = [n for n, _ in model.named_parameters()]
    moments = {names[int(i)]: m["exp_avg"] for i, m in raw["optimizer"]["state"].items()}
    for got in results:
        assert got["step"] == raw["step"] == 1
        for name, p in model.named_parameters():
            for kind, want in (("params", p.detach()), ("ema", raw["ema"][name]),
                               ("exp_avg", moments[name])):
                np.testing.assert_array_equal(got[kind][name], want.numpy(), err_msg=name)
                np.testing.assert_array_equal(got[f"resumed_{kind}" if kind != "params"
                                                  else "resumed"][name], want.numpy(),
                                              err_msg=f"resumed {kind} {name}")


def test_data_parallel_distillation_equals_one_process(two_ranks):
    from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, make_distill_step

    kw = two_ranks["distill"]
    teacher = load_jax_params(DiffusionPolicy(port_config(SMALL)), kw["params"]).eval()
    teacher.requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True)
    opt = make_optimizer(student, LR, TOTAL, trainable=TRAINABLE)
    state = create_train_state(student, opt)
    step = make_distill_step(student, make_schedule(100), opt, teacher_inference_steps=5,
                             student_steps=2)
    metrics = step.apply(state, teacher, to_torch(kw["batch"]), torch.from_numpy(kw["noise"]))
    for result in two_ranks["results"]:
        got = result["distill"]
        np.testing.assert_allclose(got["loss"], metrics["loss"].item(), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], metrics["grad_norm"].item(), rtol=1e-5)
        for name, p in student.named_parameters():
            tol = 2 * LR if name.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(got["params"][name], p.detach().numpy(), atol=tol, rtol=0,
                                       err_msg=name)
    for result in two_ranks["results"]:
        assert "under 2 ranks" in result["device_data"]["error"]


def test_call_draws_the_global_batchs_noise_and_masks(two_ranks):
    import tests.torch_parallel_worker as worker

    want = worker.check_call(**cue_call_case(), shape=None)
    for result in two_ranks["results"]:
        got = result["call"]
        for key in ("loss", "aux_cue_loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
        for name, value in want["params"].items():
            tol = 2 * 2 * LR if name.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(got["params"][name], value, atol=tol, rtol=0, err_msg=name)
