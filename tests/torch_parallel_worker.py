"""One rank of the port's multi-process CPU checks (tests/test_torch_parallel*.py).

Usage: python tests/torch_parallel_worker.py JOB.pkl OUT_DIR RANK WORLD PORT

Joins a gloo process group of WORLD ranks at tcp://127.0.0.1:PORT through
the port's ``initialize_distributed``, runs every check of the job (a list
of ``(name, kind, kwargs)``) in order on that one group, and writes
``OUT_DIR/rank{RANK}.pkl``: {name: result dict of numpy arrays}. It imports
the port only (torch, numpy), one thread per rank.
"""

from __future__ import annotations

import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from soccerdiffusion_tpu_torch.config import ModelConfig  # noqa: E402
from soccerdiffusion_tpu_torch.data import Normalizer  # noqa: E402
from soccerdiffusion_tpu_torch.diffusion import make_schedule  # noqa: E402
from soccerdiffusion_tpu_torch.models import DiffusionPolicy  # noqa: E402
from soccerdiffusion_tpu_torch.parallel import (  # noqa: E402
    head_sharded_attention,
    initialize_distributed,
    make_mesh,
    ring_self_attention,
    shard_batch,
    use_mesh,
)
from soccerdiffusion_tpu_torch.parallel import comm  # noqa: E402
from soccerdiffusion_tpu_torch.parallel.tensor_parallel import shard_model  # noqa: E402
from soccerdiffusion_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params  # noqa: E402


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def full_named(model, values: dict) -> dict:
    """Parameter-shaped tensors gathered to whole shapes (tensor parallelism)."""
    tp = getattr(model, "tensor_parallel", None)
    return {k: (v if tp is None else tp.full(k, v)).detach().numpy().copy()
            for k, v in values.items()}


def check_train(cfg, shape, params, batch, steps, lr, total, clip, ema_decay, stats=None,
                flat=False):
    """Three (or len(steps)) AdamW steps of this rank's share: loss,
    grad_norm, the clipped gradients, the parameters and the EMA after each;
    ``flat``: with the flat optimizer (its clipped gradients are its flat
    buffer's)."""
    model = load_jax_params(DiffusionPolicy(ModelConfig(**cfg)), params, stats)
    mesh = make_mesh(shape)
    shard_model(model, mesh)
    opt = make_optimizer(model, lr, total, weight_decay=1e-2, grad_clip_norm=clip, flat=flat)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg["num_joints"]),
                           ema_decay=ema_decay, mesh=mesh)
    out = {"loss": [], "grad_norm": [], "grads": [], "params": [], "ema": []}
    for target, t, noise in steps:
        local = tensors(shard_batch(mesh, {**batch, "joint_command": target, "t": t,
                                           "noise": noise}))
        t_l, noise_l = local.pop("t"), local.pop("noise")
        metrics = step.apply(state, local, t_l, noise_l)
        out["loss"].append(metrics["loss"].item())
        out["grad_norm"].append(metrics["grad_norm"].item())
        named = dict(model.named_parameters())
        grads = {k: p.grad for k, p in named.items()}
        if flat:
            assert opt.in_buffer()
            grads = {k: opt.grads[a:b].view_as(named[k])
                     for k, (a, b) in zip(opt.state_names, opt.slices)}
        out["grads"].append(full_named(model, grads))
        out["params"].append(full_named(model, named))
        out["ema"].append(full_named(model, state.ema))
    out["buffers"] = {k: v.numpy().copy() for k, v in model.named_buffers()}
    return out


def check_attention(q, k, v, dout, shape):
    """Ring and head-sharded attention over "seq": outputs and the gradients
    of sum(out * dout), replicated on every rank."""
    mesh = make_mesh(shape)
    out = {}
    for name, fn in (("ring", ring_self_attention), ("heads", head_sharded_attention)):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        o = fn(qt, kt, vt, mesh)
        (o * torch.from_numpy(dout)).sum().backward()
        out[name] = {"out": o.detach().numpy(), "dq": qt.grad.numpy(), "dk": kt.grad.numpy(),
                     "dv": vt.grad.numpy()}
    return out


def check_policy_forward(cfg, shape, params, batch, noisy, t):
    """The policy's forward on this rank's rows under the mesh."""
    model = load_jax_params(DiffusionPolicy(ModelConfig(**cfg)), params).eval()
    mesh = make_mesh(shape)
    local = tensors(shard_batch(mesh, {**batch, "noisy": noisy, "t": t}))
    with torch.no_grad(), use_mesh(mesh):
        got = model(local, local.pop("noisy"), local.pop("t"))
    return {"out": got.numpy(), "rows": shard_batch(mesh, {"i": np.arange(len(t))})["i"]}


def check_sync_bn(kind, hidden, res, params, stats, x, dy, shape):
    """The ResNet encoder in float64, train mode, on this rank's frames under
    the mesh (synchronised statistics): its rows of the output and of dx,
    the gradients summed over the ranks (the loss is a sum over every row)
    and the updated running statistics; then the same rows alone (no mesh)."""
    from soccerdiffusion_tpu_torch.models.vision import make_image_encoder

    mesh = make_mesh(shape)
    local = shard_batch(mesh, {"x": x, "dy": dy})
    out = {}
    for name, m in (("synced", mesh), ("alone", None)):
        enc = make_image_encoder(kind, hidden, res, use_final_avgpool=True,
                                 dtype=torch.float64).double()
        load_jax_params(enc, params, stats)
        enc.train()
        xt = torch.from_numpy(local["x"]).double().requires_grad_(True)
        with use_mesh(m):
            y = enc(xt)
            (y * torch.from_numpy(local["dy"]).double()).sum().backward()
        grads = {n: p.grad.detach().clone() for n, p in enc.named_parameters()}
        if m is not None:
            for g in grads.values():
                comm.all_reduce_(g, mesh.group("data"))
        out[name] = {"out": y.detach().numpy(), "dx": xt.grad.numpy(),
                     "grads": {n: g.numpy() for n, g in grads.items()},
                     "buffers": {n: b.numpy().copy() for n, b in enc.named_buffers()}}
    return out


def check_rollout(cfg, params, shape, robots, chunks, steps, seed):
    """The sharded fleet rollout: the gathered chunks and this shard's carry."""
    from soccerdiffusion_tpu_torch.inference import RolloutEngine

    model = load_jax_params(DiffusionPolicy(ModelConfig(**cfg)), params)
    engine = RolloutEngine(model, make_schedule(100), Normalizer.identity(cfg["num_joints"]),
                           num_inference_steps=steps, device="cpu")
    mesh = make_mesh(shape)
    carry = engine.shard_carry(engine.init(robots, torch.Generator().manual_seed(seed)), mesh)
    out_carry, got = engine.make_sharded_rollout(chunks, mesh)(carry)
    _, again = engine.make_sharded_rollout(chunks, mesh)(out_carry)
    return {"chunks": got.numpy(), "again": again.numpy(),
            "positions": out_carry.plant.positions.numpy()}


def check_step_vs_plain(cfg, shape, params, batch, target, t, noise):
    """One step of this rank's share (loss, grad_norm, whole gradients)."""
    out = check_train(cfg, shape, params, batch, [(target, t, noise)], 1e-3, 10, 0.0, 0.0)
    return {k: out[k][0] for k in ("loss", "grad_norm", "grads")}


def check_checkpoint(cfg, shape, params, batch, steps, path):
    """One tensor-parallel step, its checkpoint (every rank calls the save,
    rank 0 writes), and a new split model and optimizer resumed from it:
    the resumed parameters and AdamW moments, gathered, against the ones
    saved."""
    from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

    def fresh():
        model = load_jax_params(DiffusionPolicy(ModelConfig(**cfg)), params)
        shard_model(model, mesh)
        opt = make_optimizer(model, 1e-3, 10, weight_decay=1e-2)
        return model, opt, create_train_state(model, opt, ema=True)

    mesh = make_mesh(shape)
    model, opt, state = fresh()
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg["num_joints"]),
                           ema_decay=0.9, mesh=mesh)
    target, t, noise = steps[0]
    local = tensors(shard_batch(mesh, {**batch, "joint_command": target, "t": t, "noise": noise}))
    step.apply(state, local, local.pop("t"), local.pop("noise"))
    save_checkpoint(path, state, Normalizer.identity(cfg["num_joints"]), {"hidden_dim": 64}, 0)
    model2, opt2, state2 = fresh()
    load_checkpoint(path, state2)
    moments = lambda o, m: {n: o.adamw.state[p]["exp_avg"] for n, p in m.named_parameters()}
    return {"params": full_named(model, dict(model.named_parameters())),
            "resumed": full_named(model2, dict(model2.named_parameters())),
            "ema": full_named(model, state.ema), "resumed_ema": full_named(model2, state2.ema),
            "exp_avg": full_named(model, moments(opt, model)),
            "resumed_exp_avg": full_named(model2, moments(opt2, model2)),
            "step": state2.step}


def check_distill(cfg, shape, params, batch, noise, teacher_steps):
    """One data-parallel distillation step of a 2-step student (this rank's
    rows): loss, grad_norm and the student's parameters after it."""
    import copy

    from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, make_distill_step

    teacher = load_jax_params(DiffusionPolicy(ModelConfig(**cfg)), params).eval()
    teacher.requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True)
    opt = make_optimizer(student, 1e-3, 10, trainable=TRAINABLE)
    state = create_train_state(student, opt)
    mesh = make_mesh(shape)
    step = make_distill_step(student, make_schedule(100), opt,
                             teacher_inference_steps=teacher_steps, student_steps=2, mesh=mesh)
    local = tensors(shard_batch(mesh, {**batch, "noise": noise}))
    metrics = step.apply(state, teacher, local, local.pop("noise"))
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "params": {n: p.detach().numpy().copy() for n, p in student.named_parameters()}}


def check_call(cfg, shape, params, batch, seed, steps, dropout, aux_weight):
    """``steps`` steps of ``TrainStep.__call__`` (t, noise and the dropout
    masks drawn for the global batch from a seeded generator) with the aux
    cue loss: loss, aux_cue_loss, grad_norm each step, the parameters after."""
    model = load_jax_params(DiffusionPolicy(ModelConfig(**cfg)), params)
    mesh = make_mesh(shape) if shape else None
    opt = make_optimizer(model, 1e-3, 10, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(100), opt, Normalizer.identity(cfg["num_joints"]),
                           modality_dropout=dropout, aux_cue_weight=aux_weight, mesh=mesh)
    generator = torch.Generator().manual_seed(seed)
    local = tensors(shard_batch(mesh, batch) if mesh is not None else batch)
    out = {"loss": [], "aux_cue_loss": [], "grad_norm": []}
    for _ in range(steps):
        metrics = step(state, local, generator)
        for key in out:
            out[key].append(metrics[key].item())
    out["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    return out


def check_device_data_refused(cfg):
    """DeviceResidentData under a group of several ranks raises."""
    from soccerdiffusion_tpu_torch.data import WindowedDataset, generate_dummy_arrays
    from soccerdiffusion_tpu_torch.data.pipeline import DeviceResidentData

    config = ModelConfig(**cfg)
    dataset = WindowedDataset.from_dummy(
        generate_dummy_arrays(1, 60, num_joints=config.num_joints, with_images=False), config)
    try:
        DeviceResidentData(dataset, "cpu")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


CHECKS = {"train": check_train, "attention": check_attention,
          "policy_forward": check_policy_forward, "sync_bn": check_sync_bn,
          "rollout": check_rollout, "step": check_step_vs_plain, "checkpoint": check_checkpoint,
          "distill": check_distill, "device_data": check_device_data_refused, "call": check_call}


def main():
    job, out_dir, rank, world, port = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    initialize_distributed(f"tcp://127.0.0.1:{port}", int(world), rank, backend="gloo",
                           device="cpu")
    with open(job, "rb") as f:
        checks = pickle.load(f)
    results = {}
    for name, kind, kwargs in checks:
        t0 = time.perf_counter()
        results[name] = CHECKS[kind](**kwargs)
        results[name]["seconds"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    comm.barrier()


if __name__ == "__main__":
    main()
