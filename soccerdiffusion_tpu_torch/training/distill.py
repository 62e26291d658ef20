"""Sampler distillation: a 30-step DDIM teacher into a few-step (1..K)
student (counterpart of ``soccerdiffusion_tpu/training/distill.py``).

Per batch the frozen teacher encodes the context once (eval mode: the
ResNets' BatchNorm on its running statistics) and rolls out
``distill_teacher_inference_steps`` DDIM steps without autograd, optionally
with classifier-free guidance (two ``denoise`` calls a step, the second on
the context with the guided modalities nulled) or as the mean of K rollouts
from independent noise (``teacher_draws``, rolled out as one batch of K x
B rows). The student takes the teacher's context, detached: with
``student_steps=1`` its one ``denoise`` at t=0 is the trajectory, with K > 1
it runs its own K-step DDIM rollout with gradients through every step. The loss is the MSE against the
teacher's trajectory; AdamW updates only the student's denoiser and step
token (``TRAINABLE``), so its encoders and BatchNorm buffers stay the
teacher's bit for bit.

CLI (the JAX package's arguments, in its order, plus ``--device``):

  python -m soccerdiffusion_tpu_torch.training.distill <config.yaml> <teacher_ckpt>
      [-o out] [--student-steps K] [--guidance SCALE@MOD,...] [--teacher-draws K]
      [--dummy-data | --db db.sqlite3] [--device-data] [--epochs N]
      [--steps-per-epoch N] [--seed S] [--metrics m.jsonl] [--device cuda|cpu]
      [--mesh data=N] [--dist-backend gloo|nccl]

The teacher is a checkpoint of the port or of the JAX package
(``training/checkpoint.py`` reads both), its EMA weights where it keeps an
average. The student starts as a separate copy
of the teacher's weights and buffers and keeps no EMA, so that
``load_policy_checkpoint`` serves its own parameters. The saved
hyperparameters carry ``distilled_decoder: True`` (1 step) or
``distilled_num_steps: K``, and with guidance or draws their provenance
(``distilled_guidance_scale`` / ``distilled_guidance_null`` /
``distilled_teacher_draws``). The data are ``training/train.py``'s:
``--dummy-data``, else the SQLite database at ``--db`` or ``DB_PATH`` (a
missing one raises before any work); ``--device-data`` puts the dataset on
the device once (``DeviceResidentData``, one rank only).

``--mesh`` distils data-parallel over several processes, started as for
``training/train.py`` (torchrun; ``--dist-backend``): the global
``batch_size`` splits over the mesh's batch axes, each rank draws the
global batch's student and teacher noise from the same seed and keeps its
rows (``DistillStep``), the student's gradients are averaged over the batch
axes, and the reported loss and gradient norm are the global ones. The
parameters stay whole on every rank (a ``"model"`` axis replicates them, as
the JAX distiller does); a ``"seq"`` axis carries ``attention_impl:
"ring"``. Rank 0 alone writes the metrics and the checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import logging

import torch
import yaml

from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data.pipeline import (
    DeviceResidentData,
    null_modalities,
    parse_guidance_spec,
    prefetch_to_device,
    prepare_batch,
)
from soccerdiffusion_tpu_torch.diffusion import DiffusionSchedule, ddim_sample, make_schedule
from soccerdiffusion_tpu_torch.inference.sampler import eval_mode
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.parallel import comm, distributed
from soccerdiffusion_tpu_torch.parallel.mesh import Mesh, batch_group, shard_batch, use_mesh
from soccerdiffusion_tpu_torch.training.checkpoint import load_policy_checkpoint, save_checkpoint
from soccerdiffusion_tpu_torch.training.metrics import MetricsLogger
from soccerdiffusion_tpu_torch.training.trainer import (
    Optimizer,
    TrainState,
    create_train_state,
    global_rows,
    lr_at_step,
    make_optimizer,
    sync_gradients,
)

logger = logging.getLogger("soccerdiffusion_tpu_torch")

# the student's modules that distillation trains (the context comes from the
# teacher's encoding, so nothing else receives a gradient)
TRAINABLE = ("diffusion_action_generator", "step_encoding")


class DistillStep:
    """``step(state, teacher, batch, generator) -> metrics``: one student
    update. ``metrics`` holds device tensors: ``loss`` and ``grad_norm``
    (over every parameter of the student, the encoders' zero). With
    ``mesh``, the batch is this rank's rows of the global batch."""

    def __init__(self, model, schedule: DiffusionSchedule, optimizer: Optimizer,
                 teacher_inference_steps: int = 30, student_steps: int = 1,
                 guidance_scale: float = 1.0, guidance_null: tuple[str, ...] = (),
                 teacher_draws: int = 1, mesh: Mesh | None = None):
        if student_steps < 1:
            raise ValueError(f"student_steps must be >= 1, got {student_steps}")
        if teacher_draws < 1:
            raise ValueError(f"teacher_draws must be >= 1, got {teacher_draws}")
        self.model, self.schedule, self.optimizer = model, schedule, optimizer
        self.teacher_inference_steps, self.student_steps = teacher_inference_steps, student_steps
        self.guidance_scale, self.guidance_null = guidance_scale, tuple(guidance_null)
        self.guided = guidance_scale != 1.0 and bool(guidance_null)
        self.teacher_draws = teacher_draws
        self.mesh = mesh
        self.dp_group, self.dp_size, self.dp_index = batch_group(mesh)

    def __call__(self, state: TrainState, teacher, batch: dict[str, torch.Tensor],
                 generator: torch.Generator) -> dict:
        """Draws the student's noise (B, P, J) and, for K > 1 teacher draws,
        the draws' noise (K, B, P, J) from ``generator``, on its device, for
        the global batch (B = rows x the batch axes' ranks), and keeps this
        rank's rows."""
        cfg = self.model.config
        rows, i = batch["joint_command"].shape[0], self.dp_index
        shape = (rows * self.dp_size, cfg.trajectory_prediction_length, cfg.num_joints)
        noise = torch.randn(shape, generator=generator, device=generator.device)
        draw_noise = None
        if self.teacher_draws > 1:
            draw_noise = torch.randn((self.teacher_draws, *shape), generator=generator,
                                     device=generator.device)
            draw_noise = global_rows(draw_noise, rows, i, 1)
        return self.apply(state, teacher, batch, global_rows(noise, rows, i), draw_noise)

    @torch.no_grad()
    def teacher_trajectory(self, teacher, batch: dict, noise: torch.Tensor,
                           draw_noise: torch.Tensor | None):
        """(the teacher's context, its DDIM trajectory): from ``noise``, or the
        mean of the rollouts from each of ``draw_noise``. The K draws roll
        out as one batch of K x B rows (the JAX distiller maps over them in
        turn to bound its memory; a row's rollout is the same function
        either way), summed in draw order."""
        with eval_mode(teacher):
            context = teacher.encode_context(batch)
            if self.guided:
                context_u = teacher.encode_context(null_modalities(batch, self.guidance_null))
            draws = 1 if draw_noise is None else len(draw_noise)
            if draws > 1:
                context_k = context.repeat(draws, 1, 1)
                context_u = context_u.repeat(draws, 1, 1) if self.guided else None
            else:
                context_k = context

            def denoise_fn(x, t):
                tt = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
                eps_c = teacher.denoise(context_k, x, tt)
                if not self.guided:
                    return eps_c
                eps_u = teacher.denoise(context_u, x, tt)
                return eps_u + self.guidance_scale * (eps_c - eps_u)

            rollout = lambda x: ddim_sample(self.schedule, denoise_fn, x,
                                            self.teacher_inference_steps)
            if draw_noise is None:
                return context, rollout(noise)
            trajs = rollout(draw_noise.reshape(-1, *draw_noise.shape[2:])).view(draw_noise.shape)
            total = trajs[0]
            for traj in trajs[1:]:
                total = total + traj
            return context, total / draws

    def apply(self, state: TrainState, teacher, batch: dict[str, torch.Tensor],
              noise: torch.Tensor, draw_noise: torch.Tensor | None = None) -> dict:
        """The step with the given student noise and (K > 1 draws) draw noise,
        of this rank's rows."""
        with use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext():
            return self._apply(state, teacher, batch, noise, draw_noise)

    def _apply(self, state, teacher, batch, noise, draw_noise) -> dict:
        model = self.model
        batch = prepare_batch(batch, keep_u8=model.config.use_images)
        context, target = self.teacher_trajectory(teacher, batch, noise, draw_noise)
        bsz = noise.shape[0]
        model.train()

        def student_denoise(x, t):
            return model.denoise(context, x, torch.full((bsz,), t, dtype=torch.int64,
                                                        device=x.device))

        if self.student_steps == 1:
            pred = student_denoise(noise, 0)
        else:  # a K-step DDIM rollout, with gradients through every step
            pred = ddim_sample(self.schedule, student_denoise, noise, self.student_steps)
        loss = torch.mean((pred.float() - target.float()) ** 2)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss.backward()
        with torch.no_grad():
            # the parameters the loss does not reach have zero gradients, as
            # under jax.grad: they add nothing to the norm
            reached = [p for p in params if p.grad is not None]
            sync_gradients(reached, self.dp_group, self.dp_size)
            grads = [p.grad for p in reached]
            metrics = {"loss": comm.all_reduce_(loss.detach().clone(), self.dp_group) / self.dp_size,
                       "grad_norm": torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))}
            self.optimizer.step(state.step)
            state.step += 1
        return metrics


def make_distill_step(model, schedule: DiffusionSchedule, optimizer: Optimizer,
                      teacher_inference_steps: int = 30, student_steps: int = 1,
                      guidance_scale: float = 1.0, guidance_null: tuple[str, ...] = (),
                      teacher_draws: int = 1, mesh: Mesh | None = None) -> DistillStep:
    """The distillation step of the student ``model`` (its optimizer masked to
    ``TRAINABLE``: ``make_optimizer(..., trainable=TRAINABLE)``).
    ``student_steps=1``: one forward at t=0 is the trajectory; K > 1: a
    differentiable K-step DDIM rollout of the epsilon-predicting student.
    ``guidance_scale != 1`` with ``guidance_null`` runs the teacher with
    classifier-free guidance (guidance distillation: the student bakes it in
    and serves unguided). ``teacher_draws=K > 1`` distils the mean of K
    teacher rollouts from independent noise. ``mesh``: this rank's share of
    a data-parallel step."""
    return DistillStep(model, schedule, optimizer, teacher_inference_steps, student_steps,
                       guidance_scale, guidance_null, teacher_draws, mesh)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Distill the diffusion policy sampler (PyTorch port)")
    parser.add_argument("config", type=str)
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("--output", "-o", type=str, default="distilled_model.ckpt")
    parser.add_argument("--student-steps", type=int, default=1,
                        help="student DDIM steps: 1 = a t=0 forward; K>1 = a few-step "
                             "trajectory-matching student served with T=K")
    parser.add_argument("--guidance", type=str, default=None,
                        help="guidance distillation: SCALE[@MODALITY,...] (e.g. '3.0@image'); the "
                             "teacher's rollout runs with classifier-free guidance")
    parser.add_argument("--teacher-draws", type=int, default=1,
                        help="K>1: distill the mean of K independent-noise teacher rollouts")
    parser.add_argument("--dummy-data", action="store_true")
    parser.add_argument("--device-data", action="store_true",
                        help="put the whole dataset on the device once and gather batches there")
    parser.add_argument("--db", type=str, default=None,
                        help="SQLite dataset (default: DB_PATH, $SOCCERDIFFUSION_TPU_DB_PATH)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--mesh", type=str, default=None,
                        help='mesh shape over the ranks, e.g. "data=4"')
    parser.add_argument("--dist-backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="process-group backend (default: nccl on cards, gloo on the CPU)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return parser, parser.parse_args(argv)


def main(argv=None) -> TrainState:
    started = not distributed.is_initialized()
    try:
        return _main(argv)
    finally:
        if started:
            distributed.shutdown_distributed()


def _main(argv=None) -> TrainState:
    from soccerdiffusion_tpu_torch.training.train import build_dataset, parse_mesh, training_mesh

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    parser, args = parse_args(argv)
    with open(args.config) as f:
        params = yaml.safe_load(f)
    config = Config.from_dict(params)
    g_scale, g_null = 1.0, ()
    if args.guidance is not None:
        try:
            g_scale, g_null = parse_guidance_spec(args.guidance)
        except ValueError as e:
            parser.error(str(e))
        logger.info(f"guidance distillation: teacher CFG w={g_scale:g} nulling {list(g_null)}")
    tc = config.train
    device = distributed.initialize_distributed(backend=args.dist_backend, device=args.device)
    mesh = training_mesh(parse_mesh(args.mesh), tc.batch_size)
    rank0 = distributed.rank() == 0
    epochs = args.epochs if args.epochs is not None else tc.epochs
    dataset = build_dataset(config, args.seed, args.dummy_data, db=args.db)
    steps_per_epoch = len(dataset) // tc.batch_size
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    total_steps = max(1, epochs * steps_per_epoch)

    # the teacher serves what the checkpoint would serve: its EMA weights
    # where it keeps an average; the student is a separate copy of them
    _, state_dict, normalizer, _, _ = load_policy_checkpoint(args.checkpoint)
    teacher = DiffusionPolicy(config.model)
    teacher.load_state_dict(state_dict)
    teacher = teacher.to(device).eval().requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True)
    optimizer = make_optimizer(student, tc.lr, total_steps, tc.weight_decay, trainable=TRAINABLE)
    state = create_train_state(student, optimizer)
    if args.teacher_draws > 1:
        logger.info(f"posterior-mean distillation: teacher target = mean of "
                    f"{args.teacher_draws} independent rollouts")
    step_fn = make_distill_step(student, make_schedule(tc.train_denoising_timesteps), optimizer,
                                teacher_inference_steps=tc.distill_teacher_inference_steps,
                                student_steps=args.student_steps, guidance_scale=g_scale,
                                guidance_null=g_null, teacher_draws=args.teacher_draws,
                                mesh=mesh)
    params = dict(params)
    if args.student_steps == 1:
        params["distilled_decoder"] = True
    else:
        params["distilled_num_steps"] = args.student_steps
    if args.guidance is not None:
        params["distilled_guidance_scale"] = g_scale
        params["distilled_guidance_null"] = list(g_null)
    if args.teacher_draws > 1:
        params["distilled_teacher_draws"] = args.teacher_draws

    device_data = None
    if args.device_data:
        device_data = DeviceResidentData(dataset, device)
        logger.info(f"dataset resident on {device} ({len(device_data)} windows)")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    metrics_logger = MetricsLogger(args.metrics if rank0 else None)
    log_every = max(1, tc.log_every)
    try:
        for epoch in range(epochs):
            if device_data is not None:
                batches = device_data.batches(tc.batch_size, shuffle=True, seed=args.seed + epoch)
            else:
                host = dataset.batches(tc.batch_size, shuffle=True, seed=args.seed + epoch)
                if mesh is not None:
                    host = (shard_batch(mesh, b) for b in host)
                batches = prefetch_to_device(host, device)
            for i, batch in enumerate(batches):
                if i >= steps_per_epoch:
                    batches.close()
                    break
                metrics = step_fn(state, teacher, batch, generator)
                if rank0 and (state.step % log_every == 0 or i == steps_per_epoch - 1):
                    metrics_logger.log(state.step - 1, {
                        "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                        "lr": lr_at_step(tc.lr, total_steps, state.step - 1), "epoch": epoch})
            save_checkpoint(args.output, state, normalizer, params, epoch)
            if rank0:
                logger.info(f"epoch {epoch} done; distilled checkpoint -> {args.output}")
    finally:
        metrics_logger.close()
    return state


if __name__ == "__main__":
    main()
