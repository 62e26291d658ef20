"""End-to-end diffusion training (counterpart of
``soccerdiffusion_tpu/training/train.py``):

  python -m soccerdiffusion_tpu_torch.training.train -c config.yaml [-p ckpt_dir]
      [-o out_dir] [--dummy-data | --db db.sqlite3] [--packed [shard_dir] | --device-data]
      [--epochs N] [--steps-per-epoch N] [--seed S] [--metrics metrics.jsonl]
      [--decoder-pretraining] [--pretrained-decoder ckpt_dir] [--device cuda|cpu]
      [--pretrained-weights resnet.pth] [--mesh data=2,model=2] [--dist-backend gloo|nccl]

Config-or-checkpoint hyperparameters (the config wins, with warnings for
keys that differ), the normaliser fitted on ``num_normalization_samples``
random target chunks, a checkpoint per epoch with the hyperparameters
embedded, and resume restoring the model, optimizer, EMA and the
BatchNorm running statistics (``state_dict`` buffers). The model starts
from flax's default initialisers (``flax_init_params``); with
``--pretrained-weights`` the ResNet image encoder's backbone is read from a
local torchvision state dict (``utils/torchvision_weights.py``), without it
the encoder starts from its random init and the log says so (the JAX
trainer's outcome where ImageNet weights cannot be fetched). ``train``
runs the loop from a ``Config`` and needs no YAML. The log gives the
step's model FLOPs once at the start (``utils/profiling.py:estimate_flops``:
counted on the unfused layers, the same whatever implements the step), and
every metrics line ``steps_per_sec`` (the logging window's, on the host
clock between the window's device syncs: one per window) and ``mfu``, the
run's ``MFUMeter`` over every window so far against the peak of the
device's ``compute_dtype`` times the ranks (one a device), as the JAX
package's; ``null`` on a card without a published peak.

Data: ``--dummy-data`` (the synthetic recordings, frames drawn at the
config's ``image_resolution``), else the SQLite database at ``--db`` or at
``DB_PATH`` (``WindowedDataset.from_sqlite``, frames streamed per window and
resized to ``image_resolution``); a missing database raises before any work.
``--packed`` trains from a ``PackedDataset`` (frames resized once, uint8:
whole frames for the ResNet and Swin encoders, pre-patchified for the ViT;
the rows by the C++ assembler); ``--packed DIR`` reads the shards ``cli
pack`` wrote there instead (``PackedDataset.load``, memory-mapped; a config
of the pack's geometry); ``--device-data`` puts the whole dataset on
the device once (``DeviceResidentData``; not with ``--packed``).
``boundary_oversample`` re-draws that share of each epoch's windows from
those where a camera frame has just arrived, as the JAX trainer does.
``--pretrained-decoder`` copies a checkpoint's raw (not EMA) parameters of
``diffusion_action_generator`` and ``step_encoding`` into the model after
any resume: the second half of ``--decoder-pretraining``.
``image_encoder_lr_mult`` scales the image encoder's AdamW update;
``aux_cue_weight`` trains the cue head on the dataset's ``vision_u`` labels
and is switched off, with a warning, where the dataset has none (only the
dummy "vision" task's windows carry them; a ``PackedDataset`` emits none).

Several processes (``parallel/``): start one per rank with
``python -m torch.distributed.run --nproc_per_node=N -m
soccerdiffusion_tpu_torch.training.train ... --mesh data=N``; each joins the
process group from torchrun's environment (``initialize_distributed``:
``nccl`` on the cards, one rank a card, ``gloo`` on the CPU;
``--dist-backend gloo`` with ``--device cuda:0`` puts every rank on one
card). ``--mesh`` (else ``train.mesh_shape``, JAX's syntax) lays the ranks
out: ``batch_size`` is the global batch, split over ``"data"`` (and
``"dcn"``), and must divide by them; a ``"model"`` axis splits the
transformer projections (``parallel/tensor_parallel.py``); a ``"seq"`` axis
carries ``attention_impl: "ring"``. Every rank builds the same model and
iterates the same seeded global batches, keeping its rows
(``shard_batch``); rank 0 alone writes the metrics JSONL and the
checkpoints, which are the single-process ones, and resume loads them on
every rank. ``--device-data`` holds the whole dataset on one device and is
refused under several ranks. A mesh that does not match the number of
processes raises.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.data.pipeline import DeviceResidentData, prefetch_to_device
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.parallel import distributed
from soccerdiffusion_tpu_torch.parallel.mesh import batch_group, make_mesh, shard_batch
from soccerdiffusion_tpu_torch.parallel.tensor_parallel import shard_model
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from soccerdiffusion_tpu_torch.training.metrics import MetricsLogger
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params
from soccerdiffusion_tpu_torch.utils.profiling import MFUMeter, device_peak_flops, estimate_flops
from soccerdiffusion_tpu_torch.utils.torchvision_weights import load_imagenet_backbone

logger = logging.getLogger("soccerdiffusion_tpu_torch")


@dataclass
class RunOptions:
    """What ``train`` takes besides the ``Config``: the CLI's flags."""

    output: str = "trajectory_transformer_model.ckpt"
    checkpoint: str | None = None
    dummy_data: bool = True
    packed: bool | str = False  # or the directory of `cli pack`'s shards
    epochs: int | None = None
    steps_per_epoch: int | None = None
    seed: int = 0
    metrics: str | None = None
    decoder_pretraining: bool = False
    device: str = "cuda"  # the card unless the caller asks for the CPU
    pretrained_weights: str | None = None  # a torchvision ResNet state dict (.pth)
    db: str | None = None  # the SQLite dataset without dummy_data (None: DB_PATH)
    device_data: bool = False
    pretrained_decoder: str | None = None  # a checkpoint whose decoder and step token to load
    mesh: dict[str, int] | None = None  # overrides train.mesh_shape
    dist_backend: str | None = None  # None: nccl on cards, gloo on the CPU
    # end the run after this many optimizer steps, the schedule still that of
    # ``epochs`` (the first steps of a longer run); None runs every epoch
    max_steps: int | None = None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the diffusion policy (PyTorch port)")
    parser.add_argument("--config", "-c", type=str, default=None)
    parser.add_argument("--checkpoint", "-p", type=str, default=None)
    parser.add_argument("--output", "-o", type=str, default="trajectory_transformer_model.ckpt")
    parser.add_argument("--decoder-pretraining", action="store_true")
    parser.add_argument("--pretrained-decoder", type=str, default=None,
                        help="checkpoint whose raw diffusion_action_generator and step_encoding "
                             "parameters are loaded (after any resume)")
    parser.add_argument("--dummy-data", action="store_true",
                        help="train on the synthetic array backend")
    parser.add_argument("--db", type=str, default=None,
                        help="SQLite dataset (default: DB_PATH, $SOCCERDIFFUSION_TPU_DB_PATH)")
    parser.add_argument("--packed", nargs="?", const=True, default=False, metavar="SHARD_DIR",
                        help="train from the packed dataset (uint8 frames, pre-patchified for "
                             "the ViT); with a directory, from the shards `cli pack` wrote there")
    parser.add_argument("--device-data", action="store_true",
                        help="put the whole dataset on the device once and gather batches there")
    parser.add_argument("--epochs", type=int, default=None, help="override epochs")
    parser.add_argument("--steps-per-epoch", type=int, default=None,
                        help="cap steps per epoch (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics", type=str, default=None, help="metrics JSONL path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda; 'cpu' runs the plain versions)")
    parser.add_argument("--pretrained-weights", type=str, default=None,
                        help="local torchvision resnet18 / resnet50 state dict (.pth) for the "
                             "ResNet image encoder's backbone")
    parser.add_argument("--mesh", type=str, default=None,
                        help='mesh shape over the ranks, e.g. "data=4" or "data=2,model=2" '
                             "(default: train.mesh_shape)")
    parser.add_argument("--dist-backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="process-group backend (default: nccl on cards, gloo on the CPU; "
                             "gloo lets several ranks share one card)")
    return parser.parse_args(argv)


def parse_mesh(spec: str | None) -> dict[str, int]:
    """``"data=4,model=2"`` -> {"data": 4, "model": 2}; None or "" -> {}."""
    if not spec:
        return {}
    return {k: int(v) for k, v in (kv.split("=") for kv in spec.split(","))}


def training_mesh(mesh_shape: dict[str, int] | None, batch_size: int):
    """The mesh over the process group's ranks (None for one rank); raises
    where the shape does not match the ranks or the global batch does not
    split over the batch axes."""
    mesh = make_mesh(mesh_shape or None)
    if mesh.size == 1:
        return None
    _, ranks, _ = batch_group(mesh)
    if batch_size % ranks:
        raise ValueError(f"batch_size {batch_size} (the global batch) does not divide by the "
                         f"{ranks} ranks of the mesh's batch axes ({mesh.shape})")
    return mesh


def resolve_params(args) -> dict:
    """Config-or-checkpoint hyperparameters; the config wins."""
    if not (args.config or args.checkpoint):
        raise SystemExit("either a config file (-c) or a checkpoint (-p) is required")
    params: dict = {}
    if args.checkpoint:
        params = load_checkpoint(args.checkpoint)["hyperparams"]
    if args.config:
        import yaml

        with open(args.config) as f:
            config_params = yaml.safe_load(f)
        for key, value in config_params.items():
            if args.checkpoint and key in params and value != params[key]:
                logger.warning(f"key '{key}' differs from checkpoint: {params[key]} != {value}")
        params = config_params
    return params


def database_path(db: str | None) -> str:
    """``db``, else ``DB_PATH``; raises ``FileNotFoundError`` naming the path
    where there is no database."""
    if db is None:
        from soccerdiffusion_tpu_torch import DB_PATH

        db = DB_PATH
    if not Path(db).is_file():
        raise FileNotFoundError(f"no SQLite dataset at {db} (pass --db PATH, set "
                                "SOCCERDIFFUSION_TPU_DB_PATH, or train with --dummy-data)")
    return db


def build_dataset(config: Config, seed: int, dummy_data: bool, packed: bool | str = False,
                  db: str | None = None) -> WindowedDataset | PackedDataset:
    """The synthetic recordings (``dummy_data``) or the SQLite database at
    ``db`` (default ``DB_PATH``), packed with ``packed``; or, where
    ``packed`` is a directory, the shards ``cli pack`` wrote there."""
    m = config.model
    if isinstance(packed, str):
        dataset = PackedDataset.load(packed, m)
        if m.use_images and m.image_encoder_type == "vit":
            dataset.prepatchify_images(m.vit_patch_size)
        return dataset
    if dummy_data:
        n = max(600, m.action_context_length + m.trajectory_prediction_length + 200)
        dummy = generate_dummy_arrays(num_recordings=2, num_samples=n, num_joints=m.num_joints,
                                      with_images=m.use_images, image_size=m.image_resolution,
                                      seed=seed, task=config.train.dummy_task)
        dataset = WindowedDataset.from_dummy(dummy, m)
    else:
        dataset = WindowedDataset.from_sqlite(database_path(db), m)
    if packed:
        dataset = PackedDataset.from_windowed(dataset)
        if m.use_images and m.image_encoder_type == "vit":
            dataset.prepatchify_images(m.vit_patch_size)  # batches in the patch layout
    return dataset


def has_cue_labels(dataset) -> bool:
    """Whether the dataset's windows carry ``vision_u`` (the aux cue head's
    labels: the dummy "vision" task's ``WindowedDataset``)."""
    return isinstance(dataset, WindowedDataset) and "vision_u" in dataset[0]


@torch.no_grad()
def load_pretrained_decoder(model: torch.nn.Module, path: str) -> list[str]:
    """Copy the raw (not EMA) ``diffusion_action_generator.*`` and
    ``step_encoding.*`` parameters of the checkpoint at ``path`` into
    ``model``; every other parameter stays. Returns the names copied."""
    raw = load_checkpoint(path)["params"]
    tp = getattr(model, "tensor_parallel", None)
    copied = []
    for name, p in model.named_parameters():
        if name.split(".")[0] in ("diffusion_action_generator", "step_encoding") and name in raw:
            value = raw[name] if tp is None else tp.local(name, raw[name])
            if value.shape != p.shape:
                raise ValueError(f"{path}: {name} has shape {tuple(raw[name].shape)}, the model's "
                                 f"{tuple(p.shape)}")
            p.copy_(value)
            copied.append(name)
    return copied


def epoch_order(dataset, boundary: np.ndarray | None, frac: float, seed: int) -> np.ndarray | None:
    """The epoch's window order under boundary oversampling, or None (the
    dataset's own shuffle) when there is nothing to oversample."""
    if boundary is None or not len(boundary):
        return None
    return WindowedDataset.oversampled_order(len(dataset), boundary, frac,
                                             np.random.default_rng(seed))


def train(config: Config, opts: RunOptions, hyperparams: dict | None = None):
    """The training loop on ``opts.device`` (this rank's, under several
    processes); returns the final ``TrainState``."""
    tc = config.train
    epochs = opts.epochs if opts.epochs is not None else tc.epochs
    device = distributed.initialize_distributed(backend=opts.dist_backend, device=opts.device)
    mesh = training_mesh(opts.mesh if opts.mesh is not None else tc.mesh_shape, tc.batch_size)
    rank0 = distributed.rank() == 0
    if opts.device_data and opts.packed:
        raise ValueError("--device-data cannot be combined with --packed: DeviceResidentData "
                         "stacks per-window items, which a PackedDataset does not have")
    dataset = build_dataset(config, opts.seed, opts.dummy_data, opts.packed, opts.db)
    steps_per_epoch = len(dataset) // tc.batch_size
    if opts.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, opts.steps_per_epoch)
    total_steps = max(1, epochs * steps_per_epoch)
    logger.info(f"device {device}; dataset: {len(dataset)} windows, {steps_per_epoch} steps/epoch")
    normalizer = Normalizer.fit(dataset.sample_targets(tc.num_normalization_samples, seed=opts.seed))

    model = DiffusionPolicy(config.model)
    model = load_jax_params(model, *flax_init_params(model, opts.seed))
    m = config.model
    if opts.pretrained_weights:
        load_imagenet_backbone(model, opts.pretrained_weights)
        logger.info(f"image encoder backbone initialized from {opts.pretrained_weights}")
    elif m.use_images and m.image_encoder_type in ("resnet18", "resnet50"):
        logger.info("no --pretrained-weights: the ResNet image encoder starts from its random "
                    "init (the reference starts from ImageNet weights)")
    model = model.to(device)
    if mesh is not None:
        shard_model(model, mesh)
    lr_mults = None
    if m.use_images and tc.image_encoder_lr_mult != 1.0:
        lr_mults = {"image_sequence_encoder": tc.image_encoder_lr_mult}
        logger.info(f"image_sequence_encoder LR x{tc.image_encoder_lr_mult:g}")
    optimizer = make_optimizer(model, tc.lr, total_steps, tc.weight_decay,
                               flat=tc.flat_optimizer, module_lr_mults=lr_mults,
                               grad_clip_norm=tc.grad_clip_norm)
    state = create_train_state(model, optimizer, ema=tc.ema_decay > 0.0)
    start_epoch = 0
    if opts.checkpoint:
        ckpt = load_checkpoint(opts.checkpoint, state)
        normalizer = ckpt["norm"]
        start_epoch = ckpt["current_epoch"] + 1
        logger.info(f"resumed from {opts.checkpoint} at epoch {start_epoch}")
    if opts.pretrained_decoder:
        copied = load_pretrained_decoder(model, opts.pretrained_decoder)
        logger.info(f"loaded {len(copied)} pretrained decoder tensors from {opts.pretrained_decoder}")
    aux_cue_weight = tc.aux_cue_weight
    if aux_cue_weight > 0.0 and not has_cue_labels(dataset):
        logger.warning("aux_cue_weight set but the dataset exposes no vision_u labels "
                       "(camera-cued dummy task only); disabling the aux cue loss")
        aux_cue_weight = 0.0
    step_fn = make_train_step(model, make_schedule(tc.train_denoising_timesteps), optimizer,
                              normalizer, decoder_pretraining=opts.decoder_pretraining,
                              ema_decay=tc.ema_decay, modality_dropout=tc.modality_dropout,
                              aux_cue_weight=aux_cue_weight, mesh=mesh)
    device_data = None
    if opts.device_data:
        device_data = DeviceResidentData(dataset, device)
        logger.info(f"dataset resident on {device} ({len(device_data)} windows)")
    boundary = None
    if tc.boundary_oversample > 0.0:
        boundary = dataset.image_boundary_indices()
        logger.info(f"boundary oversampling {tc.boundary_oversample:g}: {len(boundary)} boundary "
                    f"windows of {len(dataset)}")
    generator = torch.Generator(device=device).manual_seed(opts.seed)
    # MFU accounting (a north-star metric; BASELINE.md), over the global batch
    flops_per_step = estimate_flops(model, m, tc.batch_size)
    meter = MFUMeter(flops_per_step, num_devices=distributed.world_size(),
                     peak_flops=device_peak_flops(device, m.compute_dtype))
    logger.info(f"train step FLOPs (counted on the unfused layers, B={tc.batch_size}): "
                f"{flops_per_step:.3e} ({flops_per_step})")
    metrics_logger = MetricsLogger(opts.metrics if rank0 else None)
    log_every = max(1, tc.log_every)
    hyperparams = config.to_dict() if hyperparams is None else hyperparams
    try:
        for epoch in range(start_epoch, epochs):
            window, t0 = 0, time.perf_counter()
            meter.start()
            order = epoch_order(dataset, boundary, tc.boundary_oversample, opts.seed + epoch)
            if device_data is not None:
                batches = device_data.batches(tc.batch_size, shuffle=True, seed=opts.seed + epoch,
                                              order=order)
            else:
                host = dataset.batches(tc.batch_size, shuffle=True, seed=opts.seed + epoch,
                                       order=order)
                if mesh is not None:  # every rank draws the global batch and keeps its rows
                    host = (shard_batch(mesh, b) for b in host)
                batches = prefetch_to_device(host, device)
            for i, batch in enumerate(batches):
                if i >= steps_per_epoch or state.step == opts.max_steps:
                    batches.close()
                    break
                metrics = step_fn(state, batch, generator)
                window += 1
                if state.step % log_every == 0 and rank0:
                    loss = float(metrics["loss"])  # the window's one device sync
                    now = time.perf_counter()
                    meter.stop(window)
                    metrics_logger.log(state.step - 1, {
                        "loss": loss, "grad_norm": metrics["grad_norm"],
                        **({"aux_cue_loss": metrics["aux_cue_loss"]}
                           if "aux_cue_loss" in metrics else {}),
                        "lr": lr_at_step(tc.lr, total_steps, state.step - 1), "epoch": epoch,
                        "mfu": meter.mfu, "steps_per_sec": window / (now - t0)},
                        grads=metrics["grad_norms_by_layer"])
                    window, t0 = 0, now
                    meter.start()
            if window and rank0:
                float(metrics["loss"])  # the epoch's last, partial window ends in a sync too
                meter.stop(window)
            else:
                meter.cancel()
            save_checkpoint(opts.output, state, normalizer, hyperparams, epoch)
            if rank0:
                logger.info(f"epoch {epoch} done; checkpoint -> {opts.output}")
            if state.step == opts.max_steps:
                break
    finally:
        metrics_logger.close()
    return state


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    params = resolve_params(args)
    if args.epochs is not None:
        params["epochs"] = args.epochs
    opts = RunOptions(output=args.output, checkpoint=args.checkpoint, dummy_data=args.dummy_data,
                      packed=args.packed, epochs=args.epochs,
                      steps_per_epoch=args.steps_per_epoch, seed=args.seed,
                      metrics=args.metrics, decoder_pretraining=args.decoder_pretraining,
                      device=args.device, pretrained_weights=args.pretrained_weights, db=args.db,
                      device_data=args.device_data, pretrained_decoder=args.pretrained_decoder,
                      mesh=parse_mesh(args.mesh) if args.mesh else None,
                      dist_backend=args.dist_backend)
    started = not distributed.is_initialized()
    try:
        return train(Config.from_dict(params), opts, hyperparams=params)
    finally:
        if started:
            distributed.shutdown_distributed()


if __name__ == "__main__":
    main()
