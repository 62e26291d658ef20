"""End-to-end diffusion training (counterpart of
``soccerdiffusion_tpu/training/train.py``):

  python -m soccerdiffusion_tpu_torch.training.train -c config.yaml [-p ckpt_dir]
      [-o out_dir] [--dummy-data] [--packed] [--epochs N] [--steps-per-epoch N]
      [--seed S] [--metrics metrics.jsonl] [--decoder-pretraining] [--device cuda|cpu]
      [--pretrained-weights resnet.pth]

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
runs the loop from a ``Config`` and needs no YAML. The log reports steps/s
(host clock, one device sync per logging window) where the JAX package
reports its TPU MFU meter.

Only the synthetic dataset (``--dummy-data``, frames drawn at the config's
``image_resolution``) is ported: the SQLite dataset comes with
``WindowedDataset.from_sqlite`` (see ROADMAP.md). ``--packed`` trains from a
``PackedDataset`` (uint8 frames: whole frames for the ResNet and Swin
encoders, pre-patchified for the ViT);
``boundary_oversample`` re-draws that share of each epoch's windows from
those where a camera frame has just arrived, as the JAX trainer does.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.data.pipeline import prefetch_to_device
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from soccerdiffusion_tpu_torch.training.metrics import MetricsLogger
from soccerdiffusion_tpu_torch.training.trainer import (
    create_train_state,
    lr_at_step,
    make_optimizer,
    make_train_step,
)
from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params
from soccerdiffusion_tpu_torch.utils.torchvision_weights import load_imagenet_backbone

logger = logging.getLogger("soccerdiffusion_tpu_torch")


@dataclass
class RunOptions:
    """What ``train`` takes besides the ``Config``: the CLI's flags."""

    output: str = "trajectory_transformer_model.ckpt"
    checkpoint: str | None = None
    dummy_data: bool = True
    packed: bool = False
    epochs: int | None = None
    steps_per_epoch: int | None = None
    seed: int = 0
    metrics: str | None = None
    decoder_pretraining: bool = False
    device: str = "cuda"  # the card unless the caller asks for the CPU
    pretrained_weights: str | None = None  # a torchvision ResNet state dict (.pth)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the diffusion policy (PyTorch port)")
    parser.add_argument("--config", "-c", type=str, default=None)
    parser.add_argument("--checkpoint", "-p", type=str, default=None)
    parser.add_argument("--output", "-o", type=str, default="trajectory_transformer_model.ckpt")
    parser.add_argument("--decoder-pretraining", action="store_true")
    parser.add_argument("--dummy-data", action="store_true",
                        help="train on the synthetic array backend")
    parser.add_argument("--packed", action="store_true",
                        help="train from the packed dataset (uint8 frames, pre-patchified for the ViT)")
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
    return parser.parse_args(argv)


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


def build_dataset(config: Config, seed: int, dummy_data: bool,
                  packed: bool = False) -> WindowedDataset | PackedDataset:
    if not dummy_data:
        raise NotImplementedError("the SQLite dataset is not ported yet (see ROADMAP.md); "
                                  "use --dummy-data")
    m = config.model
    n = max(600, m.action_context_length + m.trajectory_prediction_length + 200)
    dummy = generate_dummy_arrays(num_recordings=2, num_samples=n, num_joints=m.num_joints,
                                  with_images=m.use_images, image_size=m.image_resolution,
                                  seed=seed, task=config.train.dummy_task)
    dataset = WindowedDataset.from_dummy(dummy, m)
    if packed:
        dataset = PackedDataset.from_windowed(dataset)
        if m.use_images and m.image_encoder_type == "vit":
            dataset.prepatchify_images(m.vit_patch_size)  # batches in the patch layout
    return dataset


def epoch_order(dataset, boundary: np.ndarray | None, frac: float, seed: int) -> np.ndarray | None:
    """The epoch's window order under boundary oversampling, or None (the
    dataset's own shuffle) when there is nothing to oversample."""
    if boundary is None or not len(boundary):
        return None
    return WindowedDataset.oversampled_order(len(dataset), boundary, frac,
                                             np.random.default_rng(seed))


def train(config: Config, opts: RunOptions, hyperparams: dict | None = None):
    """The training loop on ``opts.device``; returns the final ``TrainState``."""
    tc = config.train
    epochs = opts.epochs if opts.epochs is not None else tc.epochs
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={opts.device!r} requested but CUDA is not available "
                           "(pass device='cpu' / --device cpu for the CPU)")
    dataset = build_dataset(config, opts.seed, opts.dummy_data, opts.packed)
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
    optimizer = make_optimizer(model, tc.lr, total_steps, tc.weight_decay,
                               flat=tc.flat_optimizer,
                               module_lr_mults={"image_sequence_encoder": tc.image_encoder_lr_mult},
                               grad_clip_norm=tc.grad_clip_norm)
    state = create_train_state(model, optimizer, ema=tc.ema_decay > 0.0)
    start_epoch = 0
    if opts.checkpoint:
        ckpt = load_checkpoint(opts.checkpoint, state)
        normalizer = ckpt["norm"]
        start_epoch = ckpt["current_epoch"] + 1
        logger.info(f"resumed from {opts.checkpoint} at epoch {start_epoch}")
    step_fn = make_train_step(model, make_schedule(tc.train_denoising_timesteps), optimizer,
                              normalizer, decoder_pretraining=opts.decoder_pretraining,
                              ema_decay=tc.ema_decay, modality_dropout=tc.modality_dropout,
                              aux_cue_weight=tc.aux_cue_weight)
    boundary = None
    if tc.boundary_oversample > 0.0:
        boundary = dataset.image_boundary_indices()
        logger.info(f"boundary oversampling {tc.boundary_oversample:g}: {len(boundary)} boundary "
                    f"windows of {len(dataset)}")
    generator = torch.Generator(device=device).manual_seed(opts.seed)
    metrics_logger = MetricsLogger(opts.metrics)
    log_every = max(1, tc.log_every)
    hyperparams = config.to_dict() if hyperparams is None else hyperparams
    try:
        for epoch in range(start_epoch, epochs):
            window, t0 = 0, time.perf_counter()
            order = epoch_order(dataset, boundary, tc.boundary_oversample, opts.seed + epoch)
            batches = prefetch_to_device(
                dataset.batches(tc.batch_size, shuffle=True, seed=opts.seed + epoch, order=order),
                device)
            for i, batch in enumerate(batches):
                if i >= steps_per_epoch:
                    batches.close()
                    break
                metrics = step_fn(state, batch, generator)
                window += 1
                if state.step % log_every == 0:
                    loss = float(metrics["loss"])  # the window's one device sync
                    now = time.perf_counter()
                    metrics_logger.log(state.step - 1, {
                        "loss": loss, "grad_norm": metrics["grad_norm"],
                        "lr": lr_at_step(tc.lr, total_steps, state.step - 1), "epoch": epoch,
                        "steps_per_sec": window / (now - t0)},
                        grads=metrics["grad_norms_by_layer"])
                    window, t0 = 0, now
            save_checkpoint(opts.output, state, normalizer, hyperparams, epoch)
            logger.info(f"epoch {epoch} done; checkpoint -> {opts.output}")
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
                      device=args.device, pretrained_weights=args.pretrained_weights)
    return train(Config.from_dict(params), opts, hyperparams=params)


if __name__ == "__main__":
    main()
