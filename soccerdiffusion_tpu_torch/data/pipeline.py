"""Batch preparation, the ViT patch layout and the host -> device prefetch
(counterpart of ``prepare_batch``, ``device_normalize_images``,
``patchify_frames`` and ``prefetch_to_device`` in
``soccerdiffusion_tpu/data/pipeline.py``).

Packed batches carry frames as uint8 (``image_u8``, whole frames or
pre-patchified) with an ``image_valid`` mask; they stay uint8 through
pinning and the host -> device copy, and are normalised on the device.

The classifier-free-guidance modality surface (``MODALITY_KEYS``,
``parse_guidance_spec``, ``inactive_guidance_modalities``,
``null_modalities``) and the training-time conditioning dropout
(``dropout_modalities``) follow the JAX module. The dropout is split in two:
``draw_dropout_masks`` draws the five per-sample masks from an explicit
``torch.Generator``, ``apply_dropout_masks`` applies given masks, so that a
test can feed the masks the JAX package draws.

``DeviceResidentData`` puts a whole dataset on the device once and gathers
each batch there by index, in the order of ``WindowedDataset.batches``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def device_normalize_images(u8: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """uint8 frame windows (..., H, W, 3) or pre-patchified (..., patches,
    P*P*3) and their validity mask (...) -> float32 frames scaled to [0, 1],
    normalised with the ImageNet statistics, padded frames zeroed."""
    from soccerdiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.as_tensor(IMAGENET_MEAN, device=u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=u8.device)
    if u8.shape[-1] != 3:  # pre-patchified: the channels repeat every 3 along the last axis
        reps = u8.shape[-1] // 3
        x = (u8.float() / 255.0 - mean.repeat(reps)) / std.repeat(reps)
        return x * valid[..., None, None]
    x = (u8.float() / 255.0 - mean) / std
    return x * valid[..., None, None, None]


def patchify_frames(frames, patch: int):
    """(..., H, W, C) -> (..., (H // P) (W // P), P*P*C), numpy or torch, any
    dtype: the ViT's patch layout (patches row-major, each patch's pixels
    row-major with channels last)."""
    *lead, h, w, c = frames.shape
    p = patch
    x = frames.reshape(*lead, h // p, p, w // p, p, c)
    n = x.ndim
    perm = (*range(n - 5), n - 5, n - 3, n - 4, n - 2, n - 1)
    x = x.transpose(perm) if isinstance(x, np.ndarray) else x.permute(perm)
    return x.reshape(*lead, (h // p) * (w // p), p * p * c)


def prepare_batch(batch: dict, keep_u8: bool = False) -> dict:
    """Materialise normalised ``image_data`` from a packed uint8 batch
    (``image_u8`` + ``image_valid``); float batches pass through. With
    ``keep_u8`` the uint8 frames stay for a model that takes them raw (the
    ViT folds the normalisation into its patch embedding)."""
    if "image_u8" not in batch or keep_u8:
        return batch
    batch = dict(batch)
    u8, valid = batch.pop("image_u8"), batch.pop("image_valid")
    batch["image_data"] = device_normalize_images(u8, valid)
    return batch


#: modality name -> the batch keys it covers (the conditioning surface of
#: DiffusionPolicy.encode_context). "all" nulls every conditioning modality
#: (the fully unconditional CFG branch).
MODALITY_KEYS = {
    "action_history": ("joint_command_history",),
    "joint_states": ("joint_state",),
    "imu": ("rotation",),
    "image": ("image_u8", "image_valid", "image_data"),
    "game_state": ("game_state",),
}

# the order of the masks draw_dropout_masks draws (the JAX package's split of
# the dropout key into five)
DROPOUT_MODALITIES = ("action_history", "joint_states", "imu", "image", "game_state")


def _identity_rotation(rot: torch.Tensor) -> torch.Tensor:
    """The IMU's "missing data" value: the identity quaternion [0, 0, 0, 1],
    or [1, 0, 0, 0, 1] in the five-dim encoding."""
    value = [1.0, 0.0, 0.0, 0.0, 1.0] if rot.shape[-1] == 5 else [0.0, 0.0, 0.0, 1.0]
    return torch.tensor(value, dtype=rot.dtype, device=rot.device)


def _unknown_game_state(gs: torch.Tensor) -> torch.Tensor:
    from soccerdiffusion_tpu_torch.data.schema import RobotState

    return torch.full_like(gs, int(RobotState.UNKNOWN))


def parse_guidance_spec(spec: str) -> tuple[float, tuple[str, ...]]:
    """The CLI guidance spec ``SCALE[@MODALITY,...]`` (e.g. ``'2.0@image'``)
    -> ``(scale, null_modalities)``; the modality defaults to ``image``.
    Raises ``ValueError`` on a scale that is not a number or an unknown
    modality."""
    scale_s, _, mods_s = spec.partition("@")
    try:
        scale = float(scale_s)
    except ValueError:
        raise ValueError(
            f"bad guidance spec {spec!r}: scale {scale_s!r} is not a number; "
            "expected SCALE[@MODALITY,...], e.g. '2.0@image'") from None
    mods = tuple(mods_s.split(",")) if mods_s else ("image",)
    for mod in mods:
        if mod != "all" and mod not in MODALITY_KEYS:
            raise ValueError(
                f"bad guidance spec {spec!r}: unknown modality {mod!r}; "
                f"expected one of {sorted(MODALITY_KEYS)} or 'all'")
    return scale, mods


def inactive_guidance_modalities(model_config, modalities) -> list[str]:
    """The modalities of ``modalities`` that ``model_config`` never conditions
    on: nulling them changes nothing (eps_u == eps_c), so guidance over them
    pays the doubled batch for an unguided sample."""
    names = tuple(MODALITY_KEYS) if "all" in modalities else tuple(modalities)
    off = {"image": not model_config.use_images, "game_state": not model_config.use_gamestate}
    return [m for m in names if off.get(m, False)]


def null_modalities(batch: dict, modalities) -> dict:
    """``batch`` with whole modalities replaced, for every sample, by their
    "missing data" value (the values ``dropout_modalities`` uses): the CFG
    unconditional branch. ``modalities``: names of ``MODALITY_KEYS``, or
    ``"all"``. Unknown names raise; modalities the batch lacks are skipped.
    A batch of cached image encodings (``image_tokens``) cannot null its
    image modality (the null is the zero frame, whose encoding is not zero)
    and raises."""
    if isinstance(modalities, str):
        modalities = (modalities,)
    names: tuple[str, ...] = tuple(modalities)
    if "all" in names:
        names = tuple(MODALITY_KEYS)
    for name in names:
        if name not in MODALITY_KEYS:
            raise ValueError(f"unknown modality {name!r}; expected one of "
                             f"{sorted(MODALITY_KEYS)} or 'all'")
    batch = dict(batch)
    for name in names:
        if name in ("action_history", "joint_states"):
            (key,) = MODALITY_KEYS[name]
            if key in batch:
                batch[key] = torch.zeros_like(batch[key])
        elif name == "imu":
            if "rotation" in batch:
                rot = batch["rotation"]
                batch["rotation"] = _identity_rotation(rot).expand(rot.shape).contiguous()
        elif name == "image":
            if "image_tokens" in batch:
                raise ValueError(
                    "cannot null the 'image' modality of a cached-token batch (image_tokens are "
                    "encodings, not frames); serve guidance with cache_image_tokens=False")
            for key in ("image_u8", "image_data", "image_valid"):
                if key in batch:
                    batch[key] = torch.zeros_like(batch[key])
        elif name == "game_state":
            if "game_state" in batch:
                batch["game_state"] = _unknown_game_state(batch["game_state"])
    return batch


def draw_dropout_masks(batch_size: int, p: float, generator: torch.Generator) -> torch.Tensor:
    """(5, B) bool: per sample, whether each of ``DROPOUT_MODALITIES`` is
    dropped, each with probability ``p``, drawn on the generator's device."""
    u = torch.rand((len(DROPOUT_MODALITIES), batch_size), generator=generator,
                   device=generator.device)
    return u < p


def apply_dropout_masks(batch: dict, masks: torch.Tensor) -> dict:
    """Per-sample conditioning dropout under given (5, B) masks (the order of
    ``DROPOUT_MODALITIES``): a dropped sample's modality takes its "missing
    data" value (zeros for the joint histories, the identity rotation,
    zeroed and invalid frames, the UNKNOWN game state); where the camera was
    dropped, the aux cue label ``vision_u`` is marked invalid too. The
    target chunk is never touched."""
    batch = dict(batch)
    masks = masks.to(batch["joint_command"].device, torch.bool)
    bsz = masks.shape[1]
    m_hist, m_js, m_imu, m_img, m_gs = masks
    for name, m in (("joint_command_history", m_hist), ("joint_state", m_js)):
        if name in batch:
            batch[name] = torch.where(m[:, None, None], torch.zeros_like(batch[name]), batch[name])
    if "rotation" in batch:
        rot = batch["rotation"]
        batch["rotation"] = torch.where(m_imu[:, None, None], _identity_rotation(rot), rot)
    if "image_u8" in batch:
        u8 = batch["image_u8"]
        batch["image_u8"] = torch.where(m_img.reshape(bsz, *(1,) * (u8.ndim - 1)),
                                        torch.zeros_like(u8), u8)
        valid = batch["image_valid"]
        batch["image_valid"] = torch.where(m_img[:, None], torch.zeros_like(valid), valid)
    elif "image_data" in batch:
        img = batch["image_data"]
        batch["image_data"] = torch.where(m_img.reshape(bsz, *(1,) * (img.ndim - 1)),
                                          torch.zeros_like(img), img)
    if "vision_u" in batch:
        vu = batch["vision_u"]
        valid = batch.get("vision_u_valid", torch.ones_like(vu))
        batch["vision_u_valid"] = torch.where(m_img.reshape(bsz, *(1,) * (vu.ndim - 1)),
                                              torch.zeros_like(valid), valid)
    if "game_state" in batch:
        gs = batch["game_state"]
        batch["game_state"] = torch.where(m_gs, _unknown_game_state(gs), gs)
    return batch


def dropout_modalities(batch: dict, p: float, generator: torch.Generator) -> dict:
    """Classifier-free-guidance-style conditioning dropout at train time: with
    probability ``p``, independently per sample and per modality, the
    modality takes its "missing data" value (``apply_dropout_masks``)."""
    if p <= 0.0:
        return batch
    return apply_dropout_masks(batch, draw_dropout_masks(batch["joint_command"].shape[0], p,
                                                         generator))


class DeviceResidentData:
    """A dataset's windows stacked once and put on ``device``; ``batches``
    gathers each batch there by index, so a step copies nothing from the
    host: each epoch's window order is uploaded once, and a batch is an
    ``index_select`` of every tensor by a slice of it.

    Built from ``dataset[i]`` for every window (a ``WindowedDataset``); a
    ``PackedDataset`` has no per-window items and is refused, as the JAX
    package's ``DeviceResidentData`` cannot take one either. A CUDA device
    without a GPU raises, and so does a process group of several ranks: the
    dataset lives on one device, as the JAX class refuses a multi-device
    runtime."""

    def __init__(self, dataset, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} requested but CUDA is not available "
                               "(pass device='cpu' for the CPU)")
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(f"DeviceResidentData holds the whole dataset on one device; under "
                             f"{dist.get_world_size()} ranks train from host batches (no "
                             "--device-data)")
        if not hasattr(dataset, "__getitem__"):
            raise ValueError(f"DeviceResidentData stacks dataset[i] for every window; "
                             f"{type(dataset).__name__} has no per-window items (--device-data "
                             "cannot be combined with --packed)")
        n = len(dataset)
        first = dataset[0]
        host = {k: np.empty((n,) + np.shape(v), np.asarray(v).dtype) for k, v in first.items()}
        for i in range(n):
            for k, v in (first if i == 0 else dataset[i]).items():
                host[k][i] = v
        self.num_samples = n
        self.data = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def __len__(self) -> int:
        return self.num_samples

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = True, order: np.ndarray | None = None):
        """Yield one epoch of device batches: the windows of ``order`` (the
        boundary oversampling's), else ``np.random.default_rng(seed)``'s
        shuffle of all windows (``shuffle``), else their order."""
        if order is None:
            order = np.arange(self.num_samples)
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
        limit = len(order) - (len(order) % batch_size if drop_remainder else 0)
        index = torch.as_tensor(np.asarray(order[:limit], dtype=np.int64)).to(self.device)
        for i in range(0, limit, batch_size):
            rows = index[i: i + batch_size]
            yield {k: v.index_select(0, rows) for k, v in self.data.items()}


def to_tensors(batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def prefetch_to_device(batch_iter: Iterator[dict[str, np.ndarray]], device,
                       buffer_size: int = 2) -> Iterator[dict[str, torch.Tensor]]:
    """Yield the numpy batches of ``batch_iter`` as tensors on ``device``.

    On a CUDA device a producer thread stages each batch in pinned host
    memory and copies it with ``non_blocking`` copies on a side stream, up
    to ``buffer_size`` batches ahead; the consumer's stream waits for a
    batch's copy before using it. On the CPU the arrays are wrapped as
    they are. A failure in the producer is raised in the consumer."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batch_iter:
            yield to_tensors(batch)
        return
    copy_stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with torch.cuda.stream(copy_stream):
                for batch in batch_iter:
                    host = {k: t.pin_memory() for k, t in to_tensors(batch).items()}
                    dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                    if not put((dev, ready)):
                        return
        except BaseException as exc:  # handed to the consumer, which re-raises it
            put(exc)
        finally:
            put(done)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            dev, ready = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for t in dev.values():
                t.record_stream(stream)
            yield dev
    finally:
        stop.set()
        thread.join(timeout=10)
