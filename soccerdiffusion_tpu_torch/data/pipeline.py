"""Batch preparation, the ViT patch layout and the host -> device prefetch
(counterpart of ``prepare_batch``, ``device_normalize_images``,
``patchify_frames`` and ``prefetch_to_device`` in
``soccerdiffusion_tpu/data/pipeline.py``).

Packed batches carry frames as uint8 (``image_u8``, whole frames or
pre-patchified) with an ``image_valid`` mask; they stay uint8 through
pinning and the host -> device copy, and are normalised on the device.
``DeviceResidentData`` and ``dropout_modalities`` are not ported yet.
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
