"""Host-side batch preparation and the host -> device prefetch (counterpart
of ``prepare_batch`` and ``prefetch_to_device`` in
``soccerdiffusion_tpu/data/pipeline.py``, proprioceptive batches).

``DeviceResidentData`` and ``dropout_modalities`` are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def prepare_batch(batch: dict) -> dict:
    """The JAX package materialises normalised images from a packed uint8
    batch here; proprioceptive batches pass through unchanged."""
    if "image_u8" in batch or "image_data" in batch:
        raise NotImplementedError("image batches come with the image path, which is not ported "
                                  "yet (see ROADMAP.md)")
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
