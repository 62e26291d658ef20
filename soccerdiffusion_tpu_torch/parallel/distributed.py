"""Multi-process start-up (counterpart of
``soccerdiffusion_tpu/parallel/distributed.py``).

The JAX package is one controller over every device; the port runs one
process per rank, as ``torch.distributed.run`` (torchrun) starts them.
``initialize_distributed`` joins the process group once per process: with
no arguments it reads the environment torchrun sets (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and does nothing
for a single process, as the JAX function does. The group has a finite
timeout, so that a rank that hangs fails its peers rather than blocking
them forever.

Backends: ``nccl`` for ranks on cards (one rank a card), ``gloo`` on the
CPU. Two ranks that share one card must name ``backend="gloo"``: NCCL
refuses two ranks on one device, and gloo's transfers then go through host
copies (``parallel/comm.py``). The backend is the caller's choice and is
never switched after a failure.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("soccerdiffusion_tpu_torch")

#: how long a collective waits for its peers before it fails
TIMEOUT = datetime.timedelta(seconds=60)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``"cuda"`` without an index is
    ``cuda:{LOCAL_RANK}``; a device with an index, or the CPU, is taken as
    it is. Raises where CUDA is missing or ``LOCAL_RANK`` is past the cards."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available "
                           "(pass device='cpu' / --device cpu for the CPU)")
    if device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local} but this machine has "
                               f"{torch.cuda.device_count()} card(s): start one rank a card, "
                               "or name a card (cuda:0) and backend 'gloo' to share one")
        device = torch.device("cuda", local)
    return device


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, backend: str | None = None,
                           device: str | torch.device = "cuda") -> torch.device:
    """Join the process group and return this rank's device
    (``rank_device(device)``).

    ``init_method`` (e.g. ``tcp://localhost:29500``) with ``world_size`` and
    ``rank``, else torchrun's environment (``env://``). A single process
    (no ``init_method`` and ``WORLD_SIZE`` unset or 1) starts no group. A
    group that is already up is kept. ``backend=None`` is ``nccl`` for a
    CUDA device and ``gloo`` for the CPU. Collectives wait ``TIMEOUT``."""
    device = rank_device(device)
    if is_initialized():
        return device
    if init_method is None:
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
        if (world_size or env_world) <= 1:
            logger.info("single-process run; no process group")
            return device
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    logger.info(f"process group up: rank {rank} of {world_size}, backend {backend}, "
                f"device {device}")
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    if is_initialized():
        dist.destroy_process_group()


def global_mesh(shape: dict[str, int] | None = None):
    """The mesh over every rank of the process group (``make_mesh``)."""
    from soccerdiffusion_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape)
