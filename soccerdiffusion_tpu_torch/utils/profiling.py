"""Profiling and MFU accounting (counterpart of
``soccerdiffusion_tpu/utils/profiling.py``).

A ``torch.profiler`` trace context that writes a Chrome trace, the named
stage spans that the serving period and the training step open in it, a
FLOP count of one training step that does not depend on how the step is
implemented, and the trainer's MFU meter against the card's published peak
(MFU is a north-star metric; BASELINE.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

logger = logging.getLogger("soccerdiffusion_tpu_torch")

# Peak dense FLOP/s of one card, keyed by the name torch.cuda.get_device_name
# gives: NVIDIA's H100 Tensor Core GPU data sheet, dense rates (without
# sparsity) at the card's full power limit. "bf16" is bf16 / fp16 on the
# tensor cores, "tf32" float32 on the tensor cores as TF32, "fp32" float32
# on the CUDA cores.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12},  # SXM5
    "NVIDIA H100 PCIe": {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12},
}
CPU_PEAK_FLOPS = 1e11  # nominal, for smoke runs (the JAX package's figure)
TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()

# every knob that changes how the step is implemented but not what it
# computes: the fused kernels, recomputation in the backward, the attention
# kernel; counted off, so a config counts the same whatever it implements
UNFUSED = dict(encoder_fused_stack=False, encoder_fused_block=False, decoder_fused_block=False,
               vit_fused_block=False, remat_decoder=False, remat_image_encoder=False,
               attention_impl="xla")


def device_peak_flops(device: str | torch.device = "cuda",
                      dtype: str | torch.dtype = torch.bfloat16) -> float | None:
    """The peak FLOP/s of ``device`` for products in ``dtype`` (a
    ``compute_dtype`` name or a torch dtype): bf16 / fp16 at the tensor-core
    rate; float32 at the TF32 rate where
    ``torch.backends.cuda.matmul.allow_tf32`` is set, else at the CUDA-core
    rate. The CPU gets the nominal ``CPU_PEAK_FLOPS``. A card missing from
    ``PEAK_FLOPS`` gets None, and the log names it."""
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_PEAK_FLOPS
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    peaks = PEAK_FLOPS.get(name)
    if peaks is None:
        logger.warning(f"no published peak FLOP/s for {name!r}: MFU is not reported")
        return None
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype in (torch.bfloat16, torch.float16):
        return peaks["bf16"]
    return peaks["tf32"] if torch.backends.cuda.matmul.allow_tf32 else peaks["fp32"]


def step_flops(model_cls, config, batch_size: int) -> tuple[int, int]:
    """(forward, backward) FLOPs that ``torch.utils.flop_counter`` counts
    for one training step of ``model_cls(config)`` at ``batch_size``, run
    on the CPU in float32 on zero inputs: the forward of the policy on a
    batch and a noisy chunk, and the backward of the squared error."""
    from torch.utils.flop_counter import FlopCounterMode

    from soccerdiffusion_tpu_torch.inference.controller import (
        init_controller_state,
        make_controller_batch,
    )

    cfg = dataclasses.replace(config, compute_dtype="float32")
    with torch.random.fork_rng(devices=[]):  # the module's init draws leave the caller's RNG
        model = model_cls(cfg)
    batch = make_controller_batch(cfg, init_controller_state(cfg, batch_size, device="cpu"))
    noisy = torch.zeros((batch_size, cfg.trajectory_prediction_length, cfg.num_joints))
    t = torch.zeros((batch_size,), dtype=torch.int64)
    counter = FlopCounterMode(display=False)
    with counter:
        loss = torch.mean(model(batch, noisy, t) ** 2)
        forward = counter.get_total_flops()
        loss.backward()
    return forward, counter.get_total_flops() - forward


def estimate_flops(model, config, batch_size: int) -> int:
    """The model FLOPs of one training step of ``model`` (the policy the
    trainer builds from the ``ModelConfig`` ``config``) at ``batch_size``,
    the same whatever implements the step.

    ``FlopCounterMode`` counts the forward and backward of a fresh
    ``type(model)`` whose every knob of ``UNFUSED`` is off, on the CPU (the
    weights and the device of ``model`` are not touched): the fused kernels
    are ctypes launches the counter cannot see, and their backward
    recomputes the forward, which would count it twice. It counts every
    matrix product, attention product and convolution (the ResNet
    encoders'), at one robot, and scales linearly to ``batch_size`` (every
    such product is per robot). It does not count elementwise work
    (normalisation, activations, the loss) or the optimizer update, both of
    which XLA's ``cost_analysis`` of the JAX step does count."""
    forward, backward = step_flops(type(model), dataclasses.replace(config, **UNFUSED), 1)
    return (forward + backward) * batch_size


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """A ``torch.profiler`` trace of the body, CPU and (where the build has
    it) CUDA activity, written as a Chrome trace to ``log_dir/trace.json``
    (chrome://tracing or Perfetto); yields the ``profile``. CUPTI records
    the ctypes-launched kernels, so the trace names them."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the body's kernels end inside the trace
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def span(name: str):
    """A context that marks one stage of the program, ``name``, in a
    ``torch.profiler`` trace: a CPU op on the calling thread, on the same
    clock as the card's kernels, whose children are the ops the stage
    issues. Without a recording profile it is a shared null context, and
    the stage pays one flag check.

    The span is a function-scope record, not ``record_function``'s user
    annotation: CUPTI copies a user annotation's range onto the stream of
    the kernels it launched, and a reader of the trace would take that copy
    for a device op (a launch, and busy time across the stage's gaps)."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def default_peak_flops() -> float | None:
    """The peak of the runtime's first device: the card where there is one."""
    return device_peak_flops("cuda" if torch.cuda.is_available() else "cpu")


@dataclass
class MFUMeter:
    """Tracks achieved model FLOPs utilization across steps. ``mfu`` is None
    where the peak is (an unknown card)."""

    flops_per_step: float
    num_devices: int = 1
    peak_flops: float | None = field(default_factory=default_peak_flops)
    _steps: int = 0
    _elapsed: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, steps: int = 1) -> None:
        if self._t0 is None:
            raise RuntimeError("call start() first")
        self._elapsed += time.perf_counter() - self._t0
        self._steps += steps
        self._t0 = None

    def cancel(self) -> None:
        """Discard an open start() window without recording it."""
        self._t0 = None

    @property
    def mfu(self) -> float | None:
        if self.peak_flops is None:
            return None
        if self._elapsed == 0:
            return 0.0
        achieved = self.flops_per_step * self._steps / self._elapsed
        return achieved / (self.peak_flops * self.num_devices)

    @property
    def steps_per_sec(self) -> float:
        return self._steps / self._elapsed if self._elapsed else 0.0
