"""Streaming resampler state machines (reference dataset/resampling/;
counterpart of ``soccerdiffusion_tpu/ingest/resampling.py``).

Three strategies over a stream of (data, relative_timestamp) observations:

  * ``PreviousInterpolationResampler`` — fixed-rate zero-order hold; one
    input may emit N catch-up samples when more than one sampling step has
    passed (reference previous_interpolation_resampler.py:27-53)
  * ``MaxRateResampler`` — rate limiter (<=10 Hz for images;
    reference max_rate_resampler.py:27-47)
  * ``OriginalRateResampler`` — pass-through (game states;
    reference original_rate_resampler.py:5-7)
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Generic, TypeVar

T = TypeVar("T")


@dataclass
class Sample(Generic[T]):
    data: T
    timestamp: float


class Resampler(ABC):
    @abstractmethod
    def resample(self, data, relative_timestamp: float) -> list[Sample]:
        """Emit zero or more samples with timestamps <= relative_timestamp."""


class OriginalRateResampler(Resampler):
    def resample(self, data, relative_timestamp: float) -> list[Sample]:
        return [Sample(data=data, timestamp=relative_timestamp)]


class MaxRateResampler(Resampler):
    """Emits at most one sample per 1/max_rate window."""

    def __init__(self, max_sample_rate_hz: int):
        self.max_sample_rate_hz = max_sample_rate_hz
        self.step = 1.0 / max_sample_rate_hz
        self.last_sample_step_timestamp: float | None = None

    def resample(self, data, relative_timestamp: float) -> list[Sample]:
        if self.last_sample_step_timestamp is None:
            self.last_sample_step_timestamp = relative_timestamp
            return [Sample(data=data, timestamp=relative_timestamp)]
        if relative_timestamp - self.last_sample_step_timestamp >= self.step:
            # Advance the grid by exactly one step (not to the observation
            # time), matching the reference's drift behavior
            # (max_rate_resampler.py:33-42).
            self.last_sample_step_timestamp += self.step
            return [Sample(data=data, timestamp=relative_timestamp)]
        return []


class PreviousInterpolationResampler(Resampler):
    """Fixed-rate zero-order hold with catch-up.

    For each passed sampling step, emits the value held at that step: if the
    new observation arrived within one step of the grid point it is used
    ("previous" interpolation), otherwise the older held value repeats
    (reference previous_interpolation_resampler.py:36-53).
    """

    def __init__(self, sample_rate_hz: int):
        self.sample_rate_hz = sample_rate_hz
        self.step = 1.0 / sample_rate_hz
        self.last_received_data = None
        self.last_sampled_data = None
        self.last_sample_step_timestamp: float | None = None

    def resample(self, data, relative_timestamp: float) -> list[Sample]:
        if self.last_sample_step_timestamp is None:
            self.last_received_data = data
            self.last_sampled_data = data
            self.last_sample_step_timestamp = relative_timestamp
            return [Sample(data=data, timestamp=relative_timestamp)]

        samples: list[Sample] = []
        num_steps = int((relative_timestamp - self.last_sample_step_timestamp) / self.step)
        for _ in range(num_steps):
            if relative_timestamp - self.last_sample_step_timestamp <= self.step:
                self.last_received_data = data
            self.last_sampled_data = self.last_received_data
            self.last_sample_step_timestamp += self.step
            samples.append(Sample(data=self.last_sampled_data, timestamp=self.last_sample_step_timestamp))
        self.last_received_data = data
        return samples
