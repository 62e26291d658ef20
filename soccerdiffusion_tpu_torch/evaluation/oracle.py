"""Bayes-oracle calibration for the camera-cued "vision" dummy task
(counterpart of ``soccerdiffusion_tpu/evaluation/oracle.py``, the same numpy
arithmetic).

The vision task's generative process is known exactly
(``data/dummy.py:_vision_recording``: a first-order lag toward
``pi + VISION_AMP * u_k * dirs`` with i.i.d. per-image cues ``u_k`` and
per-tick Gaussian process noise), so the Bayes-optimal sampler can be
simulated and its open-loop error recorded next to a model's, on the same
windows and in the same denormalised-radians MSE units as
``evaluation/openloop.py:open_loop_metrics``:

  * **cued**: sees every image visible to the window: the true cue for
    every future interval whose image is already visible, ``u ~ U[-1, 1]``
    for the intervals whose image has not appeared yet;
  * **blind**: no camera, but not naive: for an interval the window is
    already ``m > 0`` ticks into, the cue is least-squares-estimated from
    the proprioceptive history; only intervals with no traversed tick (the
    boundary windows) force a uniform draw.

``blind / cued`` is the ceiling of the reports' shuffled / true open-loop
ratio: a perfect camera-using model scores ``cued`` with true images and
at least ``blind`` with ablated ones.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np

from soccerdiffusion_tpu_torch.data.dummy import (
    VISION_AMP,
    VISION_BETA,
    VISION_NOISE_STD,
)

TWO_PI = 2.0 * np.pi


def _window_location(dataset, idx: int) -> tuple[int, int]:
    """Window index -> (recording index, first future-command tick)."""
    b = bisect.bisect_right(dataset._starts, idx) - 1
    start, _, ri = dataset.sample_boundaries[b]
    return ri, (idx - start) * dataset.stride


def _estimate_cue_from_history(cmds: np.ndarray, dirs: np.ndarray,
                               k_start: int, c: int) -> float:
    """Least-squares cue estimate from the ``[k_start, c)`` ticks of the
    current interval (requires ``c > k_start``).

    Each observed transition obeys
    ``cmds[t] - cmds[t-1] = VISION_BETA * (pi + VISION_AMP*u*dirs - cmds[t-1])
    + noise`` so ``r_tj = (cmds[t,j]-cmds[t-1,j])/beta - (pi - cmds[t-1,j])
    = VISION_AMP * u * dirs_j + noise_tj/beta`` — a linear model in ``u``.
    """
    ts = np.arange(max(k_start, 1), c)  # t=0 has no predecessor
    if len(ts) == 0:
        raise ValueError("no traversed ticks to estimate from")
    prev = cmds[ts - 1].astype(np.float64)
    r = (cmds[ts].astype(np.float64) - prev) / VISION_BETA - (np.pi - prev)
    a = VISION_AMP * dirs.astype(np.float64)  # (J,)
    num = float(np.sum(r * a))
    den = float(len(ts) * np.sum(a * a))
    u = num / den if den > 0 else 0.0
    return float(np.clip(u, -1.0, 1.0))


def vision_oracle_open_loop(dataset, indices: Sequence[int],
                            num_samples: int = 8, seed: int = 0) -> dict:
    """Open-loop MSE of the cued and blind Bayes oracles over ``indices``.

    ``dataset`` must be a ``WindowedDataset.from_dummy`` of the "vision"
    task (its ``dummy_recordings`` carry ``vision_u`` / ``vision_dirs``).
    ``num_samples`` Monte-Carlo rollouts per window estimate the expected
    error of a posterior SAMPLE (what a perfect diffusion sampler draws),
    matching the single-sample semantics of ``open_loop_metrics``.
    """
    recs = getattr(dataset, "dummy_recordings", None)
    if not recs or getattr(recs[0], "vision_u", None) is None:
        raise ValueError(
            "oracle calibration needs a from_dummy 'vision'-task dataset "
            "(dummy_recordings with vision_u); got neither"
        )
    cfg = dataset.cfg
    P, J = cfg.trajectory_prediction_length, cfg.num_joints
    rng = np.random.default_rng(seed + 101)
    se = {"cued": 0.0, "blind": 0.0}
    count = 0
    for idx in indices:
        ri, c = _window_location(dataset, int(idx))
        d = recs[ri]
        cmds = d.joint_commands[:, :J]
        dirs = np.asarray(d.vision_dirs[:J], dtype=np.float64)
        u_true = np.asarray(d.vision_u, dtype=np.float64)
        stamps = np.asarray(d.image_stamps, dtype=np.float64)
        step = int(round((stamps[1] - stamps[0]) * dataset.sampling_rate))
        prev0 = (cmds[c - 1].astype(np.float64) if c > 0
                 else np.full((J,), np.pi))
        target = cmds[c : c + P].astype(np.float64)
        k_vis = c // step  # newest visible image's interval
        ks = (c + np.arange(P)) // step  # interval of each future tick
        noise = rng.normal(0.0, VISION_NOISE_STD, size=(num_samples, P, J))
        for mode in ("cued", "blind"):
            u_eff = np.empty((num_samples, P))
            for k in np.unique(ks):
                if mode == "cued" and k <= k_vis:
                    vals = np.full((num_samples,), u_true[k])
                elif mode == "blind" and k == k_vis and c > k * step:
                    # mid-interval: history reveals the current cue
                    vals = np.full(
                        (num_samples,),
                        _estimate_cue_from_history(cmds, dirs, k * step, c))
                else:
                    # unseen (future interval, or boundary tick when blind)
                    vals = rng.uniform(-1.0, 1.0, size=num_samples)
                u_eff[:, ks == k] = vals[:, None]
            prev = np.broadcast_to(prev0, (num_samples, J)).copy()
            sim = np.empty((num_samples, P, J))
            for i in range(P):
                tgt = np.pi + VISION_AMP * u_eff[:, i : i + 1] * dirs
                prev = prev + VISION_BETA * (tgt - prev) + noise[:, i]
                sim[:, i] = prev
            sim = np.clip(sim, 0.0, TWO_PI - 1e-6)
            se[mode] += float(np.sum((sim - target) ** 2))
        count += num_samples * P * J
    mse_cued = se["cued"] / count
    mse_blind = se["blind"] / count
    return {
        "num_windows": int(len(indices)),
        "num_samples": int(num_samples),
        "mse_cued": mse_cued,
        "mse_blind": mse_blind,
        "ratio_blind_over_cued": (mse_blind / mse_cued if mse_cued > 0
                                  else float("nan")),
    }
