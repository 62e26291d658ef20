"""Open-loop quality evaluation on held-out windows (counterpart of
``soccerdiffusion_tpu/evaluation/openloop.py``).

  * ``open_loop_metrics``: the denoised trajectory against the dataset's
    target, overall and per-joint MSE / MAE in the denormalised [0, 2 pi)
    joint domain, and the pure-noise floor;
  * ``context_sensitivity``: epsilon MSE with true against batch-shuffled
    context, per diffusion-timestep fraction;
  * ``sampler_agreement``: a student against its teacher on the same noise
    and context (the distillation objective, measured).

Each evaluates a seeded window subset, so runs are comparable across
checkpoints. The windows and the shuffle permutations are the JAX
package's numpy streams. Each function takes ``noise_fn(stream_seed,
shape) -> Tensor``, with ``stream_seed`` the JAX package's key integer
(``seed + b`` for batch b, ``seed + b + 7919 m`` for the m-th extra draw
of ``mean_of``); its default draws from
``torch.Generator(device).manual_seed(stream_seed)``. The model's own
parameters are evaluated, in eval mode and without autograd, on
``device`` (the card unless the caller asks for the CPU), where the model
must already be.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from soccerdiffusion_tpu_torch.data.pipeline import null_modalities
from soccerdiffusion_tpu_torch.diffusion import (
    DiffusionSchedule,
    add_noise,
    solver_label,
    solver_sample,
)
from soccerdiffusion_tpu_torch.inference.sampler import eval_mode

NoiseFn = Callable[[int, tuple], torch.Tensor]


def check_device(model, device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it is CUDA and there is
    none, or where the model's parameters lie on another device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"the model's parameters are on {param.device}, the evaluation's "
                         f"device is {device}: move the model first")
    return device


def default_noise_fn(device) -> NoiseFn:
    """Standard normal float32 draws from a generator on ``device`` seeded
    by the stream seed."""
    def noise_fn(stream_seed: int, shape: tuple) -> torch.Tensor:
        generator = torch.Generator(device=device).manual_seed(int(stream_seed))
        return torch.randn(shape, generator=generator, device=device)

    return noise_fn


def _noise(noise_fn: NoiseFn | None, device, stream_seed: int, shape: tuple) -> torch.Tensor:
    draw = noise_fn or default_noise_fn(device)
    return draw(stream_seed, shape).to(device, torch.float32)


@torch.no_grad()
def sample_trajectories(model, schedule: DiffusionSchedule, context: torch.Tensor,
                        noise: torch.Tensor, num_steps: int, distilled: bool,
                        solver: str = "ddim", uncond_context: torch.Tensor | None = None,
                        guidance_scale: float = 1.0) -> torch.Tensor:
    """The checkpoint's sampler on encoded context, in the normalised domain.

    ``distilled``: the student's single forward at t=0; else ``num_steps``
    steps of ``solver`` ("ddim" or "dpmpp[@lambda]"), each a full
    ``model.denoise`` over the context. ``uncond_context`` with
    ``guidance_scale`` != 1 is classifier-free guidance: each step denoises
    both contexts in one doubled-batch pass, eps_u + w (eps_c - eps_u). The
    distilled student's output is not a score, so it refuses guidance."""
    bsz = noise.shape[0]
    device = noise.device
    guided = uncond_context is not None and guidance_scale != 1.0
    if distilled:
        if guided:
            raise ValueError("classifier-free guidance requires an iterative sampler; the "
                             "distilled student's single forward is not a score prediction")
        return model.denoise(context, noise, torch.zeros((bsz,), dtype=torch.int64, device=device))
    if guided:
        ctx2 = torch.cat([context, uncond_context], dim=0)

        def denoise_fn(x, t):
            steps = torch.full((2 * bsz,), t, dtype=torch.int64, device=device)
            eps2 = model.denoise(ctx2, torch.cat([x, x], dim=0), steps)
            eps_c, eps_u = eps2[:bsz], eps2[bsz:]
            return eps_u + guidance_scale * (eps_c - eps_u)
    else:
        def denoise_fn(x, t):
            return model.denoise(context, x, torch.full((bsz,), t, dtype=torch.int64,
                                                        device=device))

    return solver_sample(schedule, denoise_fn, noise, num_steps, solver=solver)


def eval_batches(dataset, indices: Sequence[int], batch_size: int):
    """Stacked numpy batches over the window ``indices``, in order."""
    for lo in range(0, len(indices), batch_size):
        chunk = [dataset[int(i)] for i in indices[lo:lo + batch_size]]
        yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}


def held_out_indices(dataset_len: int, num_windows: int, seed: int = 0) -> np.ndarray:
    """A seeded subset of window indices, sorted."""
    rng = np.random.default_rng(seed)
    n = min(num_windows, dataset_len)
    return np.sort(rng.choice(dataset_len, size=n, replace=False))


def _on(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


@torch.no_grad()
def open_loop_metrics(model, normalizer, schedule: DiffusionSchedule, dataset,
                      indices: Sequence[int], num_steps: int, distilled: bool,
                      batch_size: int = 64, seed: int = 0, solver: str = "ddim",
                      shuffle_keys: Sequence[str] | None = None, guidance_scale: float = 1.0,
                      guidance_null: Sequence[str] | None = None, mean_of: int = 1,
                      noise_fn: NoiseFn | None = None, device="cuda") -> dict:
    """The denoised trajectory against the ground-truth future commands over
    ``indices``: overall and per-joint MSE / MAE (radians, [0, 2 pi)), and
    the MSE of pure denormalised noise (the "beats noise" floor).

    ``mean_of`` > 1 averages that many sampled trajectories (independent
    start noise, the same context) before the error: the posterior-mean
    estimator, the class of the Bayes-oracle rows (label ``xmeanK``).
    ``shuffle_keys`` (e.g. ``IMAGE_KEYS``) permutes those entries across the
    batch before encoding, the targets kept. ``guidance_scale`` != 1 with
    ``guidance_null`` (modality names of ``null_modalities``) samples with
    classifier-free guidance."""
    device = check_device(model, device)
    normalizer = normalizer.to(device)
    cfg = model.config
    shuffle_rng = np.random.default_rng(seed + 23) if shuffle_keys is not None else None
    guided = guidance_null is not None and guidance_scale != 1.0
    se_sum = ae_sum = noise_se_sum = None
    count = 0
    with eval_mode(model):
        for b, batch in enumerate(eval_batches(dataset, indices, batch_size)):
            if shuffle_rng is not None:
                perm = shuffle_rng.permutation(len(batch["joint_command"]))
                for k in shuffle_keys:
                    if k in batch:
                        batch[k] = batch[k][perm]
            jb = _on(batch, device)
            bsz = jb["joint_command"].shape[0]
            shape = (bsz, cfg.trajectory_prediction_length, cfg.num_joints)
            noise = _noise(noise_fn, device, seed + b, shape)
            context = model.encode_context(jb)
            uncond = model.encode_context(null_modalities(jb, guidance_null)) if guided else None
            traj = sample_trajectories(model, schedule, context, noise, num_steps, distilled,
                                       solver=solver, uncond_context=uncond,
                                       guidance_scale=guidance_scale)
            if mean_of > 1:
                for m in range(1, mean_of):
                    noise_m = _noise(noise_fn, device, seed + b + 7919 * m, shape)
                    traj = traj + sample_trajectories(
                        model, schedule, context, noise_m, num_steps, distilled, solver=solver,
                        uncond_context=uncond, guidance_scale=guidance_scale)
                traj = traj / mean_of
            traj = normalizer.denormalize(traj)
            target = jb["joint_command"].float()
            err = (traj.float() - target).cpu().numpy()  # (B, P, J)
            noise_err = (normalizer.denormalize(noise).float() - target).cpu().numpy()
            se = np.sum(np.square(err), axis=(0, 1))  # (J,)
            ae = np.sum(np.abs(err), axis=(0, 1))
            nse = np.sum(np.square(noise_err), axis=(0, 1))
            se_sum = se if se_sum is None else se_sum + se
            ae_sum = ae if ae_sum is None else ae_sum + ae
            noise_se_sum = nse if noise_se_sum is None else noise_se_sum + nse
            count += bsz * cfg.trajectory_prediction_length
    per_joint_mse = se_sum / count
    per_joint_mae = ae_sum / count
    label = "distilled1" if distilled else solver_label(solver, num_steps)
    if guided:
        null = (guidance_null,) if isinstance(guidance_null, str) else guidance_null
        label += f"+cfg{guidance_scale:g}({','.join(null)})"
    if mean_of > 1:
        label += f"xmean{mean_of}"
    return {
        "num_windows": int(len(indices)),
        "sampler": label,
        "mse": float(per_joint_mse.mean()),
        "mae": float(per_joint_mae.mean()),
        "noise_floor_mse": float((noise_se_sum / count).mean()),
        "per_joint_mse": {name: float(v) for name, v in zip(cfg.joint_names, per_joint_mse)},
    }


#: batch keys that carry conditioning (everything the policy encodes but
#: the denoised target)
CONTEXT_KEYS = ("joint_command_history", "joint_state", "rotation",
                "image_u8", "image_valid", "image_data", "game_state")

#: the camera modality's keys, shuffled together by the image-only probes
IMAGE_KEYS = ("image_u8", "image_valid", "image_data", "image_stamps")


@torch.no_grad()
def context_sensitivity(model, normalizer, schedule: DiffusionSchedule, dataset,
                        indices: Sequence[int], t_fracs: Sequence[float] = (0.1, 0.5, 0.9),
                        batch_size: int = 64, seed: int = 0, keys: Sequence[str] = CONTEXT_KEYS,
                        variants: dict[str, Sequence[str]] | None = None,
                        noise_fn: NoiseFn | None = None, device="cuda") -> dict:
    """Does the model use its context? Epsilon MSE with true against
    batch-shuffled context at each timestep fraction, and their ratio
    (shuffled / true; near 1 at every t means only unconditional denoising
    was learned).

    ``keys`` selects the permuted entries: all context (default) or one
    modality (``IMAGE_KEYS``: is the camera used?). ``variants`` (name ->
    keys) evaluates several shuffles against one shared true-side pass,
    with the same permutation and noise as separate calls; the result is
    then ``{name: result}``."""
    device = check_device(model, device)
    normalizer = normalizer.to(device)
    single = variants is None
    if single:
        variants = {"context": tuple(keys)}
    rng = np.random.default_rng(seed + 17)
    true_se = {f: 0.0 for f in t_fracs}
    shuf_se = {name: {f: 0.0 for f in t_fracs} for name in variants}
    count = 0
    T = schedule.num_train_timesteps
    with eval_mode(model):
        for b, batch in enumerate(eval_batches(dataset, indices, batch_size)):
            jb = _on(batch, device)
            bsz = jb["joint_command"].shape[0]
            perm = torch.as_tensor(rng.permutation(bsz), device=device)
            ctx_true = model.encode_context(jb)
            ctx_shuf = {}
            for name, ks in variants.items():
                jb_sh = dict(jb)
                for k in ks:
                    if k in jb_sh:
                        jb_sh[k] = jb_sh[k][perm]
                ctx_shuf[name] = model.encode_context(jb_sh)
            # the normalised domain: the training objective's
            x0 = normalizer.normalize(jb["joint_command"].float())
            eps = _noise(noise_fn, device, seed + b, tuple(x0.shape))
            for f in t_fracs:
                t = torch.full((bsz,), int(f * (T - 1)), dtype=torch.int64, device=device)
                xt = add_noise(schedule, x0, eps, t)
                pt = model.denoise(ctx_true, xt, t)
                true_se[f] += float(torch.sum((pt - eps) ** 2))
                for name, ctx in ctx_shuf.items():
                    ps = model.denoise(ctx, xt, t)
                    shuf_se[name][f] += float(torch.sum((ps - eps) ** 2))
            count += int(eps.numel())
    results = {}
    for name in variants:
        out = {"num_windows": int(len(indices)), "per_t": {}}
        for f in t_fracs:
            ts, ss = true_se[f], shuf_se[name][f]
            out["per_t"][f"{f:.2f}"] = {
                "eps_mse_true": ts / count,
                "eps_mse_shuffled": ss / count,
                "ratio": (ss / ts) if ts > 0 else float("nan"),
            }
        out["min_ratio"] = min(v["ratio"] for v in out["per_t"].values())
        results[name] = out
    return results["context"] if single else results


@torch.no_grad()
def sampler_agreement(teacher, student, normalizer, schedule: DiffusionSchedule, dataset,
                      indices: Sequence[int], teacher_steps: int, student_steps: int,
                      student_distilled: bool, batch_size: int = 64, seed: int = 0,
                      student_solver: str = "ddim", noise_fn: NoiseFn | None = None,
                      device="cuda") -> dict:
    """The student's trajectory against the teacher's on the same noise,
    MSE / MAE in the denormalised joint domain. Each model encodes the
    context with its own parameters: the deployed student end to end."""
    device = check_device(teacher, device)
    check_device(student, device)
    normalizer = normalizer.to(device)
    cfg = teacher.config
    se_sum = ae_sum = 0.0
    count = 0
    with eval_mode(teacher), eval_mode(student):
        for b, batch in enumerate(eval_batches(dataset, indices, batch_size)):
            jb = _on(batch, device)
            bsz = jb["joint_command"].shape[0]
            shape = (bsz, cfg.trajectory_prediction_length, cfg.num_joints)
            noise = _noise(noise_fn, device, seed + b, shape)
            t_traj = sample_trajectories(teacher, schedule, teacher.encode_context(jb), noise,
                                         teacher_steps, False)
            s_traj = sample_trajectories(student, schedule, student.encode_context(jb), noise,
                                         student_steps, student_distilled, solver=student_solver)
            diff = (normalizer.denormalize(s_traj).float()
                    - normalizer.denormalize(t_traj).float()).cpu().numpy()
            se_sum += float(np.sum(np.square(diff)))
            ae_sum += float(np.sum(np.abs(diff)))
            count += diff.size
    return {
        "num_windows": int(len(indices)),
        "teacher": f"ddim{teacher_steps}",
        "student": ("distilled1" if student_distilled
                    else solver_label(student_solver, student_steps)),
        "mse_vs_teacher": se_sum / count,
        "mae_vs_teacher": ae_sum / count,
    }
