"""Quality report: one command, a JSON and a markdown quality ledger
(counterpart of ``soccerdiffusion_tpu/evaluation/report.py``).

A teacher checkpoint and any number of distilled students on the same
held-out windows and noise streams:

  * open-loop MSE / MAE against the ground truth, and the pure-noise floor;
  * open-loop agreement with the teacher (the distillation objective);
  * closed-loop rollout divergence from the teacher under feedback;
  * the teacher's own noise-resampling self-consistency as the yardstick;
  * the teacher's context sensitivity and, for image models, its image
    sensitivity, the image-shuffled and boundary-window probes and, on the
    "vision" dummy task, the Bayes-oracle ceiling (``evaluation/oracle.py``);
  * optional guidance, training-free solver and posterior-mean rows.

  python -m soccerdiffusion_tpu_torch.evaluation.report --teacher t.ckpt \
      [--student s4.ckpt --student s1.ckpt] [--dummy-data | --db path] \
      [--windows 256] [--chunks 10] [--out quality_report] [--device cuda|cpu]

``markdown_report`` gives the JAX package's string for the same dict.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
from pathlib import Path

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.diffusion import make_schedule, parse_solver, solver_label
from soccerdiffusion_tpu_torch.evaluation.divergence import closed_loop_divergence, self_consistency
from soccerdiffusion_tpu_torch.evaluation.openloop import (
    CONTEXT_KEYS,
    IMAGE_KEYS,
    NoiseFn,
    context_sensitivity,
    held_out_indices,
    open_loop_metrics,
    sampler_agreement,
)
from soccerdiffusion_tpu_torch.evaluation.oracle import vision_oracle_open_loop
from soccerdiffusion_tpu_torch.training.checkpoint import build_policy, load_policy_checkpoint

logger = logging.getLogger("soccerdiffusion_tpu_torch")


def _load(path: str, prefer_ema: bool = True):
    """A checkpoint's serving point, ``(hyperparams, state_dict, normalizer,
    steps, distilled)``: the decoder ``cli serve`` shares, so that the
    report evaluates a checkpoint at the step count and weights it serves
    (``training/checkpoint.py:load_policy_checkpoint``)."""
    return load_policy_checkpoint(path, prefer_ema=prefer_ema)


def markdown_report(result: dict) -> str:
    lines = ["# Quality report", ""]
    lines.append(f"- windows: {result['num_windows']}, closed-loop chunks: "
                 f"{result['closed_loop_chunks']}, batch {result['batch_size']}")
    lines.append("")
    lines.append("| checkpoint | sampler | open-loop MSE | open-loop MAE | "
                 "vs-teacher MSE | closed-loop mean div (rad) | final div (rad) |")
    lines.append("|---|---|---|---|---|---|---|")
    for entry in result["checkpoints"]:
        o = entry["open_loop"]
        a = entry.get("agreement") or {}
        d = entry.get("divergence") or {}
        lines.append(
            f"| {entry['name']} | {o['sampler']} | {o['mse']:.5f} | "
            f"{o['mae']:.5f} | "
            f"{a.get('mse_vs_teacher', float('nan')):.5f} | "
            f"{d.get('mean_divergence_rad', float('nan')):.5f} | "
            f"{d.get('final_divergence_rad', float('nan')):.5f} |"
        )
    sc = result.get("teacher_self_consistency")
    if sc:
        lines += ["", f"Teacher noise-resampling self-consistency (mean "
                      f"closed-loop divergence against itself with a "
                      f"different noise stream): "
                      f"**{sc['mean_divergence_rad']:.5f} rad** — student "
                      f"divergence at or below this is sampling noise."]
    nf = result.get("noise_floor_mse")
    if nf is not None:
        lines += ["", f"Pure-noise open-loop MSE floor: **{nf:.5f}** (a "
                      f"sampler must land well below this to have learned "
                      f"anything)."]
    cs = result.get("context_sensitivity")
    if cs:
        rows = ", ".join(
            f"t={frac}: {v['ratio']:.2f}" for frac, v in cs["per_t"].items())
        lines += ["", f"Teacher context sensitivity (shuffled/true eps-MSE "
                      f"ratio; >1 means the context is used): {rows} — "
                      f"min **{cs['min_ratio']:.2f}**."]
    ims = result.get("image_sensitivity")
    if ims:
        rows = ", ".join(
            f"t={frac}: {v['ratio']:.2f}" for frac, v in ims["per_t"].items())
        lines += ["", f"Teacher IMAGE sensitivity (image-only shuffle, other "
                      f"modalities honest; shuffled/true eps-MSE ratio): "
                      f"{rows} — min **{ims['min_ratio']:.2f}**."]
    iso = result.get("image_shuffled_open_loop")
    if iso:
        lines += ["", f"Open-loop MSE with SHUFFLED images: "
                      f"**{iso['mse']:.5f}** vs {iso['true_mse']:.5f} true "
                      f"(ratio {iso['mse_ratio_shuffled_over_true']:.2f}x) — "
                      f"the camera's trajectory-level contribution."]
    ibs = result.get("image_sensitivity_boundary")
    if ibs:
        rows = ", ".join(
            f"t={frac}: {v['ratio']:.2f}" for frac, v in ibs["per_t"].items())
        lines += ["", f"BOUNDARY-window image sensitivity (only windows "
                      f"where a frame just became visible — the camera's "
                      f"undiluted contribution): {rows} — min "
                      f"**{ibs['min_ratio']:.2f}**."]
    ibo = result.get("image_shuffled_open_loop_boundary")
    if ibo:
        lines += ["", f"Boundary-window open-loop MSE: true "
                      f"**{ibo['true_mse']:.5f}** vs shuffled-images "
                      f"{ibo['mse']:.5f} "
                      f"(ratio {ibo['mse_ratio_shuffled_over_true']:.2f}x; "
                      f"noise floor {ibo['noise_floor_mse']:.5f}; "
                      f"{ibo['num_windows']} windows)."]
    g = result.get("guidance")
    if g:
        lines += ["", "Classifier-free guidance on the teacher "
                      "(eps_u + w (eps_c - eps_u); unconditional branch "
                      "nulls the listed modalities):", "",
                  "| guidance | held-out MSE | boundary MSE | boundary "
                  "shuffled-img MSE | boundary ratio |",
                  "|---|---|---|---|---|"]
        base = g[0].get("true_mse", float("nan"))
        bt = result.get("image_shuffled_open_loop_boundary", {})
        lines.append(f"| w=1 (unguided) | {base:.5f} | "
                     f"{bt.get('true_mse', float('nan')):.5f} | "
                     f"{bt.get('mse', float('nan')):.5f} | "
                     f"{bt.get('mse_ratio_shuffled_over_true', float('nan')):.2f}x |")
        for row in g:
            lines.append(
                f"| {row['sampler']} | {row['mse']:.5f} | "
                f"{row.get('boundary_mse', float('nan')):.5f} | "
                f"{row.get('boundary_shuffled_mse', float('nan')):.5f} | "
                f"{row.get('boundary_ratio_shuffled_over_true', float('nan')):.2f}x |")
    pm = result.get("posterior_mean_boundary")
    if pm:
        lines += ["", f"POSTERIOR-MEAN boundary open loop (K={pm['k']} "
                      f"sampled trajectories averaged per context — the "
                      f"estimator class the Bayes-oracle rows use; a single "
                      f"draw's posterior variance inflates both sides of "
                      f"the single-draw ratios above; "
                      f"{pm['num_windows']} windows; NFE/replan = denoiser "
                      f"evaluations per served action chunk — the serving "
                      f"cost of the row):", "",
                  "| checkpoint | sampler | NFE/replan | true MSE | "
                  "shuffled-img MSE | ratio |",
                  "|---|---|---|---|---|---|"]
        for row in pm["rows"]:
            lines.append(f"| {row.get('name', 'teacher')} | {row['sampler']} "
                         f"| {row.get('nfe', '?')} | {row['true_mse']:.5f} | "
                         f"{row['shuffled_mse']:.5f} | "
                         f"**{row['ratio_shuffled_over_true']:.2f}x** |")
    orc = result.get("oracle_open_loop")
    if orc:
        lines += ["", f"Bayes-oracle calibration (known plant, same "
                      f"windows; evaluation/oracle.py): cued "
                      f"**{orc['mse_cued']:.5f}** vs blind "
                      f"{orc['mse_blind']:.5f} (achievable ratio "
                      f"**{orc['ratio_blind_over_cued']:.2f}x**) — the "
                      f"ceiling for the shuffled/true ratios above."]
    orb = result.get("oracle_open_loop_boundary")
    if orb:
        lines += ["", f"Boundary-window oracle: cued "
                      f"**{orb['mse_cued']:.5f}** vs blind "
                      f"{orb['mse_blind']:.5f} (achievable ratio "
                      f"**{orb['ratio_blind_over_cued']:.2f}x**, "
                      f"{orb['num_windows']} windows)."]
    return "\n".join(lines) + "\n"


def boundary_windows(dataset, n: int, seed: int) -> np.ndarray | None:
    """Up to ``n`` of the windows where a frame has just become visible (the
    camera's undiluted contribution; ``image_boundary_indices``), a seeded
    sorted subset, or None where the dataset has none."""
    if not hasattr(dataset, "image_boundary_indices"):
        return None
    b_all = dataset.image_boundary_indices()
    if not len(b_all):
        return None
    return np.sort(np.random.default_rng(seed + 5).permutation(b_all)[:n])


def run_report(teacher: str, students: list[str], dataset, windows: int, chunks: int,
               batch_size: int, seed: int = 0, teacher_loaded: tuple | None = None,
               solver_rows: list[tuple[str, int]] = (), raw_weights: bool = False,
               guidance_rows: list[tuple[float, tuple[str, ...]]] = (),
               posterior_mean_k: int = 0, noise_fn: NoiseFn | None = None,
               device="cuda") -> dict:
    """The report's dict (``markdown_report`` renders it). ``teacher_loaded``
    is the teacher's ``_load`` result where the caller has it.
    ``solver_rows``: (solver, steps) training-free sampler rows on the
    teacher's weights, ranked with the students' metrics. ``raw_weights``
    evaluates the raw parameters of EMA checkpoints. ``guidance_rows``:
    (scale, null modalities) classifier-free-guidance rows on the teacher.
    ``posterior_mean_k`` > 1 adds boundary-window rows that average K
    trajectories a context. ``noise_fn`` (``evaluation/openloop.py``) draws
    every noise stream; ``device`` is where the checkpoints are evaluated
    (the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
    prefer_ema = not raw_weights
    t_params, t_state, normalizer, t_steps, t_distilled = (
        teacher_loaded if teacher_loaded is not None else _load(teacher, prefer_ema))
    config = Config.from_dict(t_params)
    model = build_policy(config.model, t_state, device)
    schedule = make_schedule(config.train.train_denoising_timesteps)
    indices = held_out_indices(len(dataset), windows, seed)
    use_images = config.model.use_images
    common = dict(batch_size=batch_size, seed=seed, noise_fn=noise_fn, device=device)

    result = {
        "teacher": teacher,
        "num_windows": int(len(indices)),
        "closed_loop_chunks": chunks,
        "batch_size": batch_size,
        "checkpoints": [],
    }
    logger.info(f"open-loop eval: teacher ({t_steps} steps)")
    t_open = open_loop_metrics(model, normalizer, schedule, dataset, indices, t_steps,
                               t_distilled, **common)
    result["noise_floor_mse"] = t_open.pop("noise_floor_mse")
    result["checkpoints"].append({"name": Path(teacher).name, "open_loop": t_open})
    logger.info("context sensitivity: teacher")
    # image models: permute only the camera (every other stream honest), at
    # the eps level (a variant sharing the true-side pass) and at the
    # trajectory level (open-loop MSE with shuffled images)
    sens_variants = {"context": CONTEXT_KEYS}
    if use_images:
        sens_variants["image"] = IMAGE_KEYS
    sens = context_sensitivity(model, normalizer, schedule, dataset, indices,
                               variants=sens_variants, **common)
    result["context_sensitivity"] = sens["context"]
    b_idx = boundary_windows(dataset, len(indices), seed)

    if use_images:
        result["image_sensitivity"] = sens["image"]
        logger.info("image-shuffled open loop: teacher")
        shuf_open = open_loop_metrics(model, normalizer, schedule, dataset, indices, t_steps,
                                      t_distilled, shuffle_keys=IMAGE_KEYS, **common)
        result["image_shuffled_open_loop"] = {
            "mse": shuf_open["mse"], "mae": shuf_open["mae"], "true_mse": t_open["mse"],
            "mse_ratio_shuffled_over_true":
                shuf_open["mse"] / t_open["mse"] if t_open["mse"] > 0 else float("nan"),
        }
        # the windows where a frame has just become visible: there the newest
        # image alone explains the future (the history still shows the
        # previous cue); elsewhere the history already reveals the target
        if b_idx is not None:
            logger.info(f"boundary-window image probes: teacher ({len(b_idx)} windows)")
            result["image_sensitivity_boundary"] = context_sensitivity(
                model, normalizer, schedule, dataset, b_idx, keys=IMAGE_KEYS, **common)
            bt = open_loop_metrics(model, normalizer, schedule, dataset, b_idx, t_steps,
                                   t_distilled, **common)
            bsh = open_loop_metrics(model, normalizer, schedule, dataset, b_idx, t_steps,
                                    t_distilled, shuffle_keys=IMAGE_KEYS, **common)
            result["image_shuffled_open_loop_boundary"] = {
                "num_windows": int(len(b_idx)),
                "mse": bsh["mse"], "mae": bsh["mae"], "true_mse": bt["mse"],
                "noise_floor_mse": bt["noise_floor_mse"],
                "mse_ratio_shuffled_over_true":
                    bsh["mse"] / bt["mse"] if bt["mse"] > 0 else float("nan"),
            }
        # the vision dummy task's achievable cued / blind errors on the same
        # windows: the ceiling of the shuffled / true ratios above
        recs = getattr(dataset, "dummy_recordings", None)
        if recs and getattr(recs[0], "vision_u", None) is not None:
            logger.info("vision Bayes-oracle calibration")
            result["oracle_open_loop"] = vision_oracle_open_loop(dataset, indices, seed=seed)
            if b_idx is not None:
                result["oracle_open_loop_boundary"] = vision_oracle_open_loop(dataset, b_idx,
                                                                              seed=seed)

    if guidance_rows and t_distilled:
        logger.warning("guidance rows skipped: the teacher checkpoint is a distilled "
                       "single-forward student (no score to guide)")
    elif guidance_rows:
        result["guidance"] = []
        for scale, mods in guidance_rows:
            logger.info(f"CFG open loop: scale {scale}, null {list(mods)}")
            guide = dict(guidance_scale=scale, guidance_null=mods, **common)
            g_open = open_loop_metrics(model, normalizer, schedule, dataset, indices, t_steps,
                                       t_distilled, **guide)
            row = {"scale": scale, "null": list(mods), "sampler": g_open["sampler"],
                   "mse": g_open["mse"], "mae": g_open["mae"], "true_mse": t_open["mse"]}
            if b_idx is not None:
                g_b = open_loop_metrics(model, normalizer, schedule, dataset, b_idx, t_steps,
                                        t_distilled, **guide)
                row["boundary_mse"] = g_b["mse"]
                row["boundary_mae"] = g_b["mae"]
                if "image" in mods:
                    # the camera's contribution under the guided sampler: the
                    # same guidance with the images shuffled
                    g_bs = open_loop_metrics(model, normalizer, schedule, dataset, b_idx,
                                             t_steps, t_distilled, shuffle_keys=IMAGE_KEYS,
                                             **guide)
                    row["boundary_shuffled_mse"] = g_bs["mse"]
                    row["boundary_ratio_shuffled_over_true"] = (
                        g_bs["mse"] / g_b["mse"] if g_b["mse"] > 0 else float("nan"))
            result["guidance"].append(row)

    def eval_row(name, s_model, s_steps, s_distilled, solver="ddim"):
        """One row besides the teacher's: open loop against the ground truth,
        agreement with and closed-loop divergence from the teacher (students
        and training-free solver rows alike)."""
        logger.info(f"open-loop eval: {name}")
        s_open = open_loop_metrics(s_model, normalizer, schedule, dataset, indices, s_steps,
                                   s_distilled, solver=solver, **common)
        s_open.pop("noise_floor_mse")
        agreement = sampler_agreement(model, s_model, normalizer, schedule, dataset, indices,
                                      t_steps, s_steps, s_distilled, student_solver=solver,
                                      **common)
        logger.info(f"closed-loop divergence: {name} vs teacher")
        divergence = closed_loop_divergence(
            model, s_model, schedule, normalizer, t_steps, s_steps, s_distilled,
            batch_size=min(batch_size, 64), num_chunks=chunks, seed=seed,
            student_solver=solver, noise_fn=noise_fn, device=device)
        result["checkpoints"].append({"name": name, "open_loop": s_open,
                                      "agreement": agreement, "divergence": divergence})

    loaded_students = []
    for spath in students:
        _, s_state, _, s_steps, s_distilled = _load(spath, prefer_ema)
        s_model = build_policy(config.model, s_state, device)
        eval_row(Path(spath).name, s_model, s_steps, s_distilled)
        loaded_students.append((Path(spath).name, s_model, s_steps, s_distilled))

    for solver, steps in solver_rows:
        eval_row(f"teacher+{solver_label(solver, steps)}", model, steps, False, solver=solver)

    if posterior_mean_k > 1 and use_images and b_idx is not None:
        # the posterior-mean estimator on the boundary windows: K sampled
        # trajectories averaged a context before the MSE, the class of the
        # Bayes-oracle rows (a single draw carries the posterior variance,
        # which inflates both sides of the single-draw ratios); every row
        # carries its serving cost, denoiser evaluations a replan (nfe)
        pm_rows = []

        def pm_row(name, row_model, steps, distilled, k, scale=1.0, mods=()):
            label = f"K={k}" + (f" cfg{scale:g}" if scale != 1.0 else "")
            logger.info(f"posterior-mean boundary open loop: {name} {label}")
            kw = dict(common)
            if k > 1:
                kw["mean_of"] = k
            if scale != 1.0:
                kw.update(guidance_scale=scale, guidance_null=mods)
            pm_t = open_loop_metrics(row_model, normalizer, schedule, dataset, b_idx, steps,
                                     distilled, **kw)
            pm_s = open_loop_metrics(row_model, normalizer, schedule, dataset, b_idx, steps,
                                     distilled, shuffle_keys=IMAGE_KEYS, **kw)
            nfe = (1 if distilled else steps) * k * (2 if scale != 1.0 else 1)
            pm_rows.append({
                "name": name, "scale": scale, "k": k, "nfe": int(nfe),
                "sampler": pm_t["sampler"], "true_mse": pm_t["mse"], "shuffled_mse": pm_s["mse"],
                "ratio_shuffled_over_true":
                    pm_s["mse"] / pm_t["mse"] if pm_t["mse"] > 0 else float("nan"),
            })

        guided_variants = [] if t_distilled else [(s, m) for s, m in guidance_rows
                                                  if "image" in m]
        for scale, mods in [(1.0, ())] + guided_variants:
            pm_row("teacher", model, t_steps, t_distilled, posterior_mean_k, scale, mods)
        for s_name, s_model, s_steps, s_distilled in loaded_students:
            # a single draw and the posterior mean: a student distilled from a
            # posterior-mean teacher draws a mean estimate already
            pm_row(s_name, s_model, s_steps, s_distilled, 1)
            pm_row(s_name, s_model, s_steps, s_distilled, posterior_mean_k)
        result["posterior_mean_boundary"] = {"k": posterior_mean_k,
                                             "num_windows": int(len(b_idx)), "rows": pm_rows}

    if students or solver_rows:
        logger.info("teacher noise-resampling self-consistency")
        result["teacher_self_consistency"] = self_consistency(
            model, schedule, normalizer, t_steps, batch_size=min(batch_size, 64),
            num_chunks=chunks, seed=seed, noise_fn=noise_fn, device=device)
    return result


def parse_solver_row(row: str) -> tuple[str, int]:
    """``'dpmpp10'`` / ``'dpmpp10@lambda'`` -> ``('dpmpp@lambda', 10)``;
    raises ``ValueError``."""
    m = re.fullmatch(r"([a-z]+)(\d+)(@[a-z]+)?", row)
    if not m:
        raise ValueError(f"bad --solver-row {row!r}; expected e.g. dpmpp10 or dpmpp10@lambda")
    solver = m.group(1) + (m.group(3) or "")
    parse_solver(solver)
    return solver, int(m.group(2))


def main(argv=None):
    from soccerdiffusion_tpu_torch.data.pipeline import parse_guidance_spec
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    parser = argparse.ArgumentParser(description="Sampler quality report (PyTorch port)")
    parser.add_argument("--teacher", required=True)
    parser.add_argument("--student", action="append", default=[],
                        help="distilled checkpoint (repeatable)")
    parser.add_argument("--dummy-data", action="store_true")
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--windows", type=int, default=256)
    parser.add_argument("--chunks", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="quality_report")
    parser.add_argument("--solver-row", action="append", default=[],
                        help="training-free sampler row on the teacher's weights, e.g. 'dpmpp10' "
                             "or 'dpmpp10@lambda' (repeatable)")
    parser.add_argument("--raw-weights", action="store_true",
                        help="evaluate the raw parameters of EMA checkpoints (ablation)")
    parser.add_argument("--guidance-row", action="append", default=[],
                        help="classifier-free-guidance row on the teacher, "
                             "SCALE[@MODALITY[,MODALITY...]], e.g. '2.0@image' (repeatable)")
    parser.add_argument("--posterior-mean", type=int, default=0,
                        help="K>1: boundary-window rows averaging K sampled trajectories a "
                             "context before the MSE, each with its NFE a replan")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    solver_rows, guidance_rows = [], []
    try:
        solver_rows = [parse_solver_row(row) for row in args.solver_row]
        guidance_rows = [parse_guidance_spec(row) for row in args.guidance_row]
    except ValueError as e:
        parser.error(str(e))

    teacher_loaded = _load(args.teacher, prefer_ema=not args.raw_weights)
    config = Config.from_dict(teacher_loaded[0])
    dataset = build_dataset(config, args.seed, args.dummy_data, db=args.db)
    result = run_report(args.teacher, args.student, dataset, args.windows, args.chunks,
                        args.batch_size, args.seed, teacher_loaded=teacher_loaded,
                        solver_rows=solver_rows, raw_weights=args.raw_weights,
                        guidance_rows=guidance_rows, posterior_mean_k=args.posterior_mean,
                        device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_suffix(".json").write_text(json.dumps(result, indent=2))
    out.with_suffix(".md").write_text(markdown_report(result))
    logger.info(f"wrote {out.with_suffix('.json')} and {out.with_suffix('.md')}")
    return result


if __name__ == "__main__":
    main()
