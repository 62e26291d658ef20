"""Quality evaluation (counterpart of ``soccerdiffusion_tpu/evaluation/``):
recorded numbers beside the speed figures, so that sampler variants (the
30-step teacher, few-step and 1-step distilled students, training-free
solvers) can be ranked and regressions caught.

  * ``openloop``: per-joint MSE / MAE against the ground truth; a student
    against its teacher on the same noise and context; context and image
    sensitivity;
  * ``divergence``: closed-loop rollout divergence under feedback through
    the batched rollout engine, with a noise-resampling yardstick;
  * ``oracle``: the Bayes-oracle ceiling of the "vision" dummy task;
  * ``report``: one command for a JSON and a markdown ledger.
"""

from soccerdiffusion_tpu_torch.evaluation.divergence import (
    closed_loop_divergence,
    rollout_chunks,
    self_consistency,
)
from soccerdiffusion_tpu_torch.evaluation.openloop import (
    context_sensitivity,
    eval_batches,
    held_out_indices,
    open_loop_metrics,
    sample_trajectories,
    sampler_agreement,
)
from soccerdiffusion_tpu_torch.evaluation.report import markdown_report, run_report

__all__ = [
    "closed_loop_divergence",
    "rollout_chunks",
    "self_consistency",
    "context_sensitivity",
    "eval_batches",
    "held_out_indices",
    "open_loop_metrics",
    "sampler_agreement",
    "sample_trajectories",
    "markdown_report",
    "run_report",
]
