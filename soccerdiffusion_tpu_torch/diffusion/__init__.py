"""Diffusion schedule, DDIM, DDPM and the linear solver table, in torch / numpy."""

from soccerdiffusion_tpu_torch.diffusion.ddim import (
    add_noise,
    ddim_sample,
    ddim_step,
    ddim_timesteps,
    ddpm_sample,
    ddpm_step,
)
from soccerdiffusion_tpu_torch.diffusion.dpm_solver import (
    parse_solver,
    solver_coef_table,
    solver_label,
    solver_sample,
    solver_timesteps,
)
from soccerdiffusion_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule

__all__ = [
    "DiffusionSchedule",
    "make_schedule",
    "add_noise",
    "ddim_timesteps",
    "ddim_step",
    "ddim_sample",
    "ddpm_step",
    "ddpm_sample",
    "parse_solver",
    "solver_coef_table",
    "solver_label",
    "solver_sample",
    "solver_timesteps",
]
