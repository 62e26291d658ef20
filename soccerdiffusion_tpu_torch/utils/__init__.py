from soccerdiffusion_tpu_torch.utils.geometry import (
    quats_to_5d,
    shift_radian_to_positive_range,
    shift_radian_to_symmetric_range,
    wxyz2xyzw,
    xyzw2wxyz,
)
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params

__all__ = ["load_jax_params", "quats_to_5d", "shift_radian_to_positive_range",
           "shift_radian_to_symmetric_range", "xyzw2wxyz", "wxyz2xyzw"]
