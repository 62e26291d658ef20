from soccerdiffusion_tpu_torch.models.policy import DiffusionPolicy

__all__ = ["DiffusionPolicy"]
