from soccerdiffusion_tpu_torch.data.normalizer import Normalizer

__all__ = ["Normalizer"]
