from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params

__all__ = ["load_jax_params"]
