from soccerdiffusion_tpu_torch.inference.rollout import RolloutCarry, RolloutEngine

__all__ = ["RolloutCarry", "RolloutEngine"]
