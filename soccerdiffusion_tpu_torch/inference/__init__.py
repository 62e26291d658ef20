from soccerdiffusion_tpu_torch.inference.player import select_action, select_action_index
from soccerdiffusion_tpu_torch.inference.rollout import RolloutCarry, RolloutEngine
from soccerdiffusion_tpu_torch.inference.sampler import make_chunk_sampler

__all__ = ["RolloutCarry", "RolloutEngine", "make_chunk_sampler", "select_action",
           "select_action_index"]
