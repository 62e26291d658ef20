from soccerdiffusion_tpu_torch.data.dataset import WindowedDataset
from soccerdiffusion_tpu_torch.data.dummy import generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.data.schema import RobotState

__all__ = ["Normalizer", "RobotState", "WindowedDataset", "generate_dummy_arrays"]
