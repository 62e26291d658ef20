"""``DeviceResidentData`` (data/pipeline.py) on the CPU against
``WindowedDataset.batches`` and the JAX package's ``DeviceResidentData``:
the same batches in the same order, bit for bit (the JAX one pinned to one
of the session's CPU devices), for a seed (with and without the remainder),
for an explicit window order (boundary oversampling) and unshuffled; a
CUDA device without a GPU raises; and ``--device-data`` with ``--packed``
is refused, as neither package's ``DeviceResidentData`` can stack a
``PackedDataset``.
"""

import jax
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.data import dataset as jds
from soccerdiffusion_tpu.data import dummy as jdummy
from soccerdiffusion_tpu.data.pipeline import DeviceResidentData as JaxDeviceData
from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data import dataset as pds
from soccerdiffusion_tpu_torch.data import dummy as pdummy
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.data.pipeline import DeviceResidentData
from soccerdiffusion_tpu_torch.training.train import RunOptions, train
from tests.test_torch_flagship_data import CFG as IMAGE_CFG
from tests.test_torch_jax_params import SMALL, port_config


def datasets(cfg, task="decorative"):
    kw = dict(num_recordings=2, num_samples=60, num_joints=cfg.num_joints,
              image_size=cfg.image_resolution, with_images=cfg.use_images, seed=1, task=task)
    return (jds.WindowedDataset.from_dummy(jdummy.generate_dummy_arrays(**kw), cfg),
            pds.WindowedDataset.from_dummy(pdummy.generate_dummy_arrays(**kw), port_config(cfg)))


def assert_same_batches(got, *wants):
    got = list(got)
    for want in wants:
        want = list(want)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].device.type == "cpu"
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_follow_the_dataset_and_jax(seed, drop_remainder):
    jd, pd = datasets(SMALL)
    resident = DeviceResidentData(pd, device="cpu")
    assert len(resident) == len(pd)
    kw = dict(seed=seed, drop_remainder=drop_remainder)
    assert_same_batches(resident.batches(16, **kw), pd.batches(16, **kw),
                        JaxDeviceData(jd, jax.devices()[0]).batches(16, **kw))


@pytest.mark.parametrize("how", ["order", "unshuffled"])
def test_batches_of_an_order_with_frames_and_labels(how):
    """A camera config (float frames, the "vision" task's vision_u labels):
    the boundary-oversampled order, and the windows in order."""
    jd, pd = datasets(IMAGE_CFG, task="vision")
    resident = DeviceResidentData(pd, device="cpu")
    assert {"image_data", "vision_u", "vision_u_valid"} <= resident.data.keys()
    if how == "order":
        order = pd.oversampled_order(len(pd), pd.image_boundary_indices(), 0.5,
                                     np.random.default_rng(3))
        kw = dict(order=order)
    else:
        kw = dict(shuffle=False)
    assert_same_batches(resident.batches(8, **kw), pd.batches(8, **kw),
                        JaxDeviceData(jd, jax.devices()[0]).batches(8, **kw))


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    _, pd = datasets(SMALL)
    for kw in ({}, dict(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceResidentData(pd, **kw)


def test_device_data_with_packed_raises(tmp_path):
    _, pd = datasets(SMALL)
    with pytest.raises(ValueError, match="--packed"):
        DeviceResidentData(PackedDataset.from_windowed(pd), device="cpu")
    config = Config.from_dict({**port_config(SMALL).__dict__, "batch_size": 4})
    with pytest.raises(ValueError, match="--device-data.*--packed"):
        train(config, RunOptions(output=str(tmp_path / "x"), device="cpu", device_data=True,
                                 packed=True))
