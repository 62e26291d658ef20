"""The port's data modules (data/dummy.py, data/dataset.py) against the JAX
package's: the same seed gives bit-identical arrays."""

import dataclasses

import numpy as np
import pytest

from soccerdiffusion_tpu.data import WindowedDataset as JaxDataset
from soccerdiffusion_tpu.data import generate_dummy_arrays as jax_dummy
from soccerdiffusion_tpu_torch.data import RobotState, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.pipeline import prefetch_to_device, prepare_batch

from tests.test_torch_jax_params import SMALL, port_config


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("imu", ["quaternion", "five_dim"])
def test_batches_and_targets_match_jax(seed, imu):
    cfg = dataclasses.replace(SMALL, imu_orientation_embedding_method=imu)
    ours = generate_dummy_arrays(num_recordings=2, num_samples=80, num_joints=6, seed=seed)
    theirs = jax_dummy(num_recordings=2, num_samples=80, num_joints=6, seed=seed)
    for a, b in zip(ours, theirs):
        for name in ("joint_commands", "joint_states", "rotations", "game_states", "image_stamps"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    ds, jds = WindowedDataset.from_dummy(ours, port_config(cfg)), JaxDataset.from_dummy(theirs, cfg)
    assert len(ds) == len(jds)
    np.testing.assert_array_equal(ds.sample_targets(50, seed=seed), jds.sample_targets(50, seed=seed))
    n = 0
    for got, want in zip(ds.batches(8, shuffle=True, seed=seed), jds.batches(8, shuffle=True, seed=seed)):
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    assert n == len(ds) // 8


def test_robot_state_ids():
    assert [int(s) for s in RobotState] == [0, 1, 2, 3]
    assert int(RobotState.UNKNOWN) == 3


def test_images_raise_and_cpu_prefetch_wraps():
    """Images are ported (tests/test_torch_flagship_data.py); an unknown
    dummy task raises, and a frame of another size is resized with INTER_AREA
    (tests/test_torch_resize.py holds the resize to cv2)."""
    from soccerdiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD, preprocess_image

    with pytest.raises(ValueError, match="unknown dummy task"):
        generate_dummy_arrays(task="bogus")
    big = np.full((48, 48, 3), 200, np.uint8)
    big[:24] = 40  # the top half dark: 48 -> 32 maps rows 0-23 onto rows 0-15
    img = preprocess_image(big, 32)
    assert img.shape == (32, 32, 3) and img.dtype == np.float32
    value = lambda v: (np.float32(v) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_array_equal(img[:16], np.broadcast_to(value(40), (16, 32, 3)))
    np.testing.assert_array_equal(img[16:], np.broadcast_to(value(200), (16, 32, 3)))
    frames = generate_dummy_arrays(num_samples=30, with_images=True, image_size=8)[0].images
    assert frames.shape == (3, 8, 8, 3)
    batch = {"image_u8": np.zeros(1)}
    assert prepare_batch(batch, keep_u8=True) is batch
    ds = WindowedDataset.from_dummy(generate_dummy_arrays(num_samples=40, num_joints=6),
                                    port_config(SMALL))
    batches = list(prefetch_to_device(ds.batches(4, shuffle=False), "cpu"))
    assert len(batches) == len(ds) // 4
    np.testing.assert_array_equal(batches[0]["joint_command"].numpy(),
                                  next(ds.batches(4, shuffle=False))["joint_command"])
