"""Packed shards and the C++ assembler on the CPU (data/packed.py,
native/framepack.cpp, built here with g++):

  * the native assembler's batches equal the numpy assembler's bit for bit
    (quaternion and five-dim IMU, strides 1 and 3, the game-state forward
    fill of both);
  * a build that fails raises with the compiler's message (a missing
    compiler, a compiler that fails), there is no silent fallback;
  * a shard the JAX package saved loads in the port and one the port saved
    loads in the JAX package, with equal batches (whole and pre-patchified
    frames);
  * ``load`` memory-maps the shards read-only and keeps the frames, and
    ``prepatchify_images`` works after it;
  * ``from_windowed`` over a 48 px database packs 32 px frames equal to the
    JAX package's (cv2 there, the numpy resize here).
"""

import numpy as np
import pytest

from soccerdiffusion_tpu.config import ModelConfig as JaxModelConfig
from soccerdiffusion_tpu.data import dataset as jds
from soccerdiffusion_tpu.data import dummy as jdummy
from soccerdiffusion_tpu.data.packed import PackedDataset as JaxPacked
from soccerdiffusion_tpu_torch.data import dataset as pds
from soccerdiffusion_tpu_torch.data import dummy as pdummy
from soccerdiffusion_tpu_torch.data import schema as pschema
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.native import build as native
from tests.test_torch_jax_params import port_config
from tests.test_torch_sqlite import CFG as DB_CFG
from tests.test_torch_sqlite import assert_items_equal, write_db

CFG = JaxModelConfig(
    num_joints=6, hidden_dim=48, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=9, imu_context_length=7, use_images=True,
    image_encoder_type="vit", image_resolution=32, image_context_length=3, vit_patch_size=8,
    vit_width=64, vit_depth=2, attention_impl="xla")


def config(five_dim=False):
    return JaxModelConfig(**{**CFG.__dict__, "imu_orientation_embedding_method":
                             "five_dim" if five_dim else "quaternion"})


def pair(five_dim=False, stride=1, size=32):
    """The JAX package's and the port's packed dataset of the same dummy
    recordings (frames drawn at ``size`` px)."""
    cfg = config(five_dim)
    kw = dict(num_recordings=3, num_samples=70, num_joints=6, image_size=size, with_images=True,
              seed=2)
    jw = jds.WindowedDataset.from_dummy(jdummy.generate_dummy_arrays(**kw), cfg,
                                        trajectory_stride=stride)
    pw = pds.WindowedDataset.from_dummy(pdummy.generate_dummy_arrays(**kw), port_config(cfg),
                                        trajectory_stride=stride)
    return JaxPacked.from_windowed(jw), pw


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("five_dim", [False, True], ids=["imu4", "imu5"])
def test_native_assembler_equals_numpy(five_dim, stride):
    _, pw = pair(five_dim, stride)
    numpy_ds = PackedDataset.from_windowed(pw, assembler="numpy")
    assert numpy_ds.assembler == "numpy"
    for threads in (1, 4):  # the default, and 4 threads of 8 windows at B=32
        native_ds = PackedDataset.from_windowed(pw, num_threads=threads)
        assert native_ds.assembler == "native"
        np.testing.assert_array_equal(native_ds.gs, numpy_ds.gs)  # the forward fill, C and numpy
        assert native_ds.rots.shape[1] == (5 if five_dim else 4)
        for batch in (32, 5):
            for got, want in zip(native_ds.batches(batch, seed=1, drop_remainder=False),
                                 numpy_ds.batches(batch, seed=1, drop_remainder=False)):
                assert_items_equal(got, want)
        np.testing.assert_array_equal(native_ds.sample_targets(40, seed=2),
                                      numpy_ds.sample_targets(40, seed=2))


@pytest.mark.parametrize("compiler,match", [("/nonexistent/bin/g++", "cannot run"),
                                            ("false", "failed")])
def test_failed_build_raises(compiler, match):
    with pytest.raises(RuntimeError, match=match):
        native.load_framepack(compiler)
    assert native.build_dir(compiler) != native.build_dir()
    with pytest.raises(ValueError, match="assembler"):
        PackedDataset(np.zeros((4, 6), np.float32), np.zeros((4, 6), np.float32),
                      np.zeros((4, 4), np.float32), np.zeros(4, np.int32), np.array([0]),
                      np.array([4]), port_config(CFG), assembler="cython")


@pytest.mark.parametrize("prepatchify", [False, True], ids=["frames", "patches"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_load_across_packages(tmp_path, writer, prepatchify):
    jp, pw = pair(five_dim=True, stride=2)
    pp = PackedDataset.from_windowed(pw)
    if prepatchify:
        jp.prepatchify_images(8)
        pp.prepatchify_images(8)
    (jp if writer == "jax" else pp).save(tmp_path / "shard")
    cfg = config(five_dim=True)
    loaded_port = PackedDataset.load(tmp_path / "shard", port_config(cfg), num_threads=2)
    loaded_jax = JaxPacked.load(tmp_path / "shard", cfg)
    assert len(loaded_port) == len(loaded_jax) == len(jp)
    for got, theirs, want in zip(loaded_port.batches(7, seed=3), loaded_jax.batches(7, seed=3),
                                 jp.batches(7, seed=3)):
        assert_items_equal(got, want)
        assert_items_equal(theirs, want)


def test_mmap_round_trip_keeps_the_frames(tmp_path):
    _, pw = pair()
    pp = PackedDataset.from_windowed(pw)
    pp.save(tmp_path / "shard")
    loaded = PackedDataset.load(tmp_path / "shard", pp.cfg)
    for name in ("cmds", "states", "rots", "gs", "images"):
        arr = getattr(loaded, name)
        # a view of the read-only file mapping, not a copy in memory
        assert not arr.flags.writeable and not arr.flags.owndata, name
        np.testing.assert_array_equal(arr, getattr(pp, name), err_msg=name)
    for got, want in zip(loaded.batches(9, seed=0), pp.batches(9, seed=0)):
        assert_items_equal(got, want)
    loaded.prepatchify_images(8)  # copies the read-only frames before the relayout
    pp.prepatchify_images(8)
    assert loaded.images.shape == (len(pp.images), 16, 8 * 8 * 3) and loaded.images.flags.writeable
    np.testing.assert_array_equal(loaded.images, pp.images)
    assert_items_equal(loaded.assemble(np.arange(0, 60, 7)), pp.assemble(np.arange(0, 60, 7)))


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "eager"])
def test_from_windowed_resizes_a_48px_database_like_jax(tmp_path, stream):
    db = write_db(tmp_path / "db.sqlite3", pschema, pdummy)
    jp = JaxPacked.from_windowed(jds.WindowedDataset.from_sqlite(db, DB_CFG,
                                                                 stream_images=stream))
    pp = PackedDataset.from_windowed(pds.WindowedDataset.from_sqlite(db, port_config(DB_CFG),
                                                                     stream_images=stream))
    assert pp.images.shape == jp.images.shape and pp.images.shape[1:] == (32, 32, 3)
    np.testing.assert_array_equal(pp.images, jp.images)
    for got, want in zip(pp.batches(8, seed=5), jp.batches(8, seed=5)):
        assert_items_equal(got, want)
