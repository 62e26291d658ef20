"""The flagship's image data path against the JAX package:

  * dummy images ("decorative" test patterns and the "vision" cue task),
    image windows with their stamps, the vision_u labels, the boundary
    windows and the oversampled epoch order, and packed uint8 batches (whole
    frames and pre-patchified): bit-identical, from the same seeds;
  * device_normalize_images / prepare_batch against the JAX functions;
  * the ViT's raw-uint8 ``valid`` fold (whole and pre-patchified frames,
    invalid frames among them) and the image-sequence encoder's ``valid``
    path against flax within 2e-5 (float32 summation order through 2 blocks
    at unit-scale activations), and the fold's patch-parameter gradients
    against jax.grad within 1e-4 of their scale;
  * the port's vit_flagship.yaml equal to the JAX package's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from soccerdiffusion_tpu.config import ModelConfig as JaxModelConfig
from soccerdiffusion_tpu.data import dataset as jds
from soccerdiffusion_tpu.data import dummy as jdummy
from soccerdiffusion_tpu.data import pipeline as jpipe
from soccerdiffusion_tpu.data.packed import PackedDataset as JaxPacked
from soccerdiffusion_tpu.models.vision import ImageSequenceEncoder as JaxSeqEncoder
from soccerdiffusion_tpu.models.vision import ViTImageEncoder as JaxViT
from soccerdiffusion_tpu_torch.data import dataset as pds
from soccerdiffusion_tpu_torch.data import dummy as pdummy
from soccerdiffusion_tpu_torch.data import pipeline as ppipe
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.models.vision import ImageSequenceEncoder, ViTImageEncoder
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params

from tests.test_torch_jax_params import port_config

REPO = Path(__file__).resolve().parent.parent
RES, PATCH, WIDTH, DEPTH, HIDDEN, FRAMES = 32, 8, 64, 2, 48, 3
CFG = JaxModelConfig(
    num_joints=6, hidden_dim=HIDDEN, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=12, imu_context_length=12, use_images=True,
    image_encoder_type="vit", image_resolution=RES, image_context_length=FRAMES,
    vit_patch_size=PATCH, vit_width=WIDTH, vit_depth=DEPTH, attention_impl="xla")


def datasets(task="decorative", five_dim=False, n=90):
    """The JAX and the port's WindowedDataset over the same dummy seed."""
    cfg = CFG if not five_dim else JaxModelConfig(
        **{**CFG.__dict__, "imu_orientation_embedding_method": "five_dim"})
    kw = dict(num_recordings=2, num_samples=n, num_joints=6, image_size=RES, with_images=True,
              seed=4, task=task)
    return (jds.WindowedDataset.from_dummy(jdummy.generate_dummy_arrays(**kw), cfg),
            pds.WindowedDataset.from_dummy(pdummy.generate_dummy_arrays(**kw), port_config(cfg)))


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("task", ["decorative", "vision"])
def test_dummy_images_are_bit_identical(task):
    kw = dict(num_recordings=2, num_samples=45, num_joints=5, image_size=24, with_images=True,
              seed=7, task=task)
    for got, want in zip(pdummy.generate_dummy_arrays(**kw), jdummy.generate_dummy_arrays(**kw)):
        for field in ("joint_commands", "joint_states", "rotations", "game_states", "image_stamps",
                      "images", "vision_u", "vision_dirs"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None), field
            if b is not None:
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("task", ["decorative", "vision"])
def test_image_windows_labels_and_oversampling_match(task):
    jd, pd = datasets(task)
    assert len(pd) == len(jd)
    for idx in (0, 3, 10, 11, 29, len(jd) - 1):
        assert_batches_equal(pd[idx], jd[idx])
    assert ("vision_u" in pd[5]) == (task == "vision")
    boundary = pd.image_boundary_indices()
    np.testing.assert_array_equal(boundary, jd.image_boundary_indices())
    assert len(boundary) > 0
    order = pd.oversampled_order(len(pd), boundary, 0.3, np.random.default_rng(5))
    np.testing.assert_array_equal(
        order, jd.oversampled_order(len(jd), boundary, 0.3, np.random.default_rng(5)))
    for got, want in zip(pd.batches(4, order=order[:8]), jd.batches(4, order=order[:8])):
        assert_batches_equal(got, want)


@pytest.mark.parametrize("prepatchify", [False, True])
def test_packed_batches_match(prepatchify):
    jw, pw = datasets(five_dim=prepatchify)
    jp, pp = JaxPacked.from_windowed(jw), PackedDataset.from_windowed(pw)
    if prepatchify:
        jp.prepatchify_images(PATCH)
        pp.prepatchify_images(PATCH)
    assert len(pp) == len(jp)
    np.testing.assert_array_equal(pp.image_boundary_indices(), jp.image_boundary_indices())
    np.testing.assert_array_equal(pp.sample_targets(20, seed=3), jp.sample_targets(20, seed=3))
    for got, want in zip(pp.batches(6, seed=2), jp.batches(6, seed=2)):
        assert_batches_equal(got, want)
        assert got["image_u8"].dtype == np.uint8
    assert pp.images.ndim == (3 if prepatchify else 4)


def test_normalisation_matches_jax():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (2, FRAMES, RES, RES, 3), dtype=np.uint8)
    valid = np.array([[0, 1, 1], [1, 1, 0]], np.float32)
    patches = np.asarray(jpipe.patchify_frames(u8, PATCH))
    np.testing.assert_array_equal(ppipe.patchify_frames(u8, PATCH), patches)
    np.testing.assert_array_equal(ppipe.patchify_frames(torch.from_numpy(u8), PATCH).numpy(),
                                  patches)
    for frames in (u8, patches):
        want = np.asarray(jpipe.device_normalize_images(jnp.asarray(frames), jnp.asarray(valid)))
        got = ppipe.device_normalize_images(torch.from_numpy(frames), torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    batch = {"image_u8": torch.from_numpy(u8), "image_valid": torch.from_numpy(valid)}
    assert ppipe.prepare_batch(batch, keep_u8=True) is batch
    assert set(ppipe.prepare_batch(batch)) == {"image_data"}


def noisy(params, rng):
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("prepatchified", [False, True])
def test_vit_uint8_fold_matches_flax(prepatchified):
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (4, RES, RES, 3), dtype=np.uint8)
    valid = np.array([1, 0, 1, 1], np.float32)  # an invalid (padded) frame among them
    x = np.asarray(jpipe.patchify_frames(u8, PATCH)) if prepatchified else u8
    # the plain blocks: the fold is the patch embedding, ahead of them (the
    # fused block and its gradient have tests of their own)
    jvit = JaxViT(HIDDEN, patch_size=PATCH, width=WIDTH, depth=DEPTH, fused_gelu="quick")
    params = noisy(jvit.init(jax.random.key(0), jnp.asarray(u8), False,
                             valid=jnp.asarray(valid))["params"], rng)
    apply = lambda p: jvit.apply({"params": p}, jnp.asarray(x), False, valid=jnp.asarray(valid))
    ref = np.asarray(apply(params))
    vit = load_jax_params(ViTImageEncoder(HIDDEN, RES, PATCH, WIDTH, DEPTH, fused_gelu="quick"),
                          params)
    got = vit(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-5, rtol=0)
    # the fold is differentiable: the patch parameters' gradients match jax.grad
    dy = rng.standard_normal(ref.shape).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(apply(p) * dy))(params)
    (got * torch.from_numpy(dy)).sum().backward()
    for name in ("patch_kernel", "patch_bias"):
        w = np.asarray(want[name])
        np.testing.assert_allclose(getattr(vit, name).grad.numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


def test_sequence_encoder_uint8_path_matches_flax():
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (2, FRAMES, RES, RES, 3), dtype=np.uint8)
    patches = np.asarray(jpipe.patchify_frames(u8, PATCH))  # (B, T, patches, P*P*3)
    valid = np.array([[0, 1, 1], [1, 1, 1]], np.float32)
    kw = dict(hidden_dim=HIDDEN, encoder_type="vit", sequence_encoder_type="transformer",
              num_layers=1, max_seq_len=FRAMES)
    jenc = JaxSeqEncoder(**kw, vit_geometry=(PATCH, WIDTH, DEPTH), vit_fused_block=True,
                         vit_fused_gelu="quick", seq_fused_stack=True)
    params = noisy(jenc.init(jax.random.key(1), jnp.asarray(u8), False,
                             valid=jnp.asarray(valid))["params"], rng)
    enc = load_jax_params(ImageSequenceEncoder(HIDDEN, "vit", "transformer", 1, FRAMES, RES,
                                               (PATCH, WIDTH, DEPTH), vit_fused_block=True,
                                               vit_fused_gelu="quick", seq_fused_stack=True), params)
    with torch.no_grad():
        for x in (u8, patches):
            ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(x), False,
                                        valid=jnp.asarray(valid)))
            got = enc(torch.from_numpy(x), valid=torch.from_numpy(valid))
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_flagship_yaml_equals_the_jax_file():
    port = yaml.safe_load((REPO / "soccerdiffusion_tpu_torch/training/configs/vit_flagship.yaml")
                          .read_text())
    jax_cfg = yaml.safe_load((REPO / "soccerdiffusion_tpu/training/configs/vit_flagship.yaml")
                             .read_text())
    assert port == jax_cfg


def test_frames_that_need_a_resize_raise():
    """Frames at the config's resolution pass unresized; others are resized
    with the port's numpy INTER_AREA, equal to the JAX package's cv2 resize
    (the name is kept from when such frames raised)."""
    frame = np.zeros((RES, RES, 3), np.uint8)
    assert pds.preprocess_image(frame, RES).shape == (RES, RES, 3)
    bigger = np.random.default_rng(2).integers(0, 256, (RES + 8, RES + 8, 3), dtype=np.uint8)
    got = pds.preprocess_image(bigger, RES)
    assert got.shape == (RES, RES, 3)
    np.testing.assert_array_equal(got, jds.preprocess_image(bigger, RES))


def test_epoch_order_is_the_jax_trainers():
    """train.py's epoch order under boundary_oversample is the JAX trainer's
    (soccerdiffusion_tpu/training/train.py: oversampled_order over the
    image-boundary windows, rng seeded seed + epoch), not the plain shuffle."""
    from soccerdiffusion_tpu_torch.training.train import epoch_order

    jd, pd = datasets("vision")
    for seed in (0, 3):
        want = jd.oversampled_order(len(jd), jd.image_boundary_indices(), 0.3,
                                    np.random.default_rng(seed))
        got = epoch_order(pd, pd.image_boundary_indices(), 0.3, seed)
        np.testing.assert_array_equal(got, want)
        shuffle = np.arange(len(pd))
        np.random.default_rng(seed).shuffle(shuffle)
        assert (got != shuffle).mean() > 0.25  # the uniform shuffle is another order
    assert epoch_order(pd, None, 0.3, 0) is None
