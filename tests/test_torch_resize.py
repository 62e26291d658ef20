"""The port's numpy INTER_AREA resize (data/resize.py) against cv2 and
against the JAX package's ``preprocess_image`` (which calls cv2), on seeded
random uint8 frames and on the dummy recordings' test pattern:

  * square frames: exact, at integer factors (2, 3, 4, 5), at non-integer
    factors and 480 -> 224 (the schema's default frame into every shipped
    image YAML);
  * non-square frames (640 x 480, 1280 x 720, a mixed up/down scale): within
    1, at least 99.5% of the pixels exact;
  * upscales: within 1, at least 99.5% exact.

cv2 is imported only here, to hold the port to it; the port never imports it.
"""

import numpy as np
import pytest

from soccerdiffusion_tpu.data import dataset as jds
from soccerdiffusion_tpu_torch.data import dataset as pds
from soccerdiffusion_tpu_torch.data.dummy import _draw_test_image
from soccerdiffusion_tpu_torch.data.resize import resize_area

cv2 = pytest.importorskip("cv2")

EXACT_SHARE = 0.995


def frame(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def cv2_area(img, h, w):
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("src,dst", [(64, 32), (96, 32), (128, 32), (160, 32), (448, 224),
                                     (48, 32), (40, 32), (56, 32), (300, 224), (480, 224),
                                     (480, 96), (480, 64)])
def test_square_frames_are_exact(src, dst):
    for seed in (0, 1):
        img = frame(src, src, seed)
        got = resize_area(img, dst, dst)
        assert got.dtype == np.uint8 and got.shape == (dst, dst, 3)
        np.testing.assert_array_equal(got, cv2_area(img, dst, dst))


@pytest.mark.parametrize("src,dst", [(480, 224), (48, 32), (448, 224)])
def test_preprocess_image_matches_jax(src, dst):
    """The window pipeline's frame: resized, scaled and normalised, equal in
    float32 to the JAX package's, on noise and on the dummy test pattern."""
    for img in (frame(src, src, 3), _draw_test_image(src, src, 0.7)):
        np.testing.assert_array_equal(pds.preprocess_image(img, dst), jds.preprocess_image(img, dst))


@pytest.mark.parametrize("shape,dst", [((480, 640), (224, 224)), ((720, 1280), (224, 224)),
                                       ((64, 96), (32, 32)), ((40, 20), (32, 32)),
                                       ((480, 640), (240, 320))])
def test_non_square_frames_within_one(shape, dst):
    img = frame(*shape, seed=5)
    diff = np.abs(resize_area(img, *dst).astype(int) - cv2_area(img, *dst))
    assert diff.max() <= 1 and (diff == 0).mean() >= EXACT_SHARE, (diff.max(), (diff == 0).mean())


@pytest.mark.parametrize("shape,dst", [((32, 32), (48, 48)), ((32, 32), (64, 64)),
                                       ((24, 24), (32, 32)), ((100, 100), (224, 224)),
                                       ((20, 30), (32, 48))])
def test_upscales_within_one(shape, dst):
    img = frame(*shape, seed=6)
    diff = np.abs(resize_area(img, *dst).astype(int) - cv2_area(img, *dst))
    assert diff.max() <= 1 and (diff == 0).mean() >= EXACT_SHARE, (diff.max(), (diff == 0).mean())


def test_same_size_passes_and_bad_input_raises():
    img = frame(32, 32)
    assert resize_area(img, 32, 32) is img
    with pytest.raises(ValueError, match="uint8"):
        resize_area(img.astype(np.float32), 16, 16)
    with pytest.raises(ValueError, match="uint8"):
        resize_area(img[..., 0], 16, 16)
