"""The numpy image arithmetic ``ingest/`` uses in place of cv2
(``data/resize.py``, ``ingest/bhuman.py``, ``ingest/converters.py``)
against cv2 5.0 on seeded uint8 frames:

  * INTER_CUBIC (``resize_cubic``) equal to OpenCV's own arithmetic
    (``cv2.ipp.setUseIPP(False)``) pixel for pixel: up and down, square and
    not, odd sizes, 64 -> 480 (the committed bag's frames into the schema's)
    and B-Human's 12 x 16 -> 480, 1 and 3 channels, rows whose width is and
    is not a multiple of OpenCV's 8-value vector; against IPP (cv2's
    default where it was built with it) within one level on at most 6% of
    the pixels;
  * INTER_LINEAR (``resize_linear``, B-Human's lower-camera frame brought to
    the upper one's size): exact along one axis, within one level on at
    most 0.5% of the pixels in two (cv2's tail of each row rounds otherwise);
  * YUV -> BGR (``yuv_to_bgr``) equal to ``cv2.cvtColor(COLOR_YUV2BGR)`` on
    all 2^24 inputs; the converters' channel slices equal
    ``cv2.cvtColor`` BGR2RGB / BGRA2RGB.

cv2 is imported only here, to hold the port to it; the port never imports
it outside ``bhuman.show_video``.
"""

import numpy as np
import pytest

from soccerdiffusion_tpu_torch.data.resize import resize_cubic, resize_linear
from soccerdiffusion_tpu_torch.ingest.bhuman import yuv_to_bgr
from soccerdiffusion_tpu_torch.ingest.converters import BHumanImageConverter, BitbotsImageConverter
from soccerdiffusion_tpu_torch.ingest.rows import InputData, RecordingRow

cv2 = pytest.importorskip("cv2")


@pytest.fixture
def ipp():
    """Set cv2's IPP use for a test, restored after."""
    before = cv2.ipp.useIPP()
    yield cv2.ipp.setUseIPP
    cv2.ipp.setUseIPP(before)


def frame(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def cv2_resize(img, h, w, interpolation):
    out = cv2.resize(img if img.shape[2] > 1 else img[..., 0], (w, h), interpolation=interpolation)
    return out.reshape(h, w, img.shape[2])


CUBIC_CASES = [((64, 64), (480, 480), 3), ((64, 64), (480, 480), 1), ((12, 16), (480, 480), 3),
               ((37, 53), (101, 77), 3), ((100, 80), (33, 47), 3), ((13, 17), (29, 31), 1),
               ((60, 40), (300, 47), 1), ((60, 40), (300, 15), 1), ((5, 7), (3, 2), 3),
               ((2, 2), (9, 9), 3), ((1, 5), (4, 9), 1), ((48, 64), (480, 480), 4),
               ((480, 640), (224, 224), 3)]


@pytest.mark.parametrize("src,dst,c", CUBIC_CASES)
def test_cubic_equals_opencv(src, dst, c, ipp):
    ipp(False)
    for seed in (0, 1):
        img = frame(*src, c, seed)
        got = resize_cubic(img, *dst)
        assert got.dtype == np.uint8 and got.shape == (*dst, c)
        np.testing.assert_array_equal(got, cv2_resize(img, *dst, cv2.INTER_CUBIC))


@pytest.mark.parametrize("src,dst", [((64, 64), (480, 480)), ((12, 16), (480, 480)),
                                     ((37, 53), (101, 77))])
def test_cubic_against_ipp_within_one(src, dst, ipp):
    ipp(True)
    img = frame(*src, seed=2)
    diff = np.abs(resize_cubic(img, *dst).astype(int) - cv2_resize(img, *dst, cv2.INTER_CUBIC))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.06


def test_cubic_refuses_other_frames_and_keeps_same_size():
    img = frame(8, 8)
    assert resize_cubic(img, 8, 8) is img
    with pytest.raises(ValueError, match="uint8"):
        resize_cubic(img.astype(np.float32), 16, 16)


@pytest.mark.parametrize("src,dst", [((480, 640), (960, 1280)), ((64, 64), (480, 480)),
                                     ((37, 53), (101, 77)), ((960, 1280), (480, 640))])
def test_linear_within_one(src, dst):
    img = frame(*src, seed=4)
    diff = np.abs(resize_linear(img, *dst).astype(int) - cv2_resize(img, *dst, cv2.INTER_LINEAR))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005


@pytest.mark.parametrize("src,dst", [((1, 64), (1, 480)), ((64, 1), (480, 1)), ((1, 37), (1, 11))])
def test_linear_exact_along_one_axis(src, dst):
    img = frame(*src, seed=5)
    np.testing.assert_array_equal(resize_linear(img, *dst), cv2_resize(img, *dst, cv2.INTER_LINEAR))


def test_yuv_to_bgr_equals_cv2_on_every_input():
    y, u, v = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    yuv = np.stack([y, u, v], -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(yuv_to_bgr(yuv), cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR))


@pytest.mark.parametrize("encoding,code", [("bgr8", cv2.COLOR_BGR2RGB), ("bgra8", cv2.COLOR_BGRA2RGB),
                                           ("rgb8", None)])
def test_bitbots_frames_equal_cv2_conversion(encoding, code, ipp):
    ipp(False)
    c = 4 if encoding == "bgra8" else 3
    for shape in ((64, 64), (480, 640)):
        img = frame(*shape, c, seed=6)
        rec = RecordingRow(original_file="x", team_name="t", robot_type="r")
        data = InputData(image=type("Image", (), dict(height=shape[0], width=shape[1],
                                                      encoding=encoding, data=img.tobytes())))
        conv = BitbotsImageConverter(None)
        conv.populate_recording_metadata(data, rec)
        got = conv._create_image(data, 0.0, rec).image
        interpolation = cv2.INTER_CUBIC if shape == (64, 64) else cv2.INTER_AREA
        want = cv2.resize(img, (480, 480), interpolation=interpolation)
        want = want if code is None else cv2.cvtColor(want, code)
        if shape == (64, 64):
            np.testing.assert_array_equal(got, want)
        else:  # INTER_AREA of a non-square frame: tests/test_torch_resize.py's bound
            diff = np.abs(got.astype(int) - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.005


def test_bhuman_frames_equal_cv2_conversion(ipp):
    ipp(False)
    img = frame(12, 16, seed=7)
    rec = RecordingRow(original_file="x", team_name="t", robot_type="r")
    data = InputData(image=img)
    conv = BHumanImageConverter(None)
    conv.populate_recording_metadata(data, rec)
    want = cv2.cvtColor(cv2.resize(img, (480, 480), interpolation=cv2.INTER_CUBIC),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(conv._create_image(data, 0.0, rec).image, want)
