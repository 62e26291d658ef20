"""B-Human ``.log`` import strategy (counterpart of
``soccerdiffusion_tpu/ingest/bhuman.py``).

Counterpart of reference dataset/imports/strategies/b_human.py:16-687. The
proprietary log format needs the ``pybh`` C++ bindings (built from
BHumanCodeRelease; reference README.md:50-56) — that reader is an optional
plugin gated on import. Everything else — NAO->canonical joint mapping
(including the shared hipYawPitch actuator), euler->quaternion IMU
conversion, game-state routing, and the two-clock-domain repair — is plain
Python over an abstract frame stream and fully unit-testable.

Frame stream contract: an iterable of ``BHumanFrame`` where each frame holds
``time_ms`` (B-Human frame clock, milliseconds) and a subset of
representations as plain dicts / arrays.

The JPEG's YUV -> BGR conversion is OpenCV's integer one in numpy
(``yuv_to_bgr``, equal to ``cv2.cvtColor(..., COLOR_YUV2BGR)`` on all 2^24
inputs), and a lower-camera frame of another size than the upper one is
brought to it with OpenCV's bilinear arithmetic (``data/resize.py:
resize_linear``); only ``show_video``, which needs a display, imports cv2.
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Iterable

import numpy as np

from soccerdiffusion_tpu_torch.data.resize import resize_linear
from soccerdiffusion_tpu_torch.ingest.converters import (
    BHumanGameStateConverter,
    BHumanImageConverter,
    Converter,
    SyncedDataConverter,
)
from soccerdiffusion_tpu_torch.ingest.importer import ImportStrategy
from soccerdiffusion_tpu_torch.ingest.rows import ImportMetadata, InputData, ModelData, Quaternion, RecordingRow

logger = logging.getLogger("soccerdiffusion_tpu_torch")

#: canonical snake name -> B-Human angle key (reference b_human.py:320-358).
#: NAO's single hipYawPitch actuator drives both hip yaw columns; rElbowRoll /
#: lElbowRoll map onto the Wolfgang-style elbow columns.
NAO_ANGLE_MAP = {
    "r_shoulder_pitch": "rShoulderPitch",
    "l_shoulder_pitch": "lShoulderPitch",
    "r_shoulder_roll": "rShoulderRoll",
    "l_shoulder_roll": "lShoulderRoll",
    "r_elbow": "rElbowRoll",
    "r_elbow_yaw": "rElbowYaw",
    "l_elbow": "lElbowRoll",
    "l_elbow_yaw": "lElbowYaw",
    "r_hip_yaw": "rHipYawPitch",
    "l_hip_yaw": "lHipYawPitch",
    "r_hip_roll": "rHipRoll",
    "l_hip_roll": "lHipRoll",
    "r_hip_pitch": "rHipPitch",
    "l_hip_pitch": "lHipPitch",
    "r_knee": "rKneePitch",
    "l_knee": "lKneePitch",
    "r_ankle_pitch": "rAnklePitch",
    "l_ankle_pitch": "lAnklePitch",
    "r_ankle_roll": "rAnkleRoll",
    "l_ankle_roll": "lAnkleRoll",
    "head_pan": "headYaw",
    "head_tilt": "headPitch",
}

#: Path-embedded datetime, e.g. bhumand_2024-04-07_14-30 (reference
#: b_human.py:442-485 parses the recording datetime from the file path).
_PATH_DATETIME_RE = re.compile(r"(\d{4})-(\d{2})-(\d{2})[_T ]?(\d{2})[-:](\d{2})")


def map_nao_angles(angles: dict[str, float]) -> dict[str, float]:
    """B-Human angles dict -> canonical snake-case joint dict."""
    return {canonical: angles[bh_key] for canonical, bh_key in NAO_ANGLE_MAP.items()}


def euler_sxyz_to_quat(ax: float, ay: float, az: float) -> tuple[float, float, float, float]:
    """Static-frame xyz Euler angles -> quaternion (w, x, y, z).

    Matches transforms3d's ``euler2quat(..., "sxyz")`` used by the reference
    for InertialSensorData (b_human.py:310-316).
    """
    ci, si = math.cos(ax / 2), math.sin(ax / 2)
    cj, sj = math.cos(ay / 2), math.sin(ay / 2)
    ck, sk = math.cos(az / 2), math.sin(az / 2)
    # sxyz composition: q = qz * qy * qx applied in static frame
    w = ci * cj * ck + si * sj * sk
    x = si * cj * ck - ci * sj * sk
    y = ci * sj * ck + si * cj * sk
    z = ci * cj * sk - si * sj * ck
    return w, x, y, z


def compute_jpeg_time_offset(frame_times_ms: list[int], image_times_ms: list[int]) -> float:
    """Mean difference between the JPEG timestamp clock and the frame clock.

    The reference observes the JPEG clock offset (~25 days) and removes it by
    mean-difference (b_human.py:542-622, ``JPEG_IMAGE_DATE_OFFSET``).
    """
    if not frame_times_ms or not image_times_ms:
        return 0.0
    n = min(len(frame_times_ms), len(image_times_ms))
    return float(np.mean(np.asarray(image_times_ms[:n], dtype=np.float64)
                         - np.asarray(frame_times_ms[:n], dtype=np.float64)))


def infer_missing_times(times_ms: list[int | None]) -> list[int]:
    """Fill None frame times by linear interpolation / extrapolation and sort
    monotonically (the reference infers missing frame times and sorts;
    b_human.py:597-611)."""
    arr = np.asarray([t if t is not None else np.nan for t in times_ms], dtype=np.float64)
    idx = np.arange(len(arr))
    known = ~np.isnan(arr)
    if known.sum() == 0:
        return list(range(len(arr)))
    arr = np.interp(idx, idx[known], arr[known])
    return np.maximum.accumulate(arr).astype(np.int64).tolist()


def datetime_from_path(path: str | Path) -> datetime | None:
    m = _PATH_DATETIME_RE.search(str(path))
    if not m:
        return None
    y, mo, d, h, mi = map(int, m.groups())
    return datetime(y, mo, d, h, mi)


@dataclass
class BHumanFrame:
    """One cognition/motion frame's worth of representations."""

    time_ms: int | None = None
    game_state: dict | None = None
    inertial_angles: dict | None = None  # {"x": rad, "y": rad, "z": rad}
    joint_request_angles: dict | None = None  # B-Human angle keys
    joint_sensor_angles: dict | None = None
    upper_image: np.ndarray | None = None  # BGR uint8
    lower_image: np.ndarray | None = None


class BHumanImportStrategy(ImportStrategy):
    def __init__(
        self,
        metadata: ImportMetadata,
        image_converter: BHumanImageConverter,
        game_state_converter: BHumanGameStateConverter,
        synced_data_converter: SyncedDataConverter,
        caching: bool = False,
        video: bool = False,
    ):
        self.metadata = metadata
        self.image_converter = image_converter
        self.game_state_converter = game_state_converter
        self.synced_data_converter = synced_data_converter
        self.caching = caching
        self.video = video
        self.model_data = ModelData()

    def convert_to_model_data(self, file_path: Path) -> ModelData:
        frames = read_bhuman_log(Path(file_path), caching=self.caching)
        if self.video:
            show_video(frames)
        return self.convert_frames(
            frames,
            original_file=Path(file_path).name,
            start_time=datetime_from_path(file_path),
        )

    def convert_frames(
        self,
        frames: Iterable[BHumanFrame],
        original_file: str = "<stream>",
        start_time: datetime | None = None,
    ) -> ModelData:
        frames = list(frames)
        times = infer_missing_times([f.time_ms for f in frames])

        self.model_data.recording = RecordingRow(
            allow_public=self.metadata.allow_public,
            original_file=original_file,
            team_name=self.metadata.team_name,
            robot_type=self.metadata.robot_type,
            start_time=start_time,
            location=self.metadata.location,
            simulated=self.metadata.simulated,
            img_width_scaling=0.0,
            img_height_scaling=0.0,
        )

        first_time: int | None = None
        latest = InputData()
        for frame, t_ms in zip(frames, times):
            converters: list[Converter] = []
            if frame.game_state is not None:
                latest.game_state = frame.game_state
                converters.append(self.game_state_converter)
            if frame.inertial_angles is not None:
                w, x, y, z = euler_sxyz_to_quat(
                    frame.inertial_angles["x"], frame.inertial_angles["y"],
                    frame.inertial_angles.get("z", 0.0),
                )
                latest.rotation = Quaternion(x=x, y=y, z=z, w=w)
                converters.append(self.synced_data_converter)
            if frame.joint_request_angles is not None:
                mapped = map_nao_angles(frame.joint_request_angles)
                latest.set_joint_command_msg(
                    SimpleNamespace(
                        joint_names=list(mapped), positions=list(mapped.values())
                    )
                )
                converters.append(self.synced_data_converter)
            if frame.joint_sensor_angles is not None:
                mapped = map_nao_angles(frame.joint_sensor_angles)
                latest.joint_state = mapped
                converters.append(self.synced_data_converter)
            if frame.upper_image is not None or frame.lower_image is not None:
                if frame.upper_image is not None:
                    latest.image = frame.upper_image
                if frame.lower_image is not None:
                    latest.lower_image = frame.lower_image
                converters.append(self.image_converter)

            if not self._is_all_synced_data_available(latest):
                continue
            if first_time is None:
                first_time = t_ms
                if latest.game_state is not None:
                    self._create_models(self.game_state_converter, latest, 0.0)
                self._create_models(self.synced_data_converter, latest, 0.0)
                continue
            rel_ts = (t_ms - first_time) / 1e3
            for converter in dict.fromkeys(converters):
                self._create_models(converter, latest, rel_ts)
        return self.model_data

    def _create_models(self, converter: Converter, data: InputData, rel_ts: float) -> None:
        assert self.model_data.recording is not None
        converter.populate_recording_metadata(data, self.model_data.recording)
        self.model_data.merge(
            converter.convert_to_model(data, rel_ts, self.model_data.recording)
        )

    @staticmethod
    def _is_all_synced_data_available(data: InputData) -> bool:
        commands_ready = all(c is not None for c in data.joint_command.values())
        return commands_ready and data.joint_state is not None and data.rotation is not None


def frame_statistics(frames: list[BHumanFrame]) -> str:
    """Per-representation frame counts and rates (the reference prints a rich
    statistics table; reference b_human.py:640-682)."""
    counts = {
        "GameState": sum(f.game_state is not None for f in frames),
        "InertialSensorData": sum(f.inertial_angles is not None for f in frames),
        "JointRequest": sum(f.joint_request_angles is not None for f in frames),
        "JointSensorData": sum(f.joint_sensor_angles is not None for f in frames),
        "Image(upper)": sum(f.upper_image is not None for f in frames),
        "Image(lower)": sum(f.lower_image is not None for f in frames),
    }
    times = [f.time_ms for f in frames if f.time_ms is not None]
    duration_s = (max(times) - min(times)) / 1e3 if len(times) > 1 else 0.0
    header = f"{'representation':<20} {'frames':>8} {'rate [Hz]':>10}"
    lines = [header, "-" * len(header)]
    for name, count in counts.items():
        rate = count / duration_s if duration_s > 0 else 0.0
        lines.append(f"{name:<20} {count:>8} {rate:>10.1f}")
    lines.append(f"total frames: {len(frames)}, duration: {duration_s:.1f}s")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# pybh log adapter
#
# The reference wraps every pybh Frame/Record in dict adapters and keeps the
# native handles alive for the whole conversion (reference b_human.py:67-149).
# Here pybh objects are converted eagerly into plain ``BHumanFrame``
# dataclasses instead: the native log handle can be dropped frame-by-frame,
# the result pickles cleanly for ``--caching`` (pybh handles do not), and the
# whole transformation is duck-typed so unit tests drive it with fake
# Frame/Record/Log objects without the native bindings installed.
# --------------------------------------------------------------------------

#: representations consumed from a B-Human log (reference b_human.py:34-44).
PYBH_REPRESENTATIONS = (
    "FrameInfo",
    "GameState",
    "InertialSensorData",
    "JointRequest",
    "JointSensorData",
    "JPEGImage",
)


def pybh_value_to_py(value: Any) -> Any:
    """pybh ``Record``/``Array``/scalar -> plain dict/list/scalar.

    Dispatches on the class *name* so test fakes can stand in for the native
    pybh types (reference SmartRecord does the same walk; b_human.py:68-106).
    """
    name = type(value).__name__
    if name == "Record":
        return {key: pybh_value_to_py(getattr(value, key)) for key in value}
    if name == "Array":
        return [pybh_value_to_py(v) for v in value]
    return value


def decode_bhuman_jpeg(data: bytes, width: int, height: int) -> np.ndarray:
    """YUYV-packed JPEG bytes -> BGR uint8 image of shape (2*height, 2*width, 3).

    B-Human stores camera frames as JPEG-compressed YUYV: the decoded JPEG is
    (2*height, width, 4) where each 4-tuple packs Y0 U Y1 V for two horizontal
    pixels (reference b_human.py:198-249). The final BGR image is inverted
    (255 - x) exactly as the reference does.
    """
    import io as _io

    from PIL import Image as PILImage

    img_yuyv = np.asarray(PILImage.open(_io.BytesIO(data)))
    y0 = img_yuyv[:, :, 0]
    u = img_yuyv[:, :, 1]
    y1 = img_yuyv[:, :, 2]
    v = img_yuyv[:, :, 3]
    img_yuv = np.empty((height * 2, width * 2, 3), dtype=np.uint8)
    img_yuv[:, ::2, 0] = y0
    img_yuv[:, 1::2, 0] = y1
    img_yuv[:, ::2, 1] = u
    img_yuv[:, 1::2, 1] = u
    img_yuv[:, ::2, 2] = v
    img_yuv[:, 1::2, 2] = v
    return 255 - yuv_to_bgr(img_yuv)


def yuv_to_bgr(yuv: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) YUV -> BGR with OpenCV's 14-bit fixed-point
    coefficients (B = Y + 2.032 U', G = Y - 0.395 U' - 0.581 V', R = Y +
    1.140 V', U' = U - 128, V' = V - 128), rounded and saturated."""
    y, u, v = (yuv[..., i].astype(np.int32) for i in range(3))
    u, v = u - 128, v - 128
    descale = lambda x: (x + (1 << 13)) >> 14
    bgr = np.stack([y + descale(u * 33292), y + descale(u * -6472 + v * -9519),
                    y + descale(v * 18678)], axis=-1)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def _scrape_times(reps: dict[str, dict]) -> tuple[list[int], int | None]:
    """(non-JPEG time/timestamp values, JPEG timestamp) from one frame's
    representation dicts (reference b_human.py:184-197)."""
    times: list[int] = []
    jpeg_ts: int | None = None
    for name, record in reps.items():
        if name == "JPEGImage":
            ts = record.get("timestamp")
            if isinstance(ts, int):
                jpeg_ts = ts
            continue
        for key in ("time", "timestamp"):
            t = record.get(key)
            if isinstance(t, int):
                times.append(t)
    return times, jpeg_ts


def frames_from_pybh(log: Iterable[Any]) -> list[BHumanFrame]:
    """Convert an iterable of pybh ``Frame`` objects into repaired, sorted
    ``BHumanFrame`` dataclasses.

    Performs the reference's two-clock-domain repair (b_human.py:542-622):
    JPEG timestamps live ~25 days ahead of the frame clock, so their offset is
    estimated as mean(JPEG times) - mean(other times) and removed; then all
    times are zero-shifted to the global minimum, frames with no time at all
    inherit the running maximum, and the result is sorted by time.
    """
    entries: list[tuple[BHumanFrame, list[int], int | None]] = []
    upper_resolution: tuple[int, int] | None = None

    for frame in log:
        reps = {
            name: pybh_value_to_py(frame[name])
            for name in frame.representations
            if name in PYBH_REPRESENTATIONS
        }
        if not reps:
            continue
        out = BHumanFrame()
        gs = reps.get("GameState")
        if gs is not None:
            out.game_state = gs
        inertial = reps.get("InertialSensorData")
        if inertial is not None and "angle" in inertial:
            out.inertial_angles = inertial["angle"]
        request = reps.get("JointRequest")
        if request is not None and "angles" in request:
            out.joint_request_angles = request["angles"]
        sensor = reps.get("JointSensorData")
        if sensor is not None and "angles" in sensor:
            out.joint_sensor_angles = sensor["angles"]
        jpeg = reps.get("JPEGImage")
        if jpeg is not None and jpeg.get("_data") is not None:
            size, w, h = jpeg["size"], jpeg["width"], jpeg["height"]
            img = decode_bhuman_jpeg(bytes(jpeg["_data"])[-size:], w, h)
            if getattr(frame, "thread", "Upper") == "Lower":
                if upper_resolution is not None and img.shape[:2] != upper_resolution:
                    img = resize_linear(img, *upper_resolution)
                out.lower_image = img
            else:
                upper_resolution = img.shape[:2]
                out.upper_image = img
        entries.append((out, *_scrape_times(reps)))

    if not entries:
        return []

    # Clock repair: remove the JPEG date offset, zero-shift, fill, sort.
    other_times = [t for _, times, _ in entries for t in times]
    jpeg_times = [ts for _, _, ts in entries if ts is not None]
    jpeg_offset = 0
    if other_times and jpeg_times:
        jpeg_offset = int(np.mean(jpeg_times) - np.mean(other_times))

    raw: list[int | None] = []
    for _, times, jpeg_ts in entries:
        if times:
            raw.append(min(times))
        elif jpeg_ts is not None:
            raw.append(jpeg_ts - jpeg_offset)
        else:
            raw.append(None)
    known = [t for t in raw if t is not None]
    global_offset = min(known) if known else 0

    running_max = 0
    frames: list[BHumanFrame] = []
    for (frame_out, _, _), t in zip(entries, raw):
        if t is None:
            t_ms = running_max
        else:
            t_ms = t - global_offset
            running_max = max(running_max, t_ms)
        frame_out.time_ms = t_ms
        frames.append(frame_out)
    frames.sort(key=lambda f: f.time_ms)
    return frames


def read_bhuman_log(path: Path, caching: bool = False) -> list[BHumanFrame]:
    """Read a proprietary ``.log`` via the optional pybh bindings.

    With ``caching=True`` the extracted frame list is pickled to
    ``/tmp/<name>.pkl`` and reused on the next run (reference
    b_human.py:487-522 caches at the same granularity).
    """
    cache_file = Path("/tmp") / Path(path.name).with_suffix(".pkl").name
    if caching and cache_file.exists():
        import pickle

        logger.info(f"reading cached B-Human frames from {cache_file}")
        with open(cache_file, "rb") as fh:
            return pickle.load(fh)

    try:
        from pybh.logs import Log
    except ImportError as exc:  # pragma: no cover - optional native dependency
        raise ImportError(
            "B-Human log import requires the 'pybh' bindings built from "
            "BHumanCodeRelease (see the reference README for build steps)"
        ) from exc

    log = Log(str(path), keep_going=True)
    frames = frames_from_pybh(log)
    logger.info(f"read {len(frames)} frames from {path}")
    logger.info("\n" + frame_statistics(frames))

    if caching:
        import pickle

        with open(cache_file, "wb") as fh:
            pickle.dump(frames, fh)
        logger.info(f"cached B-Human frames to {cache_file}")
    return frames


def show_video(frames: Iterable[BHumanFrame], delay_ms: int = 1) -> bool:
    """Play the camera stream with cv2 (reference ``--video``,
    b_human.py:684-687). Returns False when no GUI is available."""
    import cv2

    try:
        for frame in frames:
            img = frame.upper_image if frame.upper_image is not None else frame.lower_image
            if img is None:
                continue
            cv2.imshow("b-human import", img)
            cv2.waitKey(delay_ms)
        cv2.destroyAllWindows()
    except cv2.error as exc:  # headless build / no display
        logger.warning(f"--video requested but cv2 cannot display: {exc}")
        return False
    return True
