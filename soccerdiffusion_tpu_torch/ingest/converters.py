"""Converters: resampled InputData -> DB rows (counterpart of
``soccerdiffusion_tpu/ingest/converters.py``).

Counterparts of reference dataset/converters/: synced modalities with the
[0, 2*pi) angle shift (synced_data_converter.py:43-59), image resize/format
normalization (image_converter.py:28-125), and the team-specific game-state
mappings onto the 4-value RobotState space
(game_state_converter/bit_bots_game_state_converter.py:43-59,
b_human_game_state_converter.py:12-167).

Frames are resized by the port's numpy INTER_AREA / INTER_CUBIC
(``data/resize.py``, OpenCV's arithmetic) and their channels reordered by
slicing, where the JAX package calls ``cv2.resize`` and ``cv2.cvtColor``.
"""

from __future__ import annotations

import logging
import math
from abc import ABC, abstractmethod
from enum import Enum, auto

import numpy as np

from soccerdiffusion_tpu_torch.data.resize import resize_area, resize_cubic
from soccerdiffusion_tpu_torch.data.schema import RobotState, TeamColor
from soccerdiffusion_tpu_torch.ingest.resampling import MaxRateResampler, OriginalRateResampler, Resampler
from soccerdiffusion_tpu_torch.ingest.rows import (
    GameStateRow,
    ImageRow,
    InputData,
    JointsRow,
    ModelData,
    RecordingRow,
    RotationRow,
)

logger = logging.getLogger("soccerdiffusion_tpu_torch")

DEFAULT_IMG_SIZE = (480, 480)


def shift_radian_to_positive_range(radian: float) -> float:
    """[-pi, pi] -> [0, 2*pi) (reference utils/utils.py:47-54)."""
    return (radian + 3 * math.pi) % (2 * math.pi)


class Converter(ABC):
    @abstractmethod
    def populate_recording_metadata(self, data: InputData, recording: RecordingRow) -> None: ...

    @abstractmethod
    def convert_to_model(
        self, data: InputData, relative_timestamp: float, recording: RecordingRow
    ) -> ModelData: ...


class SyncedDataConverter(Converter):
    """Emits one Rotation + JointStates + JointCommands row per resampled tick."""

    def __init__(self, resampler: Resampler) -> None:
        self.resampler = resampler

    def populate_recording_metadata(self, data: InputData, recording: RecordingRow) -> None:
        pass

    def convert_to_model(
        self, data: InputData, relative_timestamp: float, recording: RecordingRow
    ) -> ModelData:
        assert data.joint_state is not None, "joint_states are required in synced resampling data"
        assert all(
            command is not None for command in data.joint_command.values()
        ), "joint_commands are required in synced resampling data"
        assert data.rotation is not None, "IMU rotation is required in synced resampling data"

        models = ModelData()
        for sample in self.resampler.resample(data, relative_timestamp):
            rot = sample.data.rotation
            models.rotations.append(
                RotationRow(stamp=sample.timestamp, x=rot.x, y=rot.y, z=rot.z, w=rot.w)
            )
            models.joint_states.append(
                JointsRow(
                    stamp=sample.timestamp,
                    joints={
                        j: shift_radian_to_positive_range(p)
                        for j, p in sample.data.joint_state.items()
                    },
                )
            )
            models.joint_commands.append(
                JointsRow(
                    stamp=sample.timestamp,
                    joints={
                        j: shift_radian_to_positive_range(c)
                        for j, c in sample.data.joint_command.items()
                    },
                )
            )
        return models


class ImageConverter(Converter, ABC):
    def __init__(self, resampler: MaxRateResampler) -> None:
        self.resampler = resampler

    def convert_to_model(
        self, data: InputData, relative_timestamp: float, recording: RecordingRow
    ) -> ModelData:
        models = ModelData()
        for sample in self.resampler.resample(data, relative_timestamp):
            models.images.append(self._create_image(sample.data, sample.timestamp, recording))
        return models

    @staticmethod
    def _resize(img: np.ndarray, recording: RecordingRow) -> np.ndarray:
        upscaled = recording.img_width_scaling > 1.0 or recording.img_height_scaling > 1.0
        resize = resize_cubic if upscaled else resize_area
        return resize(img, recording.img_height, recording.img_width)

    @staticmethod
    def _record_scaling(recording: RecordingRow, width: int, height: int) -> None:
        scaling = (DEFAULT_IMG_SIZE[0] / width, DEFAULT_IMG_SIZE[1] / height)
        if recording.img_width_scaling == 0.0:
            recording.img_width_scaling = scaling[0]
        if recording.img_height_scaling == 0.0:
            recording.img_height_scaling = scaling[1]
        if (recording.img_width_scaling, recording.img_height_scaling) != scaling:
            logger.error(
                "image size changed mid-recording; all images of a recording must share one size"
            )

    @abstractmethod
    def _create_image(self, data: InputData, sampling_timestamp: float,
                      recording: RecordingRow) -> ImageRow: ...


class BitbotsImageConverter(ImageConverter):
    """ROS sensor_msgs/Image (rgb8 | bgr8 | bgra8) -> 480x480 RGB rows."""

    def populate_recording_metadata(self, data: InputData, recording: RecordingRow) -> None:
        self._record_scaling(recording, data.image.width, data.image.height)

    def _create_image(self, data: InputData, sampling_timestamp: float,
                      recording: RecordingRow) -> ImageRow:
        image = data.image
        img = np.frombuffer(image.data, np.uint8).reshape((image.height, image.width, -1))
        resized = self._resize(img, recording)
        match image.encoding:
            case "rgb8":
                rgb = resized
            case "bgr8" | "bgra8":
                rgb = np.ascontiguousarray(resized[:, :, 2::-1])
            case _:
                raise AssertionError(f"unsupported image encoding: {image.encoding}")
        return ImageRow(stamp=sampling_timestamp, image=rgb)


class BHumanImageConverter(ImageConverter):
    """BGR ndarray frames (upper preferred over lower camera) -> RGB rows."""

    def populate_recording_metadata(self, data: InputData, recording: RecordingRow) -> None:
        upper, lower = data.image, data.lower_image
        if upper is not None and lower is not None:
            assert upper.shape == lower.shape, "upper and lower image must share a shape"
        image = upper if upper is not None else lower
        self._record_scaling(recording, image.shape[1], image.shape[0])

    def _create_image(self, data: InputData, sampling_timestamp: float,
                      recording: RecordingRow) -> ImageRow:
        image = data.image if data.image is not None else data.lower_image
        assert image is not None, "image must be available"
        rgb = np.ascontiguousarray(self._resize(image, recording)[:, :, ::-1])
        return ImageRow(stamp=sampling_timestamp, image=rgb)


# --------------------------------------------------------------------------
# Game state converters
# --------------------------------------------------------------------------


class GameStateMessage(int, Enum):
    """RoboCup humanoid league game controller states (bit-bots msg)."""

    INITIAL = 0
    READY = 1
    SET = 2
    PLAYING = 3
    FINISHED = 4


class BitBotsGameStateConverter(Converter):
    def __init__(self, resampler: OriginalRateResampler) -> None:
        self.resampler = resampler

    def populate_recording_metadata(self, data: InputData, recording: RecordingRow) -> None:
        team_color = (TeamColor.BLUE if data.game_state.team_color == 0 else TeamColor.RED).value
        if recording.team_color is None:
            recording.team_color = team_color
        elif recording.team_color != team_color:
            logger.warning("team color changed during one recording; ignored")

    def convert_to_model(
        self, data: InputData, relative_timestamp: float, recording: RecordingRow
    ) -> ModelData:
        models = ModelData()
        for sample in self.resampler.resample(data, relative_timestamp):
            models.game_states.append(
                GameStateRow(
                    stamp=sample.timestamp,
                    state=self._robot_state_from_msg(sample.data.game_state).value,
                )
            )
        return models

    @staticmethod
    def _robot_state_from_msg(msg) -> RobotState:
        """Penalized -> STOPPED; else by game state (reference
        bit_bots_game_state_converter.py:43-59)."""
        if msg.penalized:
            return RobotState.STOPPED
        match msg.game_state:
            case GameStateMessage.INITIAL | GameStateMessage.SET | GameStateMessage.FINISHED:
                return RobotState.STOPPED
            case GameStateMessage.READY:
                return RobotState.POSITIONING
            case GameStateMessage.PLAYING:
                return RobotState.PLAYING
            case _:
                return RobotState.UNKNOWN


class BHumanState(Enum):
    """Mirror of B-Human's GameState::State enum (their C++ GameState.h, as
    mapped by reference b_human_game_state_converter.py:12-95)."""

    beforeHalf = 0
    standby = auto()
    afterHalf = auto()
    timeout = auto()
    playing = auto()
    setupOwnKickOff = auto()
    setupOpponentKickOff = auto()
    waitForOwnKickOff = auto()
    waitForOpponentKickOff = auto()
    ownKickOff = auto()
    opponentKickOff = auto()
    setupOwnPenaltyKick = auto()
    setupOpponentPenaltyKick = auto()
    waitForOwnPenaltyKick = auto()
    waitForOpponentPenaltyKick = auto()
    ownPenaltyKick = auto()
    opponentPenaltyKick = auto()
    ownPushingFreeKick = auto()
    opponentPushingFreeKick = auto()
    ownKickIn = auto()
    opponentKickIn = auto()
    ownGoalKick = auto()
    opponentGoalKick = auto()
    ownCornerKick = auto()
    opponentCornerKick = auto()
    beforePenaltyShootout = auto()
    waitForOwnPenaltyShot = auto()
    waitForOpponentPenaltyShot = auto()
    ownPenaltyShot = auto()
    opponentPenaltyShot = auto()
    afterOwnPenaltyShot = auto()
    afterOpponentPenaltyShot = auto()

    @classmethod
    def is_playing(cls, state: int) -> bool:
        return state in {
            s.value
            for s in (
                cls.playing, cls.ownKickOff, cls.opponentKickOff,
                cls.ownPenaltyKick, cls.opponentPenaltyKick,
                cls.ownPushingFreeKick, cls.opponentPushingFreeKick,
                cls.ownKickIn, cls.opponentKickIn,
                cls.ownGoalKick, cls.opponentGoalKick,
                cls.ownCornerKick, cls.opponentCornerKick,
                cls.ownPenaltyShot, cls.opponentPenaltyShot,
            )
        }

    @classmethod
    def is_stopped(cls, state: int) -> bool:
        return state in {
            s.value
            for s in (
                cls.beforeHalf, cls.standby, cls.afterHalf, cls.timeout,
                cls.setupOwnKickOff, cls.setupOpponentKickOff,
                cls.waitForOwnKickOff, cls.waitForOpponentKickOff,
                cls.ownKickOff, cls.opponentKickOff,
            )
        }

    @classmethod
    def is_positioning(cls, state: int) -> bool:
        return state in {
            s.value
            for s in (
                cls.setupOwnKickOff, cls.setupOpponentKickOff,
                cls.setupOwnPenaltyKick, cls.setupOpponentPenaltyKick,
            )
        }


class BHumanPlayerState(Enum):
    """Mirror of B-Human's GameState::PlayerState enum
    (reference b_human_game_state_converter.py:98-126)."""

    unstiff = 0
    calibration = auto()
    penalizedManual = auto()
    penalizedIllegalBallContact = auto()
    penalizedPlayerPushing = auto()
    penalizedIllegalMotionInSet = auto()
    penalizedInactivePlayer = auto()
    penalizedIllegalPosition = auto()
    penalizedLeavingTheField = auto()
    penalizedRequestForPickup = auto()
    penalizedLocalGameStuck = auto()
    penalizedIllegalPositionInSet = auto()
    penalizedPlayerStance = auto()
    penalizedIllegalMotionInStandby = auto()
    substitute = auto()
    active = auto()

    @classmethod
    def is_penalized(cls, state: int) -> bool:
        return cls.penalizedManual.value <= state <= cls.substitute.value


class BHumanGameStateConverter(Converter):
    def __init__(self, resampler: OriginalRateResampler) -> None:
        self.resampler = resampler

    def populate_recording_metadata(self, data: InputData, recording: RecordingRow) -> None:
        # B-Human's int TeamColor enum shares our ordering; index into it
        # (reference b_human_game_state_converter.py:132-144).
        team_color = list(TeamColor)[data.game_state["ownTeam"]["fieldPlayerColor"]].value
        if recording.team_color is None:
            recording.team_color = team_color
        elif recording.team_color != team_color:
            logger.warning("team color changed during one recording; ignored")

    def convert_to_model(
        self, data: InputData, relative_timestamp: float, recording: RecordingRow
    ) -> ModelData:
        models = ModelData()
        for sample in self.resampler.resample(data, relative_timestamp):
            models.game_states.append(
                GameStateRow(
                    stamp=sample.timestamp,
                    state=self._get_state(sample.data.game_state).value,
                )
            )
        return models

    @staticmethod
    def _get_state(data) -> RobotState:
        """Priority: positioning > penalized/stopped > playing > unknown
        (reference b_human_game_state_converter.py:157-167)."""
        if BHumanState.is_positioning(data["state"]):
            return RobotState.POSITIONING
        if BHumanPlayerState.is_penalized(data["playerState"]) or BHumanState.is_stopped(data["state"]):
            return RobotState.STOPPED
        if BHumanState.is_playing(data["state"]):
            return RobotState.PLAYING
        return RobotState.UNKNOWN
