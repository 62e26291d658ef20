"""Plain-dataclass DB rows and import DTOs (no ORM; counterpart of
``soccerdiffusion_tpu/ingest/rows.py``).

Counterparts of reference dataset/imports/data.py: ``InputData`` holds the
latest message per topic with ONE field per joint command — commands arrive
per-joint and must resample independently (reference data.py:35-58) —
``ModelData`` accumulates converted rows. The reference's
``model_instances()`` accidentally omits rotations from the returned list
(reference data.py:114-115, flagged in SURVEY.md §2); here rotations are
included — a deliberate fix.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

import numpy as np

CAMELCASE_TO_SNAKECASE_REGEX = re.compile(r"(?<!^)(?=[A-Z])")

#: snake_case joint keys used by import DTOs, in reference column-definition
#: order (reference models.py:168-190).
SNAKE_JOINT_NAMES = (
    "r_shoulder_pitch", "l_shoulder_pitch", "r_shoulder_roll", "l_shoulder_roll",
    "r_elbow", "r_elbow_yaw", "l_elbow", "l_elbow_yaw",
    "r_hip_yaw", "l_hip_yaw", "r_hip_roll", "l_hip_roll",
    "r_hip_pitch", "l_hip_pitch", "r_knee", "l_knee",
    "r_ankle_pitch", "l_ankle_pitch", "r_ankle_roll", "l_ankle_roll",
    "head_pan", "head_tilt",
)


def snake_to_column(name: str) -> str:
    """head_pan -> HeadPan (DB column naming, reference models.py:168-190)."""
    return "".join(part.capitalize() for part in name.split("_"))


def camelcase_to_snakecase(name: str) -> str:
    return CAMELCASE_TO_SNAKECASE_REGEX.sub("_", name).lower()


def joints_dict_from_msg_data(joints_data: list[tuple[str, float]]) -> dict[str, float]:
    """[("HeadPan", x), ...] -> {"head_pan": x, ...} (reference data.py:9-16)."""
    return {camelcase_to_snakecase(name): position for name, position in joints_data}


@dataclass
class ImportMetadata:
    allow_public: bool
    team_name: str
    robot_type: str
    location: str
    simulated: bool


@dataclass
class RecordingRow:
    original_file: str
    team_name: str
    robot_type: str
    allow_public: bool = False
    team_color: str | None = None
    start_time: datetime | None = None
    end_time: datetime | None = None
    location: str | None = None
    simulated: bool = False
    img_width: int = 480
    img_height: int = 480
    img_width_scaling: float = 0.0
    img_height_scaling: float = 0.0


@dataclass
class ImageRow:
    stamp: float
    image: np.ndarray  # uint8 (H, W, 3) RGB

    def __post_init__(self):
        assert self.image.dtype == np.uint8, "image must be uint8"
        assert self.image.ndim == 3 and self.image.shape[2] == 3, "image must be HWC3"


@dataclass
class RotationRow:
    stamp: float
    x: float
    y: float
    z: float
    w: float


@dataclass
class JointsRow:
    """One row of JointStates or JointCommands, keyed snake_case."""

    stamp: float
    joints: dict[str, float] = field(default_factory=dict)


@dataclass
class GameStateRow:
    stamp: float
    state: str  # RobotState value string


@dataclass
class Quaternion:
    x: float
    y: float
    z: float
    w: float


def _joint_command_defaults() -> dict[str, Any]:
    # NAO elbow-yaw joints default to 0.0 (the Wolfgang-OP has no such
    # joint); all others must be observed before syncing starts
    # (reference data.py:41-43).
    return {
        name: (0.0 if name.endswith("elbow_yaw") else None) for name in SNAKE_JOINT_NAMES
    }


@dataclass
class InputData:
    """Latest message per topic (reference data.py:29-102)."""

    image: Any = None
    lower_image: Any = None
    game_state: Any = None
    rotation: Any = None
    joint_state: dict[str, float] | None = None
    joint_command_values: dict[str, Any] = field(default_factory=_joint_command_defaults)

    @property
    def joint_command(self) -> dict[str, Any]:
        return dict(self.joint_command_values)

    def set_joint_state_msg(self, msg) -> None:
        """msg has .name and .position lists (sensor_msgs/JointState)."""
        self.joint_state = joints_dict_from_msg_data(list(zip(msg.name, msg.position)))

    def set_joint_command_msg(self, msg) -> None:
        """msg has .joint_names and .positions (bitbots_msgs/JointCommand);
        updates only the named joints (per-joint resampling)."""
        for joint, cmd in joints_dict_from_msg_data(
            list(zip(msg.joint_names, msg.positions))
        ).items():
            if joint in self.joint_command_values:
                self.joint_command_values[joint] = cmd


@dataclass
class ModelData:
    recording: RecordingRow | None = None
    game_states: list[GameStateRow] = field(default_factory=list)
    joint_states: list[JointsRow] = field(default_factory=list)
    joint_commands: list[JointsRow] = field(default_factory=list)
    images: list[ImageRow] = field(default_factory=list)
    rotations: list[RotationRow] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (
            self.game_states or self.joint_states or self.joint_commands
            or self.images or self.rotations
        )

    def merge(self, other: "ModelData") -> "ModelData":
        self.game_states.extend(other.game_states)
        self.joint_states.extend(other.joint_states)
        self.joint_commands.extend(other.joint_commands)
        self.images.extend(other.images)
        self.rotations.extend(other.rotations)
        return self
