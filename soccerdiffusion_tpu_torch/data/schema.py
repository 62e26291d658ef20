"""The game-state enumeration of the storage schema (counterpart of
``RobotState`` in ``soccerdiffusion_tpu/data/schema.py``; the SQLite schema
itself is not ported yet)."""

from __future__ import annotations

from enum import Enum


class RobotState(str, Enum):
    """4-value game situation."""

    PLAYING = "PLAYING"
    POSITIONING = "POSITIONING"
    STOPPED = "STOPPED"
    UNKNOWN = "UNKNOWN"

    @classmethod
    def values(cls) -> list[str]:
        return sorted(e.value for e in cls)

    def __int__(self) -> int:
        # index into the alphabetically sorted values: the integer fed to
        # the game-state embedding
        return self.values().index(self.value)
