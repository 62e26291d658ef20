"""The SQLite storage schema (counterpart of
``soccerdiffusion_tpu/data/schema.py``): the reference's six tables (raw
RGB8 frame blobs, per-joint CHECK constraints in [0, 2 pi), a (recording_id,
stamp) index on every time series) in the same SQL, so a database written by
either package is read by the other; the connection pragmas and the
read-only URI rule of the JAX package."""

from __future__ import annotations

import math
import sqlite3
from enum import Enum
from pathlib import Path

from soccerdiffusion_tpu_torch.config import CANONICAL_JOINT_NAMES_22


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


class TeamColor(str, Enum):
    BLUE = "BLUE"
    RED = "RED"
    YELLOW = "YELLOW"
    BLACK = "BLACK"
    WHITE = "WHITE"
    GREEN = "GREEN"
    ORANGE = "ORANGE"
    PURPLE = "PURPLE"
    BROWN = "BROWN"
    GRAY = "GRAY"

    @classmethod
    def values(cls) -> list[str]:
        return [e.value for e in cls]


TWO_PI = 2 * math.pi

_JOINT_COLS = ",\n".join(f'    "{name}" FLOAT DEFAULT 0.0' for name in CANONICAL_JOINT_NAMES_22)

_JOINT_CHECKS = ",\n".join(
    f'    CHECK ("{name}" >= 0 AND "{name}" < {TWO_PI!r})' for name in CANONICAL_JOINT_NAMES_22)

_SCHEMA_SQL = f"""
CREATE TABLE IF NOT EXISTS Recording (
    _id INTEGER PRIMARY KEY AUTOINCREMENT,
    allow_public BOOLEAN DEFAULT 0,
    original_file VARCHAR NOT NULL,
    team_name VARCHAR NOT NULL,
    team_color VARCHAR,
    robot_type VARCHAR NOT NULL,
    start_time DATETIME,
    end_time DATETIME,
    location VARCHAR,
    simulated BOOLEAN DEFAULT 0,
    img_width INTEGER DEFAULT 480,
    img_height INTEGER DEFAULT 480,
    img_width_scaling FLOAT NOT NULL,
    img_height_scaling FLOAT NOT NULL,
    CHECK (img_width > 0),
    CHECK (img_height > 0),
    CHECK (end_time >= start_time)
);

CREATE TABLE IF NOT EXISTS Image (
    _id INTEGER PRIMARY KEY AUTOINCREMENT,
    stamp FLOAT NOT NULL CHECK (stamp >= 0),
    recording_id INTEGER NOT NULL REFERENCES Recording (_id),
    data BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_Image_recording_stamp ON Image (recording_id, stamp ASC);

CREATE TABLE IF NOT EXISTS Rotation (
    _id INTEGER PRIMARY KEY AUTOINCREMENT,
    stamp FLOAT NOT NULL CHECK (stamp >= 0),
    recording_id INTEGER NOT NULL REFERENCES Recording (_id),
    x FLOAT NOT NULL CHECK (x >= -1 AND x <= 1),
    y FLOAT NOT NULL CHECK (y >= -1 AND y <= 1),
    z FLOAT NOT NULL CHECK (z >= -1 AND z <= 1),
    w FLOAT NOT NULL CHECK (w >= -1 AND w <= 1)
);
CREATE INDEX IF NOT EXISTS ix_Rotation_recording_stamp ON Rotation (recording_id, stamp ASC);

CREATE TABLE IF NOT EXISTS JointStates (
    _id INTEGER PRIMARY KEY AUTOINCREMENT,
    stamp FLOAT NOT NULL CHECK (stamp >= 0),
    recording_id INTEGER NOT NULL REFERENCES Recording (_id),
{_JOINT_COLS},
{_JOINT_CHECKS}
);
CREATE INDEX IF NOT EXISTS ix_JointStates_recording_stamp ON JointStates (recording_id, stamp ASC);

CREATE TABLE IF NOT EXISTS JointCommands (
    _id INTEGER PRIMARY KEY AUTOINCREMENT,
    stamp FLOAT NOT NULL CHECK (stamp >= 0),
    recording_id INTEGER NOT NULL REFERENCES Recording (_id),
{_JOINT_COLS},
{_JOINT_CHECKS}
);
CREATE INDEX IF NOT EXISTS ix_JointCommands_recording_stamp ON JointCommands (recording_id, stamp ASC);

CREATE TABLE IF NOT EXISTS GameState (
    _id INTEGER PRIMARY KEY AUTOINCREMENT,
    stamp FLOAT NOT NULL CHECK (stamp >= 0),
    recording_id INTEGER NOT NULL REFERENCES Recording (_id),
    state VARCHAR NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_GameState_recording_stamp ON GameState (recording_id, stamp ASC);
"""


def connect(db_path: str | Path, read_only: bool = False) -> sqlite3.Connection:
    """A connection with the reference's pragmas.

    Read-only: the ``immutable=1`` URI (no locking or WAL machinery), unless
    a non-empty ``-wal`` sidecar holds writes not yet checkpointed, which
    ``immutable`` would silently skip: then ``mode=ro``. A read-only
    connection may be used from another thread than the one that opened it
    (the prefetch thread fetches streamed frames through it; it only reads).
    Writers get WAL, synchronous NORMAL and in-memory temp storage."""
    db_path = str(db_path)
    if read_only:
        wal = Path(db_path + "-wal")
        mode = "mode=ro" if wal.exists() and wal.stat().st_size > 0 else "immutable=1"
        return sqlite3.connect(f"file:{db_path}?{mode}", uri=True, check_same_thread=False)
    conn = sqlite3.connect(db_path)
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.execute("PRAGMA temp_store=MEMORY")
    return conn


def create_schema(conn: sqlite3.Connection) -> None:
    """Create the latest-version schema and stamp it."""
    from soccerdiffusion_tpu_torch.data.migrations import LATEST_VERSION, stamp

    conn.executescript(_SCHEMA_SQL)
    stamp(conn, LATEST_VERSION)
    conn.commit()
