"""Import orchestration: strategy -> validated bulk insert into SQLite
(counterpart of ``soccerdiffusion_tpu/ingest/importer.py``, writing the
port's ``data/schema.py`` tables).

Counterpart of reference dataset/imports/model_importer.py:9-41 (strategy
ABC + validate-then-commit), with the ORM's add_all replaced by executemany
bulk inserts in one transaction — plus a bounded-memory streaming mode the
reference lacks (it materializes every row, images included, before one
commit; model_importer.py:27-41): strategies that implement
``stream_model_data`` hand rows over in ~``flush_rows`` deltas which are
inserted as they arrive, so peak RSS is O(flush interval), not O(bag).
"""

from __future__ import annotations

import logging
import sqlite3
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Iterator

from soccerdiffusion_tpu_torch.ingest.rows import ModelData, snake_to_column

logger = logging.getLogger("soccerdiffusion_tpu_torch")

REQUIRED_TABLES = ("game_states", "joint_states", "joint_commands", "images", "rotations")


class ImportStrategy(ABC):
    @abstractmethod
    def convert_to_model_data(self, file_path: Path) -> ModelData:
        """Read the recording file and produce rows."""

    def stream_model_data(self, file_path: Path,
                          flush_rows: int = 50_000) -> Iterator[ModelData]:
        """Yield ``ModelData`` deltas of ~``flush_rows`` rows each; every
        delta shares one ``recording`` object whose metadata may keep
        filling in until exhaustion. Default: one all-at-once delta (for
        strategies without a streaming reader, e.g. B-Human via pybh)."""
        yield self.convert_to_model_data(file_path)


class ModelImporter:
    def __init__(self, conn: sqlite3.Connection, strategy: ImportStrategy):
        self.conn = conn
        self.strategy = strategy

    def import_to_db(self, file_path: Path, flush_rows: int | None = None) -> int:
        """Convert and commit; returns the new recording id.

        Validates that every synced model list is non-empty before
        committing (reference model_importer.py:35-38). With ``flush_rows``
        the strategy's streaming protocol is used: deltas are inserted as
        they arrive inside ONE transaction that only commits after
        validation, so a bad bag leaves no partial rows behind.
        """
        logger.info(f"importing {file_path}")
        if flush_rows:
            return self._import_streaming(Path(file_path), flush_rows)
        model_data = self.strategy.convert_to_model_data(Path(file_path))

        assert model_data.recording is not None, "strategy produced no recording"
        for name in REQUIRED_TABLES:
            assert getattr(model_data, name), f"strategy produced no {name}"

        logger.info(
            "writing rows: %d joint_states, %d joint_commands, %d rotations,"
            " %d images, %d game_states"
            % (
                len(model_data.joint_states), len(model_data.joint_commands),
                len(model_data.rotations), len(model_data.images),
                len(model_data.game_states),
            )
        )
        return write_model_data(self.conn, model_data)

    def _import_streaming(self, file_path: Path, flush_rows: int) -> int:
        cur = self.conn.cursor()
        rec_id = None
        recording = None
        counts = dict.fromkeys(REQUIRED_TABLES, 0)
        try:
            for delta in self.strategy.stream_model_data(file_path, flush_rows):
                if rec_id is None:
                    assert delta.recording is not None, "strategy produced no recording"
                    recording = delta.recording
                    rec_id = insert_recording(cur, recording)
                write_delta_rows(cur, delta, rec_id)
                for name in counts:
                    counts[name] += len(getattr(delta, name))
            assert rec_id is not None, "strategy produced no data"
            for name, n in counts.items():
                assert n, f"strategy produced no {name}"
            # metadata (image scaling, end time) may have been populated
            # after the first flush — bring the row up to date
            update_recording(cur, recording, rec_id)
        except BaseException:
            self.conn.rollback()
            raise
        logger.info("wrote rows (streaming): " +
                    ", ".join(f"{n} {k}" for k, n in counts.items()))
        self.conn.commit()
        return rec_id


_RECORDING_COLS = (
    "allow_public", "original_file", "team_name", "team_color", "robot_type",
    "start_time", "end_time", "location", "simulated", "img_width",
    "img_height", "img_width_scaling", "img_height_scaling",
)


def _recording_values(rec) -> tuple:
    return (
        rec.allow_public, rec.original_file, rec.team_name, rec.team_color,
        rec.robot_type,
        rec.start_time.isoformat(sep=" ") if rec.start_time else None,
        rec.end_time.isoformat(sep=" ") if rec.end_time else None,
        rec.location, rec.simulated, rec.img_width, rec.img_height,
        rec.img_width_scaling, rec.img_height_scaling,
    )


def insert_recording(cur: sqlite3.Cursor, rec) -> int:
    cur.execute(
        f"INSERT INTO Recording ({', '.join(_RECORDING_COLS)})"
        f" VALUES ({', '.join('?' * len(_RECORDING_COLS))})",
        _recording_values(rec),
    )
    assert cur.lastrowid is not None
    return cur.lastrowid


def update_recording(cur: sqlite3.Cursor, rec, rec_id: int) -> None:
    sets = ", ".join(f"{c}=?" for c in _RECORDING_COLS)
    cur.execute(f"UPDATE Recording SET {sets} WHERE _id=?",
                (*_recording_values(rec), rec_id))


def write_delta_rows(cur: sqlite3.Cursor, delta: ModelData, rec_id: int) -> None:
    """executemany-insert one delta's rows (no recording row, no commit)."""
    for table, rows in (("JointStates", delta.joint_states),
                        ("JointCommands", delta.joint_commands)):
        if not rows:
            continue
        joint_names = sorted(rows[0].joints)
        cols = ", ".join(f'"{snake_to_column(j)}"' for j in joint_names)
        ph = ", ".join("?" * len(joint_names))
        cur.executemany(
            f"INSERT INTO {table} (stamp, recording_id, {cols}) VALUES (?, ?, {ph})",
            [
                (row.stamp, rec_id, *(float(row.joints[j]) for j in joint_names))
                for row in rows
            ],
        )
    cur.executemany(
        "INSERT INTO Rotation (stamp, recording_id, x, y, z, w) VALUES (?, ?, ?, ?, ?, ?)",
        [
            (r.stamp, rec_id, float(r.x), float(r.y), float(r.z), float(r.w))
            for r in delta.rotations
        ],
    )
    cur.executemany(
        "INSERT INTO GameState (stamp, recording_id, state) VALUES (?, ?, ?)",
        [(g.stamp, rec_id, g.state) for g in delta.game_states],
    )
    cur.executemany(
        "INSERT INTO Image (stamp, recording_id, data) VALUES (?, ?, ?)",
        [(i.stamp, rec_id, i.image.tobytes()) for i in delta.images],
    )


def write_model_data(conn: sqlite3.Connection, model_data: ModelData) -> int:
    """Bulk-insert a ModelData into the reference schema; returns recording id."""
    rec = model_data.recording
    assert rec is not None
    cur = conn.cursor()
    rec_id = insert_recording(cur, rec)
    write_delta_rows(cur, model_data, rec_id)
    conn.commit()
    return rec_id
