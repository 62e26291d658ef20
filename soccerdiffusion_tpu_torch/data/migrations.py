"""Schema versions and migrations (counterpart of
``soccerdiffusion_tpu/data/migrations.py``), a linear integer-versioned list
kept in a ``schema_version`` table:

  v1  the base schema, 20-joint tables (no elbow yaw)
  v2  "RElbowYaw" / "LElbowYaw" columns (default 0.0) in both joint tables

``create_schema`` stamps a new database at the latest version; ``migrate``
upgrades a v1 database (one of the reference's base revision among them) in
place, and does nothing to one at the latest version.
"""

from __future__ import annotations

import logging
import sqlite3
from typing import Callable

logger = logging.getLogger("soccerdiffusion_tpu_torch")

LATEST_VERSION = 2

_ELBOW_YAW_COLUMNS = ("RElbowYaw", "LElbowYaw")


def _migrate_v2_add_elbow_yaw(conn: sqlite3.Connection) -> None:
    """Add the NAO elbow-yaw columns. SQLite's ADD COLUMN cannot attach the
    [0, 2 pi) CHECK; the default 0.0 is in range."""
    for table in ("JointStates", "JointCommands"):
        existing = {row[1] for row in conn.execute(f"PRAGMA table_info({table})")}
        for col in _ELBOW_YAW_COLUMNS:
            if col not in existing:
                conn.execute(f'ALTER TABLE {table} ADD COLUMN "{col}" FLOAT DEFAULT 0.0')


MIGRATIONS: dict[int, tuple[str, Callable[[sqlite3.Connection], None]]] = {
    2: ("add NAO elbow-yaw columns", _migrate_v2_add_elbow_yaw),
}


def _ensure_version_table(conn: sqlite3.Connection) -> None:
    conn.execute("CREATE TABLE IF NOT EXISTS schema_version (version INTEGER NOT NULL)")


def schema_version(conn: sqlite3.Connection) -> int:
    """The stamped version; an unstamped database is v2 with the elbow-yaw
    columns, v1 without them, 0 without the joint tables."""
    _ensure_version_table(conn)
    row = conn.execute("SELECT MAX(version) FROM schema_version").fetchone()
    if row and row[0] is not None:
        return int(row[0])
    tables = {r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    if "JointStates" not in tables:
        return 0
    cols = {r[1] for r in conn.execute("PRAGMA table_info(JointStates)")}
    return 2 if "RElbowYaw" in cols else 1


def stamp(conn: sqlite3.Connection, version: int) -> None:
    _ensure_version_table(conn)
    conn.execute("DELETE FROM schema_version")
    conn.execute("INSERT INTO schema_version (version) VALUES (?)", (version,))
    conn.commit()


def migrate(conn: sqlite3.Connection, target: int = LATEST_VERSION) -> int:
    """Apply the pending migrations up to ``target``; returns the final
    version. Raises ``ValueError`` on a database without a schema."""
    current = schema_version(conn)
    if current == 0:
        raise ValueError("no schema present; run create_schema first")
    while current < target:
        current += 1
        name, fn = MIGRATIONS[current]
        logger.info(f"migrating schema to v{current}: {name}")
        fn(conn)
        stamp(conn, current)
    return current
