"""The SQLite data source against the JAX package, on the CPU:

  * a database written by the JAX package's ``create_schema`` +
    ``insert_dummy_data`` and one written by the port's, from the same seed,
    hold the same schema and the same rows in every table;
  * the per-joint CHECK constraints reject an out-of-range joint;
  * the migrations behave as the JAX package's tests hold them to
    (tests/test_data.py TestMigrations): a new database is stamped at the
    latest version, v1 is inferred and migrated, ``migrate`` is idempotent,
    a database without a schema raises;
  * the read-only connection takes ``immutable=1``, or ``mode=ro`` when a
    non-empty ``-wal`` sidecar holds writes not yet checkpointed, and may be
    read from another thread;
  * ``WindowedDataset.from_sqlite``, frames streamed and decoded up front,
    gives the JAX package's windows and batches bit for bit (48 px frames
    resized to 32 px: the port's numpy INTER_AREA against cv2), and streams
    lazily (``fetch_count``).
"""

import math
import sqlite3
import threading

import numpy as np
import pytest

from soccerdiffusion_tpu.config import CANONICAL_JOINT_NAMES_20
from soccerdiffusion_tpu.config import ModelConfig as JaxModelConfig
from soccerdiffusion_tpu.data import dataset as jds
from soccerdiffusion_tpu.data import dummy as jdummy
from soccerdiffusion_tpu.data import migrations as jmig
from soccerdiffusion_tpu.data import schema as jschema
from soccerdiffusion_tpu_torch.data import dataset as pds
from soccerdiffusion_tpu_torch.data import dummy as pdummy
from soccerdiffusion_tpu_torch.data import migrations as pmig
from soccerdiffusion_tpu_torch.data import schema as pschema
from tests.test_torch_jax_params import port_config

TABLES = ("Recording", "Image", "Rotation", "JointStates", "JointCommands", "GameState",
          "schema_version")
RECORDINGS, ROWS, IMAGE_STEP, IMAGE_SIZE = 2, 90, 10, 48
# 20 joints (the schema's columns), 32 px ViT frames from 48 px recordings
CFG = JaxModelConfig(
    num_joints=20, hidden_dim=48, trajectory_prediction_length=5, action_context_length=12,
    joint_state_context_length=12, imu_context_length=12, use_images=True,
    image_encoder_type="vit", image_resolution=32, image_context_length=3, vit_patch_size=8,
    vit_width=64, vit_depth=2, attention_impl="xla")


def write_db(path, schema, dummy, seed=3):
    conn = schema.connect(path)
    schema.create_schema(conn)
    dummy.insert_dummy_data(conn, RECORDINGS, ROWS, IMAGE_STEP, seed=seed, image_size=IMAGE_SIZE)
    conn.close()
    return path


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(the JAX package's database, the port's), the same seed."""
    root = tmp_path_factory.mktemp("sqlite")
    return (write_db(root / "jax.sqlite3", jschema, jdummy),
            write_db(root / "port.sqlite3", pschema, pdummy))


@pytest.mark.parametrize("table", TABLES)
def test_dummy_databases_hold_the_same_rows(dbs, table):
    jax_db, port_db = (sqlite3.connect(p) for p in dbs)
    for query in (f"SELECT * FROM {table} ORDER BY rowid",
                  f"SELECT sql FROM sqlite_master WHERE tbl_name = '{table}' ORDER BY name"):
        want, got = jax_db.execute(query).fetchall(), port_db.execute(query).fetchall()
        assert got == want and len(want) > 0, query


@pytest.mark.parametrize("table,value", [("JointStates", -0.1), ("JointCommands", 2 * math.pi),
                                         ("JointCommands", 7.0)])
def test_check_rejects_an_out_of_range_joint(tmp_path, table, value):
    conn = pschema.connect(tmp_path / "db.sqlite3")
    pschema.create_schema(conn)
    conn.execute(f'INSERT INTO {table} (stamp, recording_id, "HeadPan") VALUES (0, 1, 1.0)')
    with pytest.raises(sqlite3.IntegrityError, match="CHECK"):
        conn.execute(f'INSERT INTO {table} (stamp, recording_id, "HeadPan") VALUES (0, 1, ?)',
                     (value,))


def make_v1_db(path):
    """A base-revision database: 20-joint tables, no elbow yaw, no stamp."""
    conn = sqlite3.connect(path)
    cols = ", ".join(f'"{n}" FLOAT DEFAULT 0.0' for n in CANONICAL_JOINT_NAMES_20)
    for table in ("JointStates", "JointCommands"):
        conn.execute(f"CREATE TABLE {table} (_id INTEGER PRIMARY KEY, stamp FLOAT,"
                     f" recording_id INTEGER, {cols})")
    conn.execute('INSERT INTO JointStates (stamp, recording_id, "HeadPan") VALUES (0, 1, 1.5)')
    conn.commit()
    return conn


@pytest.mark.parametrize("case", ["fresh_stamped_latest", "v1_inferred_and_migrated",
                                  "idempotent", "no_schema_raises"])
def test_migrations_behave_as_jax(tmp_path, case):
    """Each case on the port and on the JAX package: the same versions."""
    for mig, schema, name in ((pmig, pschema, "port"), (jmig, jschema, "jax")):
        if case == "fresh_stamped_latest":
            conn = schema.connect(tmp_path / f"{name}.sqlite3")
            schema.create_schema(conn)
            assert mig.schema_version(conn) == mig.LATEST_VERSION == 2
        elif case == "v1_inferred_and_migrated":
            conn = make_v1_db(tmp_path / f"{name}.sqlite3")
            assert mig.schema_version(conn) == 1
            assert mig.migrate(conn) == 2
            cols = {r[1] for r in conn.execute("PRAGMA table_info(JointCommands)")}
            assert {"RElbowYaw", "LElbowYaw"} <= cols
            assert conn.execute('SELECT "RElbowYaw" FROM JointStates').fetchone()[0] == 0.0
        elif case == "idempotent":
            conn = make_v1_db(tmp_path / f"{name}.sqlite3")
            assert mig.migrate(conn) == 2 and mig.migrate(conn) == 2
            assert mig.schema_version(conn) == 2
        else:
            conn = sqlite3.connect(tmp_path / f"{name}.sqlite3")
            with pytest.raises(ValueError, match="no schema"):
                mig.migrate(conn)


@pytest.mark.parametrize("wal", ["live_wal", "checkpointed"])
def test_read_only_mode_follows_the_wal_sidecar(tmp_path, wal):
    """A write committed while the writer holds the WAL open is seen through
    ``mode=ro`` (an ``immutable=1`` reader would skip it); once the writer
    closes, the sidecar is checkpointed away and ``immutable=1`` reads it."""
    path = tmp_path / "db.sqlite3"
    writer = pschema.connect(path)
    pschema.create_schema(writer)
    writer.execute("INSERT INTO GameState (stamp, recording_id, state) VALUES (0.5, 1, 'PLAYING')")
    writer.commit()
    if wal == "checkpointed":
        writer.close()
    sidecar = path.with_name(path.name + "-wal")
    live = sidecar.exists() and sidecar.stat().st_size > 0
    assert live == (wal == "live_wal")
    reader = pschema.connect(path, read_only=True)
    assert reader.execute("SELECT COUNT(*) FROM GameState").fetchone()[0] == 1
    if live:  # what immutable=1 would have read
        blind = sqlite3.connect(f"file:{path}?immutable=1", uri=True)
        assert blind.execute("SELECT name FROM sqlite_master WHERE name='GameState'").fetchall() == []
    with pytest.raises(sqlite3.OperationalError, match="readonly"):
        reader.execute("INSERT INTO GameState (stamp, recording_id, state) VALUES (1, 1, 'X')")
    seen = []  # the prefetch thread reads streamed frames through this connection
    thread = threading.Thread(target=lambda: seen.append(
        reader.execute("SELECT state FROM GameState").fetchone()[0]))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive() and seen == ["PLAYING"]


def assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "eager"])
@pytest.mark.parametrize("five_dim", [False, True], ids=["quaternion", "five_dim"])
def test_from_sqlite_matches_jax(dbs, stream, five_dim):
    cfg = JaxModelConfig(**{**CFG.__dict__, "imu_orientation_embedding_method":
                            "five_dim" if five_dim else "quaternion"})
    db = dbs[1]
    jd = jds.WindowedDataset.from_sqlite(db, cfg, trajectory_stride=2, stream_images=stream)
    pd = pds.WindowedDataset.from_sqlite(db, port_config(cfg), trajectory_stride=2,
                                         stream_images=stream)
    assert len(pd) == len(jd) == RECORDINGS * ((ROWS - 5) // 2)
    for idx in (0, 1, 5, 6, 21, len(jd) // 2, len(jd) - 1):
        assert_items_equal(pd[idx], jd[idx])
    np.testing.assert_array_equal(pd.image_boundary_indices(), jd.image_boundary_indices())
    np.testing.assert_array_equal(pd.sample_targets(30, seed=4), jd.sample_targets(30, seed=4))
    for got, want in zip(pd.batches(8, seed=1), jd.batches(8, seed=1)):
        assert_items_equal(got, want)
    frames = pd[len(pd) - 1]["image_data"]
    assert frames.shape == (3, 32, 32, 3) and np.abs(frames).max() > 0


def test_from_sqlite_without_images_and_lazy_streaming(dbs):
    """Frames are read per window: none while loading, as many as the
    window shows when it is assembled; a camera-free config reads none."""
    cfg = port_config(CFG)
    pd = pds.WindowedDataset.from_sqlite(dbs[1], cfg)
    stores = [rec.images for rec in pd.recordings]
    assert all(isinstance(s, pds.SqliteImageStore) for s in stores)
    assert [len(s) for s in stores] == [ROWS // IMAGE_STEP] * RECORDINGS
    assert sum(s.fetch_count for s in stores) == 0
    item = pd[40]  # stamp 0.4 s: the frames at 0.1 .. 0.4 s, the last 3 of them
    assert sum(s.fetch_count for s in stores) == 3 and item["image_data"].shape[0] == 3
    eager = pds.WindowedDataset.from_sqlite(dbs[1], cfg, stream_images=False)
    assert all(isinstance(rec.images, np.ndarray) for rec in eager.recordings)
    assert_items_equal(eager[40], item)
    proprio = pds.WindowedDataset.from_sqlite(dbs[1], port_config(CFG, use_images=False))
    assert all(rec.images is None for rec in proprio.recordings)
    assert "image_data" not in proprio[40] and len(proprio) == len(pd)
