"""The port's ``ingest/`` against the JAX package's, on the CPU:

  * mcap_io: the committed Bit-Bots bag (zstd chunks) decodes into the same
    messages; the same messages written by either package's writer give the
    same bytes, with and without zstd; CDR encodes to the same bytes and
    decodes back on every schema of ``ros2_schemas`` and of the bags;
  * ``cli import`` of the committed bag and of bags written by
    tests/test_mcap_io.py's ``synthesize_bitbots_bag`` (with and without
    IMU) into one SQLite file per package: every table equal row by row
    (``SELECT * ... ORDER BY _id``), frames byte for byte; a truncated bag
    exits 1 in both;
  * the B-Human path through the committed pybh stand-in
    (tests/fixtures/pybh_log.json, as tests/test_ingest.py reads it): the
    same frames, the same rows;
  * the three resamplers on seeded streams: the same samples;
  * ``pack_from_stream``: array-equal shards, read back by the port's
    ``PackedDataset.load``, and trained from (``train --packed DIR``) with
    the flat optimizer and without, bit for bit; ``recording2mcap`` of one
    database: the same bytes.

The JAX package resizes frames with cv2, the port with its numpy copy of
OpenCV's arithmetic (``data/resize.py``). cv2 hands INTER_CUBIC to Intel's
IPP where it was built with it, and IPP lands ~4% of the pixels one level
away from OpenCV's own arithmetic (tests/test_torch_ingest_resize.py): the
JAX side runs here with ``cv2.ipp.setUseIPP(False)``, so that both packages
compute OpenCV's documented resize.
"""

import dataclasses
import json
import logging
import sqlite3
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from soccerdiffusion_tpu import cli as jcli
from soccerdiffusion_tpu.config import ModelConfig as JaxModelConfig
from soccerdiffusion_tpu.ingest import bhuman as jbhuman
from soccerdiffusion_tpu.ingest import mcap_io as jmcap
from soccerdiffusion_tpu.ingest import resampling as jresampling
from soccerdiffusion_tpu.ingest import ros2_schemas as jschemas
from soccerdiffusion_tpu.ingest.recording2mcap import recording2mcap as jrecording2mcap
from soccerdiffusion_tpu.ingest.streaming import pack_from_stream as jpack
from soccerdiffusion_tpu_torch import cli as pcli
from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.ingest import bhuman as pbhuman
from soccerdiffusion_tpu_torch.ingest import mcap_io as pmcap
from soccerdiffusion_tpu_torch.ingest import resampling as presampling
from soccerdiffusion_tpu_torch.ingest import ros2_schemas as pschemas
from soccerdiffusion_tpu_torch.ingest.recording2mcap import recording2mcap as precording2mcap
from soccerdiffusion_tpu_torch.ingest.streaming import pack_from_stream as ppack
from tests import test_mcap_io
from tests import test_ingest

cv2 = pytest.importorskip("cv2")

FIXTURE = Path(__file__).parent / "fixtures" / "bitbots_synth.mcap"
TABLES = ("Recording", "Image", "Rotation", "JointStates", "JointCommands", "GameState")
BAG_SCHEMAS = {
    "sensor_msgs/msg/JointState": test_mcap_io.JOINT_STATE_SCHEMA,
    "bitbots_msgs/msg/JointCommand": test_mcap_io.JOINT_COMMAND_SCHEMA,
    "sensor_msgs/msg/Imu": test_mcap_io.IMU_SCHEMA,
    "sensor_msgs/msg/Image": test_mcap_io.IMAGE_SCHEMA,
    "bitbots_msgs/msg/GameState": test_mcap_io.GAMESTATE_SCHEMA,
    "tf2_msgs/msg/TFMessage": test_mcap_io.TF_SCHEMA,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's small steps: the test run shares
    the cores among its worker processes, and several threads a worker
    contend for them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def opencv_arithmetic():
    """cv2 without IPP for the JAX side (module docstring), restored after."""
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


def plain(value):
    """A decoded message as nested dicts / lists, for comparison."""
    if isinstance(value, SimpleNamespace):
        return {k: plain(v) for k, v in vars(value).items()}
    if isinstance(value, list):
        return [plain(v) for v in value]
    return value


def write_bag(path, port: bool, zstd: bool = True, **kw):
    """``synthesize_bitbots_bag`` through the JAX package's writer and
    encoder, or the port's, with or without zstd chunks."""
    mod = pmcap if port else jmcap
    saved = test_mcap_io.McapWriter, test_mcap_io.encode_cdr
    test_mcap_io.McapWriter = lambda f, **_: mod.McapWriter(
        f, chunk_compression="zstd" if zstd else None)
    test_mcap_io.encode_cdr = mod.encode_cdr
    try:
        test_mcap_io.synthesize_bitbots_bag(path, **kw)
    finally:
        test_mcap_io.McapWriter, test_mcap_io.encode_cdr = saved


def tables(db) -> dict:
    conn = sqlite3.connect(db)
    try:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY _id").fetchall() for t in TABLES}
    finally:
        conn.close()


# ------------------------------------------------------------------ mcap_io

def test_reader_decodes_the_fixture_as_jax():
    got, want = pmcap.McapReader.from_file(FIXTURE), jmcap.McapReader.from_file(FIXTURE)
    assert got.message_time_range == want.message_time_range
    assert vars(got.statistics) == vars(want.statistics)
    pairs = list(zip(got.iter_messages(), want.iter_messages(), strict=True))
    assert len(pairs) > 300
    for (gc, gs, gm), (wc, ws, wm) in pairs:
        for a, b in ((gc, wc), (gs, ws), (gm, wm)):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert plain(pmcap.decode_cdr(gs.data.decode(), gs.name, gm.data)) == plain(
            jmcap.decode_cdr(ws.data.decode(), ws.name, wm.data))


@pytest.mark.parametrize("zstd", [True, False], ids=["zstd", "plain"])
def test_writer_bytes_equal_jax(tmp_path, zstd):
    write_bag(tmp_path / "jax.mcap", False, zstd, n_ticks=60)
    write_bag(tmp_path / "port.mcap", True, zstd, n_ticks=60)
    data = (tmp_path / "port.mcap").read_bytes()
    assert data == (tmp_path / "jax.mcap").read_bytes()
    assert (b"zstd" in data) == zstd


def test_cdr_round_trips_on_every_schema():
    rng = np.random.default_rng(3)
    head = lambda: SimpleNamespace(stamp=SimpleNamespace(sec=int(rng.integers(1 << 30)),
                                                         nanosec=int(rng.integers(1 << 30))),
                                   frame_id="base_link")
    vec = lambda: SimpleNamespace(**{k: float(rng.normal()) for k in "xyz"})
    names = [f"joint{i}" for i in range(5)]
    messages = {
        ("std_msgs/msg/String", pschemas.STRING_SCHEMA): SimpleNamespace(data="PLAYING"),
        ("geometry_msgs/msg/Quaternion", pschemas.QUATERNION_SCHEMA): SimpleNamespace(
            w=0.5, **vars(vec())),
        ("geometry_msgs/msg/Vector3", pschemas.VECTOR3_SCHEMA): vec(),
        ("sensor_msgs/msg/Image", pschemas.IMAGE_SCHEMA): SimpleNamespace(
            header=head(), height=3, width=5, encoding="rgb8", is_bigendian=0, step=15,
            data=rng.integers(0, 256, 45, dtype=np.uint8).tobytes()),
        ("sensor_msgs/msg/JointState", pschemas.JOINT_STATE_SCHEMA): SimpleNamespace(
            header=head(), name=names, position=rng.normal(size=5).tolist(),
            velocity=[], effort=rng.normal(size=5).tolist()),
        ("bitbots_msgs/msg/JointCommand", BAG_SCHEMAS["bitbots_msgs/msg/JointCommand"]):
            SimpleNamespace(header=head(), joint_names=names, positions=rng.normal(size=5).tolist(),
                            velocities=[], accelerations=[], max_currents=[1.5] * 5),
        ("sensor_msgs/msg/Imu", BAG_SCHEMAS["sensor_msgs/msg/Imu"]): SimpleNamespace(
            header=head(), orientation=SimpleNamespace(w=1.0, **vars(vec())),
            orientation_covariance=rng.normal(size=9).tolist(), angular_velocity=vec(),
            angular_velocity_covariance=[0.0] * 9, linear_acceleration=vec(),
            linear_acceleration_covariance=[0.0] * 9),
        ("bitbots_msgs/msg/GameState", BAG_SCHEMAS["bitbots_msgs/msg/GameState"]): SimpleNamespace(
            header=head(), game_state=3, secondary_state=1, first_half=False, own_score=2,
            rival_score=1, penalized=True, seconds_till_unpenalized=7, team_color=0),
        ("tf2_msgs/msg/TFMessage", BAG_SCHEMAS["tf2_msgs/msg/TFMessage"]): SimpleNamespace(
            transforms=[SimpleNamespace(header=head(), child_frame_id="base_footprint",
                                        transform=SimpleNamespace(
                                            translation=vec(),
                                            rotation=SimpleNamespace(w=0.9, **vars(vec()))))]),
    }
    for (name, schema), msg in messages.items():
        data = pmcap.encode_cdr(schema, name, msg)
        assert data == jmcap.encode_cdr(schema, name, msg), name
        assert plain(pmcap.decode_cdr(schema, name, data)) == plain(msg), name
    assert {k: getattr(pschemas, k) for k in dir(pschemas) if k.isupper()} == {
        k: getattr(jschemas, k) for k in dir(jschemas) if k.isupper()}


# ------------------------------------------------------------------ import

def import_both(tmp_path, bag, argv=()):
    """``cli import`` of ``bag`` by each package into its own database:
    (rc jax, rc port, tables jax, tables port)."""
    dbs = {k: tmp_path / f"{k}.sqlite3" for k in ("jax", "port")}
    rcs = [main(["import", "bit-bots", str(bag), "lab", "--db", str(dbs[k]), *argv])
           for k, main in (("jax", jcli.main), ("port", pcli.main))]
    return (*rcs, *(tables(dbs[k]) if rc == 0 else None for k, rc in zip(dbs, rcs)))


@pytest.mark.parametrize("source", ["fixture", "imu", "no_imu", "materialised"])
def test_cli_import_tables_equal_jax(tmp_path, source):
    bag = FIXTURE
    if source != "fixture":
        bag = tmp_path / "game.mcap"
        write_bag(bag, True, n_ticks=150, with_imu=source != "no_imu")
    argv = ["--flush-rows", "0"] if source == "materialised" else ["--flush-rows", "97"]
    rc_jax, rc_port, want, got = import_both(tmp_path, bag, argv)
    assert rc_jax == rc_port == 0
    for table in TABLES:
        assert len(got[table]) == len(want[table]) > 0, table
        assert got[table] == want[table], table
    frames = [np.frombuffer(row[3], np.uint8) for row in got["Image"]]
    assert all(f.size == 480 * 480 * 3 for f in frames)


def test_truncated_bag_exits_1_in_both(tmp_path, caplog):
    data = FIXTURE.read_bytes()
    bag = tmp_path / "cut.mcap"
    bag.write_bytes(data[: len(data) * 2 // 3])
    with caplog.at_level(logging.ERROR):
        rc_jax, rc_port, _, _ = import_both(tmp_path, bag)
    assert rc_jax == rc_port == 1
    assert "truncated MCAP file" in caplog.text
    assert pcli.main(["import", "bit-bots", str(tmp_path / "missing.mcap"), "lab"]) == 1
    assert pcli.main(["import", "b-human", str(bag), "lab"]) == 1  # not a .log


# ------------------------------------------------------------------ B-Human

def bhuman_strategy(mod):
    ingest = mod.__name__.rsplit(".", 1)[0]
    conv = __import__(f"{ingest}.converters", fromlist=["x"])
    res = __import__(f"{ingest}.resampling", fromlist=["x"])
    rows = __import__(f"{ingest}.rows", fromlist=["x"])
    meta = rows.ImportMetadata(allow_public=False, team_name="B-Human", robot_type="NAO6",
                               location="lab", simulated=False)
    return mod.BHumanImportStrategy(
        meta, conv.BHumanImageConverter(res.MaxRateResampler(10)),
        conv.BHumanGameStateConverter(res.OriginalRateResampler()),
        conv.SyncedDataConverter(res.PreviousInterpolationResampler(50)))


def test_bhuman_fixture_gives_the_same_frames_and_rows(tmp_path):
    want = jbhuman.frames_from_pybh(test_ingest.TestPybhFixture._load())
    got = pbhuman.frames_from_pybh(test_ingest.TestPybhFixture._load())
    assert len(got) == len(want) == 122
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
    assert sum(f.upper_image is not None for f in got) == 2
    from soccerdiffusion_tpu.data.schema import connect as jconnect, create_schema as jcreate
    from soccerdiffusion_tpu.ingest import ModelImporter as JImporter
    from soccerdiffusion_tpu_torch.data.schema import connect, create_schema
    from soccerdiffusion_tpu_torch.ingest import ModelImporter

    result = {}
    for key, mod, frames, conn_fn, create, importer in (
            ("jax", jbhuman, want, jconnect, jcreate, JImporter),
            ("port", pbhuman, got, connect, create_schema, ModelImporter)):
        strategy = bhuman_strategy(mod)
        md = strategy.convert_frames(frames, original_file="fixture.log")
        strategy.convert_to_model_data = lambda _path, md=md: md
        conn = conn_fn(tmp_path / f"{key}.sqlite3")
        create(conn)
        importer(conn, strategy).import_to_db(Path("fixture.log"))
        conn.close()
        result[key] = tables(tmp_path / f"{key}.sqlite3")
    assert result["port"] == result["jax"]
    assert len(result["port"]["Image"]) >= 1 and result["port"]["Recording"][0][4] == "RED"


def test_yuyv_jpeg_decode_equals_jax():
    from io import BytesIO

    from PIL import Image

    rng = np.random.default_rng(9)
    yuyv = rng.integers(0, 256, (12, 10, 4), dtype=np.uint8)
    buf = BytesIO()
    Image.fromarray(yuyv, "RGBA").save(buf, "PNG")  # lossless: the decode is what is held
    data = buf.getvalue()
    assert np.array_equal(pbhuman.decode_bhuman_jpeg(data, 10, 6),
                          jbhuman.decode_bhuman_jpeg(data, 10, 6))


# ------------------------------------------------------------------ resamplers

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resamplers_give_the_same_samples(seed):
    rng = np.random.default_rng(seed)
    stamps = np.cumsum(rng.exponential(0.013, 400))
    for make in (lambda m: m.PreviousInterpolationResampler(50),
                 lambda m: m.MaxRateResampler(10), lambda m: m.OriginalRateResampler()):
        port, jax_ = make(presampling), make(jresampling)
        for i, t in enumerate(stamps):
            got = [(s.data, s.timestamp) for s in port.resample(i, float(t))]
            assert got == [(s.data, s.timestamp) for s in jax_.resample(i, float(t))]


# ------------------------------------------------------------------ pack / export

def test_pack_from_stream_shards_equal_jax(tmp_path):
    from soccerdiffusion_tpu.cli import _build_strategy as jstrategy

    args = SimpleNamespace(type="bit-bots", public=False, team_name=None, robot_type=None,
                           location="lab", simulated=False, caching=False, video=False)
    cfg = dict(use_images=True, image_resolution=32, image_context_length=2, num_joints=20,
               imu_orientation_embedding_method="five_dim")
    stats = {
        "jax": jpack(jstrategy(args), FIXTURE, JaxModelConfig(**cfg), tmp_path / "jax",
                     flush_rows=97, sampling_rate=50),
        "port": ppack(pcli._build_strategy(args), FIXTURE, ModelConfig(**cfg), tmp_path / "port",
                      flush_rows=97, sampling_rate=50)}
    assert {k: v for k, v in stats["port"].items() if k != "out_dir"} == {
        k: v for k, v in stats["jax"].items() if k != "out_dir"}
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in files:
        if name.endswith(".npy"):
            a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert json.loads((tmp_path / "port" / name).read_text()) == json.loads(
                (tmp_path / "jax" / name).read_text())
    packed = PackedDataset.load(tmp_path / "port", ModelConfig(**cfg))
    assert len(packed) > 0 and packed.images.shape[1:] == (32, 32, 3)
    assert pcli.main(["pack", "bit-bots", str(FIXTURE), "lab", str(tmp_path / "cli")]) == 0


def test_recording2mcap_bytes_equal_jax(tmp_path):
    db = tmp_path / "db.sqlite3"
    assert pcli.main(["import", "bit-bots", str(FIXTURE), "lab", "--db", str(db)]) == 0
    jrecording2mcap(db, 1, tmp_path / "jax.mcap")
    precording2mcap(db, 1, tmp_path / "port.mcap")
    data = (tmp_path / "port.mcap").read_bytes()
    assert data == (tmp_path / "jax.mcap").read_bytes()
    topics = {c.topic for c in pmcap.McapReader(data).channels.values()}
    assert topics == {"/recording", "/image", "/rotation", "/rotation/euler", "/joint_states",
                      "/joint_commands", "/game_state"}
    assert pcli.main(["db", "recording2mcap", "2", str(tmp_path / "none.mcap"),
                      "--db", str(db)]) == 1


def test_train_from_packed_shards_flat_and_per_tensor(tmp_path):
    """``cli pack`` of the committed bag at a flagship cut to 32 px, then
    ``train --packed DIR`` from its shards, 3 steps with the flat optimizer
    and 3 without: the same parameters bit for bit (AdamW is elementwise)."""
    import yaml

    from soccerdiffusion_tpu_torch.training import train

    raw = yaml.safe_load((Path(__file__).parent.parent / "soccerdiffusion_tpu_torch" / "training"
                          / "configs" / "vit_flagship.yaml").read_text())
    raw.update(hidden_dim=64, image_resolution=32, vit_patch_size=8, vit_width=64, vit_depth=2,
               action_context_length=12, joint_state_context_length=12, imu_context_length=12,
               num_normalization_samples=50, batch_size=4)
    for flat in (False, True):
        (tmp_path / f"tiny_{flat}.yaml").write_text(yaml.safe_dump({**raw, "flat_optimizer": flat}))
    shards = tmp_path / "shards"
    assert pcli.main(["pack", "bit-bots", str(FIXTURE), "lab", str(shards), "--config",
                      str(tmp_path / "tiny_False.yaml")]) == 0
    states = [train.main(["-c", str(tmp_path / f"tiny_{flat}.yaml"), "--packed", str(shards),
                          "--epochs", "1", "--steps-per-epoch", "3", "-o", str(tmp_path / str(flat)),
                          "--device", "cpu"]) for flat in (False, True)]
    assert [s.step for s in states] == [3, 3] and states[1].optimizer.in_buffer()
    for (name, p), q in zip(states[0].model.named_parameters(), states[1].model.parameters()):
        assert torch.equal(p, q), name
