"""Top-level CLI of the PyTorch port (counterpart of
``soccerdiffusion_tpu/cli.py``):

  python -m soccerdiffusion_tpu_torch.cli import bit-bots <file.mcap> <location> [--db PATH]
  python -m soccerdiffusion_tpu_torch.cli import b-human <file.log> <location> [--caching] [--video]
  python -m soccerdiffusion_tpu_torch.cli pack bit-bots <file.mcap> <location> <out_dir> [--config Y]
  python -m soccerdiffusion_tpu_torch.cli db recording2mcap <recording_id> <output.mcap> [--db PATH]
  python -m soccerdiffusion_tpu_torch.cli db create-schema [--db PATH]
  python -m soccerdiffusion_tpu_torch.cli db dummy-data [-n N] [-s S] [-i I] [--db PATH]
  python -m soccerdiffusion_tpu_torch.cli db migrate [--db PATH]
  python -m soccerdiffusion_tpu_torch.cli db plot-window <index> <out.png> [--config Y] [--dummy-data]

and the training, evaluation and deployment entry points:

  python -m soccerdiffusion_tpu_torch.cli train ...    (= soccerdiffusion_tpu_torch.training.train)
  python -m soccerdiffusion_tpu_torch.cli distill ...  (= soccerdiffusion_tpu_torch.training.distill)
  python -m soccerdiffusion_tpu_torch.cli plot ...     (= soccerdiffusion_tpu_torch.inference.plot)
  python -m soccerdiffusion_tpu_torch.cli report ...   (= soccerdiffusion_tpu_torch.evaluation.report)
  python -m soccerdiffusion_tpu_torch.cli serve <ckpt> [--udp HOST:PORT] [--device cuda|cpu]

``serve`` drives a robot at the 50 Hz control rate with a checkpoint's
sampler (``inference/realtime.py``), on the built-in simulated plant or a
robot-side UDP bridge (``inference/transport.py``), on the card unless
``--device cpu``. The recording verbs run on the host through the port's
``ingest/``: ``import`` writes a recording into the SQLite dataset, ``pack``
streams it into ``PackedDataset`` shards, ``db recording2mcap`` exports one
back to a typed MCAP file; each exits 0, or 1 with the error logged on a
bad recording (an ``AssertionError``, ``ImportError`` or ``ValueError``, e.g.
a truncated bag), as the JAX package's do.
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading

import numpy as np
import torch

from pathlib import Path

from soccerdiffusion_tpu_torch import DEFAULT_RESAMPLE_RATE_HZ, IMAGE_MAX_RESAMPLE_RATE_HZ

logger = logging.getLogger("soccerdiffusion_tpu_torch")

DELEGATED = {
    "train": "soccerdiffusion_tpu_torch.training.train",
    "distill": "soccerdiffusion_tpu_torch.training.distill",
    "plot": "soccerdiffusion_tpu_torch.inference.plot",
    "report": "soccerdiffusion_tpu_torch.evaluation.report",
}


def _add_import_source_args(p):
    p.add_argument("type", choices=["bit-bots", "b-human"])
    p.add_argument("file", type=str)
    p.add_argument("location", type=str)
    p.add_argument("--team-name", type=str, default=None)
    p.add_argument("--robot-type", type=str, default=None)
    p.add_argument("--public", action="store_true")
    p.add_argument("--simulated", action="store_true")
    p.add_argument("--caching", action="store_true", help="b-human: cache parsed frames")
    p.add_argument("--video", action="store_true", help="b-human: show live video")


def _build_import_parser(sub):
    p = sub.add_parser("import", help="import a recording into the dataset db")
    _add_import_source_args(p)
    p.add_argument("--db", type=str, default=None)
    p.add_argument("--flush-rows", type=int, default=50_000,
                   help="bounded-memory streaming insert interval; 0 = materialize the whole "
                        "bag first (the reference's behaviour)")


def _build_pack_parser(sub):
    p = sub.add_parser("pack", help="stream a recording straight into packed training shards "
                                    "(mcap -> .npy, no SQLite hop)")
    _add_import_source_args(p)
    p.add_argument("out_dir", type=str)
    p.add_argument("--config", type=str, default=None,
                   help="training config yaml fixing joint count, image resolution and IMU "
                        "embedding (default: default.yaml's geometry)")
    p.add_argument("--flush-rows", type=int, default=50_000)
    p.add_argument("--sampling-rate", type=int, default=DEFAULT_RESAMPLE_RATE_HZ,
                   help="rate the import resampler produced rows at (the packed index's "
                        "stamp grid)")


def _build_db_parser(sub):
    p = sub.add_parser("db", help="database utilities")
    db_sub = p.add_subparsers(dest="db_command", required=True)
    c = db_sub.add_parser("create-schema")
    d = db_sub.add_parser("dummy-data")
    d.add_argument("-n", "--num-recordings", type=int, default=10)
    d.add_argument("-s", "--num-samples", type=int, default=2000)
    d.add_argument("-i", "--image-step", type=int, default=10)
    r = db_sub.add_parser("recording2mcap", help="export a recording as a typed MCAP file")
    r.add_argument("recording_id", type=int)
    r.add_argument("output", type=str)
    m = db_sub.add_parser("migrate")
    w = db_sub.add_parser("plot-window",
                          help="render one training window (joints, rotation, images, game "
                               "state) to a PNG")
    w.add_argument("index", type=int)
    w.add_argument("output", type=str)
    w.add_argument("--config", type=str, default=None,
                   help="training config yaml (default: default.yaml geometry, no images)")
    w.add_argument("--dummy-data", action="store_true")
    w.add_argument("--seed", type=int, default=0)
    for leaf in (c, d, r, m, w):
        leaf.add_argument("--db", type=str, default=None)


def _build_serve_parser(sub):
    p = sub.add_parser("serve", help="drive a robot with a trained checkpoint at the 50 Hz "
                                     "control rate (simulated plant or a UDP robot bridge)")
    p.add_argument("checkpoint", type=str)
    p.add_argument("--udp", type=str, default=None, metavar="HOST:PORT",
                   help="drive a robot-side UdpRobotServer at this address instead of the "
                        "in-process simulated plant")
    p.add_argument("--duration", type=float, default=10.0, help="seconds to run the control loop")
    p.add_argument("--control-rate", type=float, default=DEFAULT_RESAMPLE_RATE_HZ)
    p.add_argument("--replan-ticks", type=int, default=None,
                   help="receding horizon: replan every N control ticks (default: the "
                        "checkpoint's pred_len, the reference's 200 ms chunk)")
    p.add_argument("--steps", type=int, default=None, help="override the sampler step count")
    p.add_argument("--solver", type=str, default="ddim",
                   help="'ddim' or 'dpmpp' / 'dpmpp@lambda'; ignored for distilled checkpoints")
    p.add_argument("--guidance", type=str, default=None, metavar="SCALE[@MODALITY,...]",
                   help="classifier-free guidance, e.g. '2.0@image' (iterative samplers only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="soccerdiffusion-tpu-torch",
        epilog="also: train / distill / plot / report, handed to "
               "soccerdiffusion_tpu_torch.training.train, .training.distill, .inference.plot "
               "and .evaluation.report (run e.g. %(prog)s train --help)")
    sub = parser.add_subparsers(dest="command", required=True)
    _build_import_parser(sub)
    _build_pack_parser(sub)
    _build_db_parser(sub)
    _build_serve_parser(sub)
    return parser


def _validate_source(args) -> Path | None:
    file_path = Path(args.file)
    if not file_path.exists():
        logger.error(f"file not found: {file_path}")
        return None
    if args.type == "bit-bots" and file_path.suffix != ".mcap":
        logger.error("bit-bots imports expect an .mcap file")
        return None
    if args.type == "b-human" and file_path.suffix != ".log":
        logger.error("b-human imports expect a .log file")
        return None
    return file_path


def _build_strategy(args):
    """The import strategy of ``args.type``: joint rows resampled at 50 Hz,
    camera frames at most 10 Hz, game states as they come."""
    from soccerdiffusion_tpu_torch.ingest import (
        BHumanGameStateConverter,
        BHumanImageConverter,
        BitBotsGameStateConverter,
        BitbotsImageConverter,
        ImportMetadata,
        MaxRateResampler,
        OriginalRateResampler,
        PreviousInterpolationResampler,
        SyncedDataConverter,
    )

    bitbots = args.type == "bit-bots"
    metadata = ImportMetadata(
        allow_public=args.public,
        team_name=args.team_name or ("Bit-Bots" if bitbots else "B-Human"),
        robot_type=args.robot_type or ("Wolfgang-OP" if bitbots else "NAO6"),
        location=args.location,
        simulated=args.simulated,
    )
    synced = SyncedDataConverter(PreviousInterpolationResampler(DEFAULT_RESAMPLE_RATE_HZ))
    if bitbots:
        from soccerdiffusion_tpu_torch.ingest.bitbots import BitBotsImportStrategy

        return BitBotsImportStrategy(
            metadata, BitbotsImageConverter(MaxRateResampler(IMAGE_MAX_RESAMPLE_RATE_HZ)),
            BitBotsGameStateConverter(OriginalRateResampler()), synced)
    from soccerdiffusion_tpu_torch.ingest.bhuman import BHumanImportStrategy

    return BHumanImportStrategy(
        metadata, BHumanImageConverter(MaxRateResampler(IMAGE_MAX_RESAMPLE_RATE_HZ)),
        BHumanGameStateConverter(OriginalRateResampler()), synced, caching=args.caching,
        video=args.video)


def cmd_import(args) -> int:
    from soccerdiffusion_tpu_torch import DB_PATH
    from soccerdiffusion_tpu_torch.data.schema import connect, create_schema
    from soccerdiffusion_tpu_torch.ingest import ModelImporter

    file_path = _validate_source(args)
    if file_path is None:
        return 1
    strategy = _build_strategy(args)
    conn = connect(args.db or DB_PATH)
    try:
        create_schema(conn)
        try:
            rec_id = ModelImporter(conn, strategy).import_to_db(
                file_path, flush_rows=args.flush_rows or None)
        except (AssertionError, ImportError, ValueError) as exc:
            logger.error(f"import failed: {exc}")
            return 1
        logger.info(f"imported recording {rec_id}")
        return 0
    finally:
        conn.close()


def cmd_pack(args) -> int:
    from soccerdiffusion_tpu_torch.config import Config, ModelConfig
    from soccerdiffusion_tpu_torch.ingest.streaming import pack_from_stream

    file_path = _validate_source(args)
    if file_path is None:
        return 1
    config = Config.from_yaml(args.config).model if args.config else ModelConfig()
    try:
        stats = pack_from_stream(_build_strategy(args), file_path, config, args.out_dir,
                                 flush_rows=args.flush_rows, sampling_rate=args.sampling_rate)
    except (AssertionError, ImportError, ValueError) as exc:
        logger.error(f"pack failed: {exc}")
        return 1
    logger.info(f"packed {stats['rows']} rows -> {stats['out_dir']}")
    return 0


def serve(args) -> dict:
    """Closed-loop serving of a checkpoint (the reference's deployment: 50 Hz
    actuation, chunk replans, [0, 2 pi) chunks). Returns the run's numbers:
    replans, plan latencies (the first plan's apart), commands delivered,
    the ticks run and those before the first chunk arrived, tick lateness
    and the plans whose chunk was not finite."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.data.pipeline import parse_guidance_spec
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_label
    from soccerdiffusion_tpu_torch.inference import make_chunk_sampler
    from soccerdiffusion_tpu_torch.inference.controller import (
        init_controller_state,
        make_controller_batch,
    )
    from soccerdiffusion_tpu_torch.inference.realtime import RealtimeController, SimulatedRobotIO
    from soccerdiffusion_tpu_torch.training.checkpoint import load_policy

    device = torch.device(args.device)
    # the step count a checkpoint serves at is the one `report` evaluates
    model, norm, ckpt_steps, distilled, params = load_policy(args.checkpoint, device)
    config = Config.from_dict(params)
    cfg = config.model
    steps = args.steps or ckpt_steps
    schedule = make_schedule(config.train.train_denoising_timesteps)
    g_scale, g_null = 1.0, ("image",)
    if args.guidance:
        try:
            g_scale, g_null = parse_guidance_spec(args.guidance)
        except ValueError as e:
            raise SystemExit(f"--guidance: {e}") from None
    sampler = make_chunk_sampler(model, schedule, norm, num_inference_steps=steps,
                                 distilled=distilled, solver=args.solver,
                                 guidance_scale=g_scale, guidance_null=g_null)
    label = "distilled1" if distilled else solver_label(args.solver, steps)
    if g_scale != 1.0:
        label += f"+cfg{g_scale:g}({','.join(g_null)})"
    logger.info(f"serving {args.checkpoint} [{label}] at {args.control_rate:g} Hz for "
                f"{args.duration:g}s on {device}")

    # warm the sampler before the loop, on a worker thread as the plans run:
    # its first call builds the kernels (minutes with nvcc), and a thread's
    # first cuBLAS call creates the handle and workspace that PyTorch keeps per
    # thread and hands on when the thread ends; neither may land in a plan
    warm = init_controller_state(cfg, batch_size=1, device=device)
    noise = torch.zeros((1, cfg.trajectory_prediction_length, cfg.num_joints), device=device)
    failed: list[BaseException] = []

    def warm_up():
        try:
            sampler(make_controller_batch(cfg, warm), noise)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except BaseException as exc:  # re-raised on the calling thread
            failed.append(exc)

    thread = threading.Thread(target=warm_up)
    thread.start()
    thread.join()
    if failed:
        raise failed[0]

    if args.udp:
        from soccerdiffusion_tpu_torch.inference.transport import UdpRobotIO

        io = UdpRobotIO(args.udp)
    else:
        io = SimulatedRobotIO(num_joints=cfg.num_joints)
    ctrl = RealtimeController(cfg, sampler, io, control_rate_hz=args.control_rate, seed=args.seed,
                              replan_every_ticks=args.replan_ticks, device=device)
    try:
        ctrl.run(duration_s=args.duration)
    finally:
        if args.udp:
            io.close()
    lat = sorted(ctrl.plan_latencies_ms)
    late = np.asarray(ctrl.tick_lateness_ms)
    pct = lambda x, q: float(np.percentile(x, q)) if len(x) else float("nan")
    return {
        "sampler": label,
        "replans": len(lat),
        "plan_ms": {"p50": lat[len(lat) // 2] if lat else float("nan"), "p95": pct(lat, 95),
                    "max": lat[-1] if lat else float("nan")},
        "first_plan_ms": ctrl.plan_latencies_ms[0] if lat else float("nan"),
        "commands_delivered": getattr(io, "commands_received", None),
        "ticks": len(late),
        "ticks_without_chunk": ctrl.ticks_without_chunk,
        "ticks_scheduled": int(round(args.duration * args.control_rate)),
        "tick_lateness_ms": {"p50": pct(late, 50), "p99": pct(late, 99)},
        "overruns": ctrl.overruns,
        "nonfinite_chunks": ctrl.nonfinite_chunks,
    }


def cmd_serve(args) -> int:
    stats = serve(args)
    delivered = stats["commands_delivered"]
    logger.info(
        f"served {stats['replans']} replans; plan p50 {stats['plan_ms']['p50']:.2f} ms, p95 "
        f"{stats['plan_ms']['p95']:.2f}, max {stats['plan_ms']['max']:.2f}, first "
        f"{stats['first_plan_ms']:.2f}; commands delivered: "
        f"{'n/a' if delivered is None else delivered} of {stats['ticks_scheduled']} ticks "
        f"({stats['ticks_without_chunk']} before the first chunk); tick "
        f"lateness p50 {stats['tick_lateness_ms']['p50']:.3f} ms, p99 "
        f"{stats['tick_lateness_ms']['p99']:.3f}; overruns {stats['overruns']}")
    return 0


def cmd_db(args) -> int:
    from soccerdiffusion_tpu_torch import DB_PATH
    from soccerdiffusion_tpu_torch.data.schema import connect, create_schema

    db = args.db or DB_PATH
    if args.db_command == "create-schema":
        conn = connect(db)
        try:
            create_schema(conn)
        finally:
            conn.close()  # checkpoints the WAL, so read-only opens see the schema
        logger.info(f"schema created at {db}")
        return 0
    if args.db_command == "dummy-data":
        from soccerdiffusion_tpu_torch.data.dummy import insert_dummy_data

        conn = connect(db)
        try:
            create_schema(conn)
            ids = insert_dummy_data(conn, args.num_recordings, args.num_samples, args.image_step)
        finally:
            conn.close()
        logger.info(f"inserted dummy recordings: {ids}")
        return 0
    if args.db_command == "migrate":
        from soccerdiffusion_tpu_torch.data.migrations import migrate, schema_version

        conn = connect(db)
        try:
            before = schema_version(conn)
            after = migrate(conn)
        finally:
            conn.close()
        logger.info(f"schema migrated: v{before} -> v{after}")
        return 0
    if args.db_command == "plot-window":
        from soccerdiffusion_tpu_torch.config import Config
        from soccerdiffusion_tpu_torch.data.plot import plot_window
        from soccerdiffusion_tpu_torch.training.train import build_dataset

        config = Config.from_yaml(args.config) if args.config else Config()
        dataset = build_dataset(config, args.seed, args.dummy_data, db=args.db)
        if not 0 <= args.index < len(dataset):
            logger.error(f"window index {args.index} out of range (dataset has {len(dataset)})")
            return 1
        try:
            out = plot_window(dataset[args.index], config.model, args.output)
        except ImportError as exc:
            logger.error(str(exc))
            return 1
        logger.info(f"wrote {out}")
        return 0
    if args.db_command == "recording2mcap":
        from soccerdiffusion_tpu_torch.ingest.recording2mcap import recording2mcap

        try:
            recording2mcap(db, args.recording_id, args.output)
        except (ImportError, ValueError) as exc:
            logger.error(str(exc))
            return 1
        return 0
    return 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if argv and argv[0] in DELEGATED:
        import importlib

        importlib.import_module(DELEGATED[argv[0]]).main(argv[1:])
        return 0
    args = build_parser().parse_args(argv)
    if args.command == "import":
        return cmd_import(args)
    if args.command == "pack":
        return cmd_pack(args)
    if args.command == "db":
        return cmd_db(args)
    if args.command == "serve":
        return cmd_serve(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
