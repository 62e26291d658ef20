"""Tiny-tier example: rosbag -> CSV joint-command extractor (counterpart of
``examples/fetch_data.py``).

The reference's preliminary data fetcher (ml/preliminary/fetch_data.py,
SURVEY.md §2.8): pull the raw ``bitbots_msgs/JointCommand`` stream for the
12 leg joints out of an mcap bag into a flat CSV, the input format of the
preliminary robot-gait scripts (``preliminary_context_robot --csv``). Where
the reference drives rosbag2_py + deserialize_message (fetch_data.py:27-60),
this reads the bag with the port's MCAP container reader and CDR decoder
(``ingest/mcap_io.py``): no ROS installation needed. ``--device`` is
accepted as by every example (nothing here runs on a device).

  python -m soccerdiffusion_tpu_torch.examples.fetch_data tests/fixtures/bitbots_synth.mcap -o legs.csv
"""

from __future__ import annotations

import argparse
import csv

from soccerdiffusion_tpu_torch.examples import resolve_device

# the reference considers only the legs ("they come together and we need
# no interpolation", fetch_data.py:10-24); same 12 names, same order
LEG_JOINT_NAMES = [
    "LHipYaw", "LHipRoll", "LHipPitch", "LKnee", "LAnklePitch", "LAnkleRoll",
    "RHipYaw", "RHipRoll", "RHipPitch", "RKnee", "RAnklePitch", "RAnkleRoll",
]


def fetch(bag_path: str, topic: str, joints: list[str]) -> list[dict]:
    """All joint-command rows on ``topic``: [{timestamp_ns, <joint>: rad}]."""
    from soccerdiffusion_tpu_torch.ingest.mcap_io import McapReader, decode_cdr

    reader = McapReader.from_file(bag_path)
    if topic not in {c.topic for c in reader.channels.values()}:
        raise SystemExit(
            f"topic {topic} not found in the bag "
            f"(has: {sorted(c.topic for c in reader.channels.values())})")
    rows = []
    for channel, schema, message in reader.iter_messages(topics=[topic]):
        msg = decode_cdr(schema.data.decode(), schema.name, message.data)
        by_name = dict(zip(msg.joint_names, msg.positions))
        missing = [j for j in joints if j not in by_name]
        if missing:
            raise SystemExit(f"message lacks joints {missing}; "
                             f"has {sorted(by_name)}")
        row = {"timestamp_ns": message.publish_time}
        row.update({j: by_name[j] for j in joints})
        rows.append(row)
    rows.sort(key=lambda r: r["timestamp_ns"])
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Extract joint-command CSV from an mcap bag")
    parser.add_argument("bag", type=str, help="path to the .mcap recording")
    parser.add_argument("--output", "-o", type=str, default="joint_commands.csv")
    parser.add_argument("--topic", type=str, default="/DynamixelController/command")
    parser.add_argument("--joints", type=str, nargs="*", default=LEG_JOINT_NAMES,
                        help="joint columns to extract (default: the reference's 12 leg joints)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    rows = fetch(args.bag, args.topic, args.joints)
    if not rows:
        raise SystemExit(f"no messages on {args.topic}")
    with open(args.output, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["timestamp_ns"] + args.joints)
        writer.writeheader()
        writer.writerows(rows)
    span_s = (rows[-1]["timestamp_ns"] - rows[0]["timestamp_ns"]) / 1e9
    print(f"wrote {len(rows)} rows x {len(args.joints)} joints "
          f"({span_s:.1f} s) -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
