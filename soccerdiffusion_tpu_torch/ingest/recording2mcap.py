"""Export a recording from SQLite back into a ROS 2-typed ``.mcap`` file
(counterpart of ``soccerdiffusion_tpu/ingest/recording2mcap.py``; the same
bytes for the same database).

Counterpart of reference dataset/recording2mcap.py:76-299, WITHOUT the ROS 2
stack: where the reference drives rosbag2_py + rclpy.serialize_message, this
writes the same typed channels through the vendored MCAP writer and CDR
encoder (ingest/mcap_io.py), so the output is consumable by rosbag2/
Foxglove-ROS AND round-trips through our own reader + schema-driven decoder
(tests/test_recording2mcap.py). Channel map (types as the reference
registers them):

* ``/recording``        std_msgs/msg/String      — JSON recording info at t=0
* ``/image``            sensor_msgs/msg/Image    — rgb8, frame camera_optical
* ``/rotation``         geometry_msgs/msg/Quaternion
* ``/rotation/euler``   geometry_msgs/msg/Vector3 — sxyz euler for plotting
* ``/joint_states``     sensor_msgs/msg/JointState — frame base_link
* ``/joint_commands``   sensor_msgs/msg/JointState
* ``/game_state``       std_msgs/msg/String

One deliberate difference: joints are exported under this schema's 22
canonical names (incl. the NAO elbow-yaw pair, data/migrations.py) instead
of the reference's literal 20 (recording2mcap.py:200-221) — a superset, so
reference-era consumers still find every name they expect.
"""

from __future__ import annotations

import logging
import json
import math
from pathlib import Path
from types import SimpleNamespace

from soccerdiffusion_tpu_torch.config import CANONICAL_JOINT_NAMES_22
from soccerdiffusion_tpu_torch.data.schema import connect
from soccerdiffusion_tpu_torch.ingest import ros2_schemas as sch
from soccerdiffusion_tpu_torch.ingest.mcap_io import McapWriter, encode_cdr

logger = logging.getLogger("soccerdiffusion_tpu_torch")


def _quat_to_euler(x: float, y: float, z: float, w: float) -> tuple[float, float, float]:
    """xyzw quaternion -> sxyz roll/pitch/yaw (reference uses
    transforms3d.quat2euler(axes='sxyz'), recording2mcap.py:173)."""
    sinr = 2 * (w * x + y * z)
    cosr = 1 - 2 * (x * x + y * y)
    roll = math.atan2(sinr, cosr)
    sinp = max(-1.0, min(1.0, 2 * (w * y - z * x)))
    pitch = math.asin(sinp)
    siny = 2 * (w * z + x * y)
    cosy = 1 - 2 * (y * y + z * z)
    yaw = math.atan2(siny, cosy)
    return roll, pitch, yaw


def _stamp_ns(stamp_s: float) -> int:
    return int(round(stamp_s * 1e9))


def _header(stamp_s: float, frame_id: str) -> SimpleNamespace:
    ns = _stamp_ns(stamp_s)
    return SimpleNamespace(
        stamp=SimpleNamespace(sec=ns // 1_000_000_000,
                              nanosec=ns % 1_000_000_000),
        frame_id=frame_id,
    )


def recording2mcap(db_path: str | Path, recording_id: int, output: str | Path) -> None:
    conn = connect(db_path, read_only=True)
    cur = conn.cursor()
    rec = cur.execute(
        "SELECT original_file, team_name, team_color, robot_type, location,"
        " simulated, img_width, img_height, allow_public, start_time,"
        " img_width_scaling, img_height_scaling"
        " FROM Recording WHERE _id=?",
        (recording_id,),
    ).fetchone()
    if rec is None:
        raise ValueError(f"recording {recording_id} not found")

    counts = {
        t: cur.execute(
            f"SELECT COUNT(*) FROM {t} WHERE recording_id=?",  # noqa: S608
            (recording_id,)).fetchone()[0]
        for t in ("Image", "Rotation", "JointStates", "JointCommands",
                  "GameState")
    }

    with open(output, "wb") as f:
        writer = McapWriter(f, profile="ros2")
        writer.start()

        def channel(topic: str, type_name: str, schema_text: str) -> int:
            schema = writer.register_schema(
                name=type_name, encoding="ros2msg", data=schema_text.encode())
            return writer.register_channel(
                topic=topic, message_encoding="cdr", schema_id=schema)

        channels = {
            "/recording": channel("/recording", "std_msgs/msg/String",
                                  sch.STRING_SCHEMA),
            "/image": channel("/image", "sensor_msgs/msg/Image",
                              sch.IMAGE_SCHEMA),
            "/rotation": channel("/rotation", "geometry_msgs/msg/Quaternion",
                                 sch.QUATERNION_SCHEMA),
            "/rotation/euler": channel("/rotation/euler",
                                       "geometry_msgs/msg/Vector3",
                                       sch.VECTOR3_SCHEMA),
            "/joint_states": channel("/joint_states",
                                     "sensor_msgs/msg/JointState",
                                     sch.JOINT_STATE_SCHEMA),
            "/joint_commands": channel("/joint_commands",
                                       "sensor_msgs/msg/JointState",
                                       sch.JOINT_STATE_SCHEMA),
            "/game_state": channel("/game_state", "std_msgs/msg/String",
                                   sch.STRING_SCHEMA),
        }
        schemas = {
            "/recording": ("std_msgs/msg/String", sch.STRING_SCHEMA),
            "/image": ("sensor_msgs/msg/Image", sch.IMAGE_SCHEMA),
            "/rotation": ("geometry_msgs/msg/Quaternion",
                          sch.QUATERNION_SCHEMA),
            "/rotation/euler": ("geometry_msgs/msg/Vector3",
                                sch.VECTOR3_SCHEMA),
            "/joint_states": ("sensor_msgs/msg/JointState",
                              sch.JOINT_STATE_SCHEMA),
            "/joint_commands": ("sensor_msgs/msg/JointState",
                                sch.JOINT_STATE_SCHEMA),
            "/game_state": ("std_msgs/msg/String", sch.STRING_SCHEMA),
        }

        def publish(topic: str, stamp_s: float, msg: SimpleNamespace) -> None:
            type_name, schema_text = schemas[topic]
            ns = _stamp_ns(stamp_s)
            writer.add_message(
                channels[topic], log_time=ns, publish_time=ns,
                data=encode_cdr(schema_text, type_name, msg),
            )

        # recording info at t=0 (reference recording2mcap.py:90-115)
        publish("/recording", 0.0, SimpleNamespace(data=json.dumps({
            "id": recording_id,
            "allow_public": bool(rec[8]),
            "original_file": rec[0],
            "team_name": rec[1],
            "team_color": rec[2],
            "robot_type": rec[3],
            "start_time": str(rec[9]),
            "location": rec[4],
            "simulated": bool(rec[5]),
            "img_width": int(rec[6]),
            "img_height": int(rec[7]),
            "img_width_scaling": rec[10],
            "img_height_scaling": rec[11],
            "num_images": counts["Image"],
            "num_rotations": counts["Rotation"],
            "num_joint_states": counts["JointStates"],
            "num_joint_commands": counts["JointCommands"],
            "num_game_states": counts["GameState"],
        })))

        w, h = int(rec[6]), int(rec[7])
        for stamp, data in cur.execute(
            "SELECT stamp, data FROM Image WHERE recording_id=? ORDER BY stamp",
            (recording_id,),
        ):
            publish("/image", stamp, SimpleNamespace(
                header=_header(stamp, "camera_optical"),
                height=h, width=w, encoding="rgb8", is_bigendian=0,
                step=w * 3, data=bytes(data),
            ))

        for stamp, x, y, z, qw in cur.execute(
            "SELECT stamp, x, y, z, w FROM Rotation WHERE recording_id=?"
            " ORDER BY stamp",
            (recording_id,),
        ):
            publish("/rotation", stamp,
                    SimpleNamespace(x=x, y=y, z=z, w=qw))
            roll, pitch, yaw = _quat_to_euler(x, y, z, qw)
            publish("/rotation/euler", stamp,
                    SimpleNamespace(x=roll, y=pitch, z=yaw))

        joint_cols = ", ".join(f'"{n}"' for n in CANONICAL_JOINT_NAMES_22)
        names = list(CANONICAL_JOINT_NAMES_22)
        zeros = [0.0] * len(names)
        for table, topic in (("JointStates", "/joint_states"),
                             ("JointCommands", "/joint_commands")):
            for row in cur.execute(
                f"SELECT stamp, {joint_cols} FROM {table}"  # noqa: S608
                " WHERE recording_id=? ORDER BY stamp",
                (recording_id,),
            ):
                publish(topic, row[0], SimpleNamespace(
                    header=_header(row[0], "base_link"),
                    name=names,
                    position=[float(v) if v is not None else 0.0
                              for v in row[1:]],
                    velocity=zeros, effort=zeros,
                ))

        for stamp, state in cur.execute(
            "SELECT stamp, state FROM GameState WHERE recording_id=?"
            " ORDER BY stamp",
            (recording_id,),
        ):
            # reference writes the raw state string (recording2mcap.py:295)
            publish("/game_state", stamp, SimpleNamespace(data=state))

        writer.finish()
    logger.info(f"wrote {output}")
