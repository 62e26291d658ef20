"""ros2msg schema texts for the typed mcap EXPORT channels (counterpart of
``soccerdiffusion_tpu/ingest/ros2_schemas.py``).

The export side of the vendored MCAP/CDR codec (ingest/mcap_io.py): these
are the message definitions a rosbag2/Foxglove-ROS consumer resolves the
CDR payloads against, matching the types the reference's rosbag2-based
exporter registers (reference dataset/recording2mcap.py:76-299 —
std_msgs/String, sensor_msgs/Image, sensor_msgs/JointState,
geometry_msgs/Quaternion, geometry_msgs/Vector3). The concatenated-block
format (root block first, nested blocks after an 80-char ``=`` separator
with a ``MSG:`` line) is the one mcap_ros2 emits and
mcap_io.parse_ros2_schema consumes, so exports round-trip through our own
reader (tests/test_recording2mcap.py).
"""

_SEP = "=" * 80 + "\n"

HEADER_BLOCK = (
    _SEP
    + "MSG: std_msgs/Header\n"
    "builtin_interfaces/Time stamp\n"
    "string frame_id\n"
    + _SEP
    + "MSG: builtin_interfaces/Time\n"
    "int32 sec\n"
    "uint32 nanosec\n"
)

STRING_SCHEMA = "string data\n"

QUATERNION_SCHEMA = (
    "float64 x\n"
    "float64 y\n"
    "float64 z\n"
    "float64 w\n"
)

VECTOR3_SCHEMA = (
    "float64 x\n"
    "float64 y\n"
    "float64 z\n"
)

IMAGE_SCHEMA = (
    "std_msgs/Header header\n"
    "uint32 height\n"
    "uint32 width\n"
    "string encoding\n"
    "uint8 is_bigendian\n"
    "uint32 step\n"
    "uint8[] data\n"
) + HEADER_BLOCK

JOINT_STATE_SCHEMA = (
    "std_msgs/Header header\n"
    "string[] name\n"
    "float64[] position\n"
    "float64[] velocity\n"
    "float64[] effort\n"
) + HEADER_BLOCK
