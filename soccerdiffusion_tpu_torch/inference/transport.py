"""Out-of-process RobotIO transport: a UDP datagram bridge (counterpart of
``soccerdiffusion_tpu/inference/transport.py``, byte for byte the same wire
format, so a driver of either package works against a robot-side server of
the other).

The reference deploys through ROS 2 publish / subscribe between the
inference node and the robot. Here a driver-side ``UdpRobotIO`` exchanges
50 Hz observation / command datagrams with a robot-side ``UdpRobotServer``
that wraps any plant. The module is numpy and sockets only.

Wire format (little-endian, one datagram per message, no fragmentation —
proprioceptive payloads are < 200 bytes):

  observation  'O' | u32 seq | u8 J | u8 imu_dim | i32 game_state
               | J f32 joints | imu_dim f32 imu
  command      'C' | u32 seq | u8 J | J f32 command
  stats        'S' | u32 commands_received   (server -> driver on request)
  stats_req    'Q'

Reads return the latest observation (a stale read returns the same
values, as the reference's latest-message-per-topic buffers do). Packets
are fire-and-forget, like ROS's best-effort QoS; sequence numbers let the
receiver drop reordered datagrams.

Robot-side standalone entry point (a separate process):

  python -m soccerdiffusion_tpu_torch.inference.transport --listen 127.0.0.1:9900
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("soccerdiffusion_tpu_torch")

_OBS_HDR = struct.Struct("<cIBBi")  # type, seq, J, imu_dim, game_state
_CMD_HDR = struct.Struct("<cIB")  # type, seq, J
_STATS = struct.Struct("<cI")


def encode_observation(seq: int, joints: np.ndarray, imu: np.ndarray,
                       game_state: int) -> bytes:
    return (_OBS_HDR.pack(b"O", seq, len(joints), len(imu), game_state)
            + np.asarray(joints, np.float32).tobytes()
            + np.asarray(imu, np.float32).tobytes())


def decode_observation(data: bytes):
    typ, seq, j, imu_dim, gs = _OBS_HDR.unpack_from(data)
    assert typ == b"O"
    off = _OBS_HDR.size
    joints = np.frombuffer(data, np.float32, count=j, offset=off)
    imu = np.frombuffer(data, np.float32, count=imu_dim, offset=off + 4 * j)
    return seq, joints.copy(), imu.copy(), gs


def encode_command(seq: int, command: np.ndarray) -> bytes:
    return (_CMD_HDR.pack(b"C", seq, len(command))
            + np.asarray(command, np.float32).tobytes())


def decode_command(data: bytes):
    typ, seq, j = _CMD_HDR.unpack_from(data)
    assert typ == b"C"
    return seq, np.frombuffer(data, np.float32, count=j,
                              offset=_CMD_HDR.size).copy()


def _parse_addr(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


class UdpRobotIO:
    """Driver-side RobotIO over UDP: a receive thread keeps the latest
    observation; ``write_command`` sends one datagram per command."""

    def __init__(self, robot_addr: str, listen_addr: str = "127.0.0.1:0",
                 timeout_s: float = 30.0):
        self.robot_addr = _parse_addr(robot_addr)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(_parse_addr(listen_addr))
        self.sock.settimeout(0.2)
        self.local_addr = self.sock.getsockname()
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._latest: Optional[tuple[np.ndarray, np.ndarray, int]] = None
        self._last_seq = -1
        self._cmd_seq = 0
        self._last_stats: Optional[int] = None
        self.observations_received = 0
        self._stop = threading.Event()
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._rx.start()

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            if data[0:1] == b"O":
                seq, joints, imu, gs = decode_observation(data)
                if seq <= self._last_seq:
                    continue  # a reordered datagram
                self._last_seq = seq
                with self._lock:
                    self._latest = (joints, imu, gs)
                    self.observations_received += 1
            elif data[0:1] == b"S":
                self._last_stats = _STATS.unpack_from(data)[1]

    def wait_connected(self) -> bool:
        """Block until the first observation arrives (or timeout). Pings the
        server so it learns this driver's address and starts streaming."""
        deadline = time.monotonic() + self.timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._latest is not None:
                    return True
            self.sock.sendto(_STATS.pack(b"Q", 0), self.robot_addr)
            time.sleep(0.05)
        return False

    # ------------------------------------------------------- RobotIO seam

    def read_joint_state(self) -> Optional[np.ndarray]:
        with self._lock:
            return None if self._latest is None else self._latest[0]

    def read_imu(self) -> Optional[np.ndarray]:
        with self._lock:
            return None if self._latest is None else self._latest[1]

    def read_image(self) -> Optional[np.ndarray]:
        return None  # camera frames ride a separate transport in deployment

    def read_game_state(self) -> Optional[int]:
        with self._lock:
            return None if self._latest is None else self._latest[2]

    def write_command(self, command: np.ndarray) -> None:
        self._cmd_seq += 1
        self.sock.sendto(encode_command(self._cmd_seq, command), self.robot_addr)

    def request_stats(self) -> Optional[int]:
        """Ask the server for its commands_received count (the receive
        thread consumes the reply; this polls for it)."""
        self._last_stats = None
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            self.sock.sendto(_STATS.pack(b"Q", 0), self.robot_addr)
            time.sleep(0.05)
            if self._last_stats is not None:
                return self._last_stats
        return None

    def close(self) -> None:
        self._stop.set()
        self.sock.close()
        self._rx.join(timeout=1.0)


class UdpRobotServer:
    """Robot-side bridge: applies incoming commands to a plant and streams
    its observations to the driver at ``rate_hz`` (the role the reference's
    robot-side ROS stack plays opposite the inference node)."""

    def __init__(self, plant, listen_addr: str = "127.0.0.1:0",
                 rate_hz: float = 50.0):
        self.plant = plant
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(_parse_addr(listen_addr))
        self.sock.settimeout(0.2)
        self.local_addr = self.sock.getsockname()
        self.rate_hz = rate_hz
        self.commands_received = 0
        self._driver_addr = None
        self._stop = threading.Event()
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._rx.start()

    def _recv_loop(self) -> None:
        last_cmd_seq = -1
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            if data[0:1] == b"C":
                seq, command = decode_command(data)
                if seq <= last_cmd_seq:
                    continue
                last_cmd_seq = seq
                self._driver_addr = addr
                self.commands_received += 1
                self.plant.write_command(command)
            elif data[0:1] == b"Q":
                # a ping doubles as the driver's address discovery
                self._driver_addr = addr
                self.sock.sendto(_STATS.pack(b"S", self.commands_received), addr)

    def serve(self, driver_addr: str | None, duration_s: float) -> None:
        """Stream observations for ``duration_s`` (blocking)."""
        target = _parse_addr(driver_addr) if driver_addr else None
        period = 1.0 / self.rate_hz
        seq = 0
        start = time.monotonic()
        next_tick = start
        while not self._stop.is_set() and time.monotonic() - start < duration_s:
            dest = target or self._driver_addr
            if dest is not None:
                seq += 1
                self.sock.sendto(
                    encode_observation(
                        seq, self.plant.read_joint_state(),
                        self.plant.read_imu(), self.plant.read_game_state()),
                    dest)
            next_tick += period
            delay = next_tick - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        # linger so that a final stats request is still answered
        time.sleep(0.3)

    def close(self) -> None:
        self._stop.set()
        self.sock.close()
        self._rx.join(timeout=1.0)


def main(argv=None) -> int:
    """Standalone robot-process entry point (simulated plant)."""
    import argparse

    from soccerdiffusion_tpu_torch.inference.realtime import SimulatedRobotIO

    parser = argparse.ArgumentParser(description="UDP robot bridge (simulated plant)")
    parser.add_argument("--listen", default="127.0.0.1:9900")
    parser.add_argument("--driver", default=None,
                        help="driver addr host:port; default: reply to the "
                             "first command's source")
    parser.add_argument("--joints", type=int, default=8)
    parser.add_argument("--imu-dim", type=int, default=4)
    parser.add_argument("--rate", type=float, default=50.0)
    parser.add_argument("--duration", type=float, default=10.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    plant = SimulatedRobotIO(num_joints=args.joints, imu_dim=args.imu_dim)
    server = UdpRobotServer(plant, args.listen, args.rate)
    logger.info(f"robot bridge on {server.local_addr}, plant J={args.joints}")
    try:
        server.serve(args.driver, args.duration)
    finally:
        n = server.commands_received
        server.close()
    print(f"commands_received={n}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
