"""The port's UDP robot bridge against the JAX package's: the wire format
byte for byte, a port driver against a JAX robot-side server on loopback
and the reverse, the stats request, and the standalone robot process."""

import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from soccerdiffusion_tpu.inference import transport as jtransport
from soccerdiffusion_tpu.inference.realtime import SimulatedRobotIO as JaxPlant
from soccerdiffusion_tpu_torch.inference import transport
from soccerdiffusion_tpu_torch.inference.realtime import SimulatedRobotIO

REPO = Path(__file__).resolve().parent.parent
J = 20


@pytest.mark.parametrize("imu_dim", [4, 5])
def test_wire_format_is_the_jax_packages(imu_dim):
    rng = np.random.default_rng(imu_dim)
    joints = rng.uniform(-np.pi, np.pi, J).astype(np.float32)
    imu = rng.normal(size=imu_dim)  # float64: both packages send float32
    obs = transport.encode_observation(7, joints, imu, 3)
    assert obs == jtransport.encode_observation(7, joints, imu, 3)
    assert len(obs) == 11 + 4 * (J + imu_dim)
    seq, j, i, gs = transport.decode_observation(obs)
    assert (seq, gs) == (7, 3)
    np.testing.assert_array_equal(j, joints)
    np.testing.assert_array_equal(i, imu.astype(np.float32))
    cmd = transport.encode_command(2**32 - 1, joints)
    assert cmd == jtransport.encode_command(2**32 - 1, joints)
    seq, c = jtransport.decode_command(cmd)
    assert seq == 2**32 - 1
    np.testing.assert_array_equal(c, transport.decode_command(cmd)[1])
    assert transport._STATS.pack(b"S", 5) == jtransport._STATS.pack(b"S", 5) == b"S\x05\x00\x00\x00"


def drive(io_cls, server_cls, plant):
    """A driver of ``io_cls`` against a robot-side ``server_cls`` on
    loopback: connect, send 10 commands at ~50 Hz, read the plant's state
    back and the server's command count."""
    server = server_cls(plant, "127.0.0.1:0", rate_hz=100.0)
    host, port = server.local_addr
    th = threading.Thread(target=server.serve, args=(None, 30.0), daemon=True)
    th.start()
    io = io_cls(f"{host}:{port}", timeout_s=5.0)
    try:
        assert io.wait_connected()
        command = np.linspace(-1.0, 1.0, J).astype(np.float32)
        for _ in range(10):
            io.write_command(command)
            time.sleep(0.02)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and server.commands_received < 10:
            time.sleep(0.02)
        stats = None
        for _ in range(5):  # a reply can be late on a loaded machine
            stats = io.request_stats()
            if stats is not None:
                break
        time.sleep(0.1)  # the next observations carry the moved plant
        state = io.read_joint_state()
        return stats, server.commands_received, state, io.read_imu(), io.read_game_state(), command
    finally:
        io.close()
        server._stop.set()
        th.join(timeout=5.0)
        server.close()


@pytest.mark.parametrize("driver,robot", [("port", "jax"), ("jax", "port")])
def test_driver_against_the_other_packages_server(driver, robot):
    io_cls = transport.UdpRobotIO if driver == "port" else jtransport.UdpRobotIO
    server_cls = transport.UdpRobotServer if robot == "port" else jtransport.UdpRobotServer
    plant = SimulatedRobotIO(J) if robot == "port" else JaxPlant(J)
    stats, received, state, imu, gs, command = drive(io_cls, server_cls, plant)
    assert received == 10 and stats == 10
    assert plant.commands_received == 10
    np.testing.assert_allclose(plant.positions, command * (1 - 0.5 ** 10), rtol=1e-6)
    np.testing.assert_allclose(state, plant.positions, rtol=1e-6)
    np.testing.assert_array_equal(imu, [0, 0, 0, 1])
    assert gs == 2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_standalone_robot_process():
    """``python -m soccerdiffusion_tpu_torch.inference.transport`` serves a
    simulated plant of ``--joints`` joints to a driver of either package."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "soccerdiffusion_tpu_torch.inference.transport", "--listen",
         f"127.0.0.1:{port}", "--joints", str(J), "--duration", "6"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        io = jtransport.UdpRobotIO(f"127.0.0.1:{port}", timeout_s=30.0)
        try:
            assert io.wait_connected()
            assert io.read_joint_state().shape == (J,)
            for _ in range(5):
                io.write_command(np.ones(J, np.float32))
                time.sleep(0.02)
            time.sleep(0.2)
            assert any(io.request_stats() == 5 for _ in range(5))
        finally:
            io.close()
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    assert "commands_received=5" in out
