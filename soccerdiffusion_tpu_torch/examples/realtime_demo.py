"""Closed-loop realtime serving demo (counterpart of
``examples/realtime_demo.py``): the reference's deployment story
(ml/inference/ros.py driving a robot at 50 Hz with 200 ms replans) without
ROS, through a transport-agnostic ``RobotIO`` and the port's
``RealtimeController``.

Trains nothing: builds a small proprioceptive policy from flax's
initialisers, then runs the 50 Hz control loop against the built-in
simulated plant for two seconds of virtual time (deterministic: no
wall-clock sleeps), replanning every 200 ms. Prints the commands delivered
and the replans.

  python -m soccerdiffusion_tpu_torch.examples.realtime_demo [--udp] [--device cpu]

With ``--udp`` the plant runs in a separate process behind the UDP bridge
(``inference/transport.py``) and the loop runs on the wall clock, the plan
in a thread beside it: the driver / robot process split of the reference's
inference-node / robot pub-sub deployment (ros.py:60-67,
trajectory_player.py:25-33).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from soccerdiffusion_tpu_torch.config import ModelConfig
from soccerdiffusion_tpu_torch.data import Normalizer
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.examples import resolve_device
from soccerdiffusion_tpu_torch.inference import make_chunk_sampler
from soccerdiffusion_tpu_torch.inference.controller import (
    init_controller_state,
    make_controller_batch,
)
from soccerdiffusion_tpu_torch.inference.realtime import RealtimeController, SimulatedRobotIO
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

REPO = Path(__file__).resolve().parents[2]


class VirtualClock:
    """Deterministic clock: sleep() advances time instead of waiting."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(dt, 0.0)


def build_policy(device: torch.device):
    """(config, the 5-step DDIM chunk sampler) of the demo's policy on ``device``."""
    cfg = ModelConfig(
        num_joints=8, hidden_dim=32, trajectory_prediction_length=10,
        action_context_length=20, joint_state_context_length=20,
        imu_context_length=20, use_images=False, use_gamestate=True,
        num_action_history_encoder_layers=1, num_imu_encoder_layers=1,
        joint_state_encoder_layers=1, num_decoder_layers=1,
    )
    model = DiffusionPolicy(cfg)
    model = load_jax_params(model, *flax_init_params(model, 0)).to(device)
    sampler = make_chunk_sampler(model, make_schedule(100), Normalizer.identity(cfg.num_joints),
                                 num_inference_steps=5)
    return cfg, sampler


def free_udp_port() -> int:
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def run_udp(device: torch.device, duration_s: float = 2.0) -> int:
    """Two-process mode: simulated robot behind the UDP bridge."""
    from soccerdiffusion_tpu_torch.inference.transport import UdpRobotIO

    cfg, sampler = build_policy(device)
    robot_port = free_udp_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "soccerdiffusion_tpu_torch.inference.transport",
         "--listen", f"127.0.0.1:{robot_port}", "--joints", str(cfg.num_joints),
         "--duration", str(duration_s + 10.0)],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)},
    )
    try:
        io = UdpRobotIO(f"127.0.0.1:{robot_port}")
        try:
            if not io.wait_connected():
                raise RuntimeError("no observations from the robot process")
            # run the sampler once BEFORE the wall-clock loop starts, so the
            # first 200 ms replan slot is not spent in first-call set-up
            warm = make_controller_batch(cfg, init_controller_state(cfg, 1, device=device))
            sampler(warm, torch.zeros((1, cfg.trajectory_prediction_length, cfg.num_joints),
                                      device=device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ctl = RealtimeController(cfg, sampler, io, plan_in_thread=True, device=device)
            ctl.run(duration_s=duration_s)
            delivered = io._cmd_seq
            received = io.request_stats()
            observations = io.observations_received
        finally:
            io.close()
    finally:
        server.terminate()
        out = server.communicate(timeout=10)[0]
    lat = ctl.plan_latencies_ms
    print(f"[udp] observations received by driver: {observations}")
    print(f"[udp] commands sent: {delivered}; received by robot process: "
          f"{received} (server stdout: {out.strip()!r})")
    if lat:
        print(f"[udp] replans: {len(lat)}, plan latency p50 "
              f"{np.median(lat):.1f} ms, max {max(lat):.1f} ms")
    # Gate on the process boundary being proven: observations streaming
    # in at a real rate, commands crossing to the robot process nearly
    # losslessly, and multiple replans completing. (Absolute command
    # counts depend on host load: the first plan can overrun a tick.)
    ok = (observations >= duration_s * 25 and received is not None
          and delivered >= 10 and received >= 0.8 * delivered
          and len(lat) >= 3)
    print("REALTIME UDP DEMO PASSED" if ok else "REALTIME UDP DEMO FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Closed-loop 50 Hz serving demo")
    parser.add_argument("--udp", action="store_true",
                        help="run the plant in a separate process over UDP")
    parser.add_argument("--duration", type=float, default=2.0)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.udp:
        return run_udp(device, args.duration)

    cfg, sampler = build_policy(device)
    io = SimulatedRobotIO(num_joints=cfg.num_joints)
    clock = VirtualClock()
    ctl = RealtimeController(cfg, sampler, io, clock=clock.now, sleep_fn=clock.sleep,
                             plan_in_thread=False, device=device)
    ctl.run(duration_s=args.duration)

    expected = int(args.duration * 50)
    print(f"commands delivered: {io.commands_received} "
          f"(expected ~{expected} at 50 Hz over 2 s virtual time)")
    lat = ctl.plan_latencies_ms
    # latencies are measured on the injected clock (virtual here), so the
    # count (one per 200 ms period) is the meaningful signal
    print(f"replans: {len(lat)} (every {cfg.trajectory_prediction_length} "
          f"ticks = 200 ms)")
    print(f"final joint positions: {np.round(io.positions, 3)}")
    ok = io.commands_received >= expected - 5 and len(lat) >= 8
    print("REALTIME DEMO PASSED" if ok else "REALTIME DEMO FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
