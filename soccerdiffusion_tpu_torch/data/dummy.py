"""Synthetic recordings as numpy arrays (counterpart of
``generate_dummy_arrays`` in ``soccerdiffusion_tpu/data/dummy.py``).

Same draws from the same ``numpy`` generator as the JAX package, so a seed
gives bit-identical arrays. The "decorative" task: per recording, sinusoid
joint commands and joint states shifted by +pi, sinusoid pseudo-quaternions,
uniform game states, and the image stamps of a 10-tick cadence with, when
``with_images``, procedural test-pattern frames. The "vision" task: each
frame previews the next interval's joint target as a bar position, so the
camera carries the signal. Frames are pure numpy RGB8 at ``image_size``.
``insert_dummy_data`` writes the SQLite tier: per recording a row of
``Recording`` and the decorative task's series and frames, the same rows as
the JAX package for a seed.
"""

from __future__ import annotations

import math
import sqlite3
from dataclasses import dataclass

import numpy as np

from soccerdiffusion_tpu_torch.config import CANONICAL_JOINT_NAMES_22
from soccerdiffusion_tpu_torch.data.schema import RobotState, TeamColor


def _sinusoid_joints(n: int, num_joints: int, rng: np.random.Generator, speed: float = 0.2) -> np.ndarray:
    """sin(speed * i + offset_j) + pi per joint, inside [0, 2 pi)."""
    offsets = rng.random(num_joints)
    i = np.arange(n, dtype=np.float64)[:, None]
    return (np.sin(speed * i + offsets[None, :]) + math.pi).astype(np.float32)


def _sinusoid_rotations(n: int, rng: np.random.Generator, speed: float = 0.1) -> np.ndarray:
    """Per-component sinusoids in [-1, 1] (deliberately not unit quaternions)."""
    shifts = rng.random(4)
    i = np.arange(n, dtype=np.float64)[:, None]
    return np.sin(i * speed + shifts[None, :]).astype(np.float32)


def _draw_test_image(width: int, height: int, timestamp: float) -> np.ndarray:
    """Procedural RGB8 test pattern: coloured quadrants, a white centre
    disc and a time-varying dot."""
    img = np.zeros((height, width, 3), dtype=np.uint8)
    img[: height // 2, : width // 2] = (0, 0, 255)  # blue quadrant (RGB)
    img[height // 2:, width // 2:] = (255, 0, 0)  # red quadrant
    yy, xx = np.mgrid[0:height, 0:width]
    center = ((yy - height / 2) ** 2 + (xx - width / 2) ** 2) ** 0.5
    img[center < 50] = (255, 255, 255)
    img[center < 25] = (int(255 * (1 + math.sin(timestamp)) / 2),
                        int(255 * (1 + math.cos(timestamp)) / 2), 0)
    return img


def _draw_cue_image(width: int, height: int, u: float) -> np.ndarray:
    """RGB8 cue frame of the "vision" task: a green vertical bar on a dim
    field whose horizontal position encodes ``u`` in [-1, 1]."""
    img = np.full((height, width, 3), 40, dtype=np.uint8)
    img[height // 2 - 1: height // 2 + 1] = 70  # faint horizon for texture
    bar_w = max(2, width // 12)
    cx = int(round((float(u) + 1.0) / 2.0 * (width - bar_w)))
    img[:, cx: cx + bar_w] = (0, 255, 0)
    return img


def _stamps_f32_floor(tick_indices: np.ndarray, sampling_rate: int) -> np.ndarray:
    """Largest float32 <= tick / rate."""
    exact = tick_indices / sampling_rate
    stamps = exact.astype(np.float32)
    return np.where(stamps.astype(np.float64) > exact,
                    np.nextafter(stamps, np.float32(-np.inf)), stamps)


@dataclass
class DummyRecording:
    joint_commands: np.ndarray  # (n, J) float32, [0, 2pi)
    joint_states: np.ndarray  # (n, J) float32, [0, 2pi)
    rotations: np.ndarray  # (n, 4) float32 xyzw
    game_states: np.ndarray  # (n,) int32 in [0, 4)
    image_stamps: np.ndarray  # (n_img,) float32 seconds
    images: np.ndarray | None = None  # (n_img, H, W, 3) uint8
    # the "vision" task's latent per frame and per-joint response direction
    vision_u: np.ndarray | None = None  # (n_img,) float32 in [-1, 1]
    vision_dirs: np.ndarray | None = None  # (J,) float32


#: first-order lag toward the cued target per tick (the "vision" task)
VISION_BETA = 0.35
#: per-joint target amplitude around pi (radians)
VISION_AMP = 0.9
#: per-tick process-noise std of the lag plant (radians)
VISION_NOISE_STD = 0.03


def _vision_recording(num_samples: int, num_joints: int, image_step: int, image_size: int,
                      rng: np.random.Generator, sampling_rate: int, dirs: np.ndarray,
                      noise_std: float = VISION_NOISE_STD) -> DummyRecording:
    """The camera-conditioned task: a latent u_k ~ U[-1, 1] is redrawn at
    every image stamp and drawn into that frame; the joint commands lag
    toward pi + VISION_AMP u_k dirs during the ticks after the frame, so
    the newest frame alone carries the next target."""
    n_img = -(-num_samples // image_step)
    u = rng.uniform(-1.0, 1.0, size=n_img).astype(np.float32)
    cmds = np.empty((num_samples, num_joints), dtype=np.float32)
    prev = np.full((num_joints,), math.pi, dtype=np.float32)
    noise = rng.normal(0.0, noise_std, size=(num_samples, num_joints)).astype(np.float32)
    for t in range(num_samples):
        target = math.pi + VISION_AMP * u[t // image_step] * dirs
        prev = prev + VISION_BETA * (target - prev) + noise[t]
        cmds[t] = prev
    cmds = np.clip(cmds, 0.0, 2.0 * math.pi - 1e-6)
    states = np.vstack([cmds[:1], cmds[:-1]])  # one tick of plant latency
    return DummyRecording(
        joint_commands=cmds, joint_states=states,
        rotations=_sinusoid_rotations(num_samples, rng),
        game_states=np.zeros(num_samples, dtype=np.int32),
        image_stamps=_stamps_f32_floor(np.arange(n_img) * image_step, sampling_rate),
        images=np.stack([_draw_cue_image(image_size, image_size, float(v)) for v in u]),
        vision_u=u, vision_dirs=dirs)


def generate_dummy_arrays(num_recordings: int = 2, num_samples: int = 500, num_joints: int = 20,
                          image_step: int = 10, image_size: int = 480, with_images: bool = False,
                          seed: int = 0, sampling_rate: int = 100,
                          task: str = "decorative") -> list[DummyRecording]:
    """Array-tier dummy data, one entry per recording; stamps are
    i / sampling_rate. ``task`` is "decorative" (frames only with
    ``with_images``) or "vision" (always with frames)."""
    rng = np.random.default_rng(seed)
    if task == "vision":
        # one image -> target mapping shared by every recording
        dirs = rng.uniform(-1.0, 1.0, size=num_joints).astype(np.float32)
        dirs = np.sign(dirs) * np.maximum(np.abs(dirs), 0.25)
        return [_vision_recording(num_samples, num_joints, image_step, image_size, rng,
                                  sampling_rate, dirs) for _ in range(num_recordings)]
    if task != "decorative":
        raise ValueError(f"unknown dummy task: {task!r}")
    recordings = []
    for _ in range(num_recordings):
        stamps = _stamps_f32_floor(np.arange(0, num_samples, image_step), sampling_rate)
        images = None
        if with_images:
            images = np.stack([_draw_test_image(image_size, image_size, float(s)) for s in stamps])
        recordings.append(DummyRecording(
            joint_commands=_sinusoid_joints(num_samples, num_joints, rng),
            joint_states=_sinusoid_joints(num_samples, num_joints, rng),
            rotations=_sinusoid_rotations(num_samples, rng),
            game_states=rng.integers(0, 4, size=num_samples).astype(np.int32),
            image_stamps=stamps, images=images))
    return recordings


def insert_dummy_data(conn: sqlite3.Connection, num_recordings: int, num_samples_per_rec: int,
                      image_step: int, seed: int = 0, image_size: int = 480) -> list[int]:
    """The SQLite tier of the dummy data: ``num_recordings`` recordings of
    ``num_samples_per_rec`` rows at 100 Hz (all 22 joints), a frame of
    ``image_size`` px every ``image_step`` rows. Returns the recordings' ids."""
    rng = np.random.default_rng(seed)
    cur = conn.cursor()
    recording_ids = []
    colors = TeamColor.values()
    for i in range(num_recordings):
        cur.execute(
            "INSERT INTO Recording (allow_public, original_file, team_name, team_color,"
            " robot_type, location, simulated, img_width, img_height,"
            " img_width_scaling, img_height_scaling)"
            " VALUES (1, ?, ?, ?, ?, ?, 1, ?, ?, 1.0, 1.0)",
            (f"dummy_original_file{i}", f"dummy_team_name{i}",
             colors[int(rng.integers(len(colors)))], f"dummy_robot_type{i}",
             f"dummy_location{i}", image_size, image_size))
        recording_ids.append(cur.lastrowid)
    joint_cols = ", ".join(f'"{n}"' for n in CANONICAL_JOINT_NAMES_22)
    joint_ph = ", ".join("?" * len(CANONICAL_JOINT_NAMES_22))
    states = RobotState.values()
    for rec_id in recording_ids:
        data = generate_dummy_arrays(1, num_samples_per_rec, num_joints=len(CANONICAL_JOINT_NAMES_22),
                                     image_step=image_step, image_size=image_size,
                                     with_images=True, seed=int(rng.integers(2**31)))[0]
        for table, rows in (("JointCommands", data.joint_commands),
                            ("JointStates", data.joint_states)):
            cur.executemany(
                f"INSERT INTO {table} (stamp, recording_id, {joint_cols}) VALUES (?, ?, {joint_ph})",
                [(i / 100, rec_id, *map(float, row)) for i, row in enumerate(rows)])
        cur.executemany(
            "INSERT INTO Rotation (stamp, recording_id, x, y, z, w) VALUES (?, ?, ?, ?, ?, ?)",
            [(i / 100, rec_id, *map(float, row)) for i, row in enumerate(data.rotations)])
        cur.executemany("INSERT INTO GameState (stamp, recording_id, state) VALUES (?, ?, ?)",
                        [(i / 100, rec_id, states[s]) for i, s in enumerate(data.game_states)])
        cur.executemany("INSERT INTO Image (stamp, recording_id, data) VALUES (?, ?, ?)",
                        [(float(stamp), rec_id, img.tobytes())
                         for stamp, img in zip(data.image_stamps, data.images)])
    conn.commit()
    return recording_ids
