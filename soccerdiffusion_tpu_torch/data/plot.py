"""Dataset-window visualisation: one PNG per training window (counterpart
of ``soccerdiffusion_tpu/data/plot.py``).

The reference's dataset inspection demo, rendered headlessly to a file:
per-joint command history, future chunk and joint-state curves, the IMU
rotation, the image-context strip and the game state in the title.

    python -m soccerdiffusion_tpu_torch.cli db plot-window 0 window.png --dummy-data

matplotlib is optional and imported only when a window is drawn.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _require_matplotlib():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise ImportError(
            "matplotlib is required for window plotting: "
            "pip install soccerdiffusion-tpu[viz]") from exc
    return plt


def plot_window(window: dict, config, out_path: str | Path,
                sampling_rate: int = 50) -> Path:
    """Render one :class:`WindowedDataset` item to ``out_path``.

    Layout (top to bottom): per-joint curves (command history at negative
    time, future command chunk at positive time, joint-state history),
    the IMU rotation components, and the image-context strip (ImageNet
    normalization undone for display). The game state rides in the title,
    as the reference prints it.
    """
    plt = _require_matplotlib()
    from soccerdiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
    from soccerdiffusion_tpu_torch.data.schema import RobotState

    names = list(config.joint_names)
    cols = 4
    joint_rows = -(-len(names) // cols)
    extra_rows = int(config.use_imu) + int(config.use_images)
    fig = plt.figure(figsize=(3.2 * cols, 2.2 * (joint_rows + extra_rows)))
    grid = fig.add_gridspec(joint_rows + extra_rows, cols, hspace=0.9)

    future = np.asarray(window["joint_command"])
    t_future = np.arange(future.shape[0]) / sampling_rate
    history = window.get("joint_command_history")
    states = window.get("joint_state")
    for j, name in enumerate(names):
        ax = fig.add_subplot(grid[j // cols, j % cols])
        ax.set_title(name, fontsize=8)
        if history is not None:
            h = np.asarray(history)
            ax.plot(np.arange(-h.shape[0], 0) / sampling_rate, h[:, j],
                    label="command history", lw=0.8)
        if states is not None:
            s = np.asarray(states)
            ax.plot(np.arange(-s.shape[0], 0) / sampling_rate, s[:, j],
                    label="joint state", lw=0.8)
        ax.plot(t_future, future[:, j], label="command future", lw=1.2)
        ax.tick_params(labelsize=6)
        if j == 0:
            ax.legend(fontsize=6)

    row = joint_rows
    if config.use_imu and "rotation" in window:
        rot = np.asarray(window["rotation"])
        ax = fig.add_subplot(grid[row, :])
        labels = (["x", "y", "z", "w"] if rot.shape[-1] == 4
                  else [f"c{i}" for i in range(rot.shape[-1])])
        for i, lab in enumerate(labels):
            ax.plot(np.arange(-rot.shape[0], 0) / sampling_rate, rot[:, i],
                    label=lab, lw=0.8)
        ax.set_title("rotation (IMU orientation history)", fontsize=8)
        ax.legend(fontsize=6, ncol=len(labels))
        ax.tick_params(labelsize=6)
        row += 1

    if config.use_images and "image_data" in window:
        frames = np.asarray(window["image_data"])
        n = frames.shape[0]
        sub = grid[row, :].subgridspec(1, n, wspace=0.05)
        for i in range(n):
            ax = fig.add_subplot(sub[0, i])
            img = frames[i] * IMAGENET_STD + IMAGENET_MEAN
            ax.imshow(np.clip(img, 0.0, 1.0))
            ax.set_axis_off()
            stamps = window.get("image_stamps")
            if stamps is not None:
                ax.set_title(f"{float(stamps[i]):.2f}s", fontsize=6)

    if "game_state" in window:
        state = RobotState.values()[int(window["game_state"])]
        fig.suptitle(f"game state: {state}", fontsize=10)

    out_path = Path(out_path)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path
