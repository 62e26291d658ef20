"""Dataset visualization (counterpart of ``examples/visualize_dataset.py``,
itself the counterpart of the reference's ``dataset/vizualization.ipynb``):
plot joint commands / states, the IMU orientation, the game state, and
sample images of one recording of a dataset DB (or the dummy backend).

  python -m soccerdiffusion_tpu_torch.examples.visualize_dataset [--db db.sqlite3] [--dummy] [-o viz/]

The plots need matplotlib (``data/plot.py``): where it is missing the
script raises an ImportError naming it, after the recording is loaded.
``--device`` is accepted as by every example (nothing here runs on a
device).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from soccerdiffusion_tpu_torch.config import CANONICAL_JOINT_NAMES_20, ModelConfig
from soccerdiffusion_tpu_torch.data import WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.plot import _require_matplotlib
from soccerdiffusion_tpu_torch.examples import resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Plot one recording of a dataset")
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--dummy", action="store_true")
    parser.add_argument("--recording", type=int, default=0)
    parser.add_argument("--output", "-o", type=str, default="viz")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    cfg = ModelConfig(use_images=args.dummy is False)
    if args.dummy:
        ds = WindowedDataset.from_dummy(
            generate_dummy_arrays(1, 1000, with_images=True, image_step=50), cfg
        )
    elif args.db:
        ds = WindowedDataset.from_sqlite(args.db, cfg)
    else:
        parser.error("--db or --dummy required")
    rec = ds.recordings[args.recording]

    plt = _require_matplotlib()
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    t = np.arange(len(rec.joint_commands)) / 100

    fig, axes = plt.subplots(4, 1, figsize=(14, 12), sharex=True)
    for j in range(min(6, rec.joint_commands.shape[1])):
        axes[0].plot(t, rec.joint_commands[:, j], label=CANONICAL_JOINT_NAMES_20[j], lw=0.8)
        axes[1].plot(t, rec.joint_states[:, j], lw=0.8)
    axes[0].set_title("joint commands [0, 2π)")
    axes[0].legend(fontsize=6, ncol=6)
    axes[1].set_title("joint states [0, 2π)")
    for k, name in enumerate("xyzw"):
        axes[2].plot(t[: len(rec.rotations)], rec.rotations[:, k], label=name, lw=0.8)
    axes[2].set_title("IMU quaternion")
    axes[2].legend(fontsize=8)
    axes[3].step(rec.game_state_stamps, rec.game_states, where="post")
    axes[3].set_title("game state (sorted-enum index)")
    axes[3].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(out / "recording_timeseries.png", dpi=110)
    plt.close(fig)

    if rec.images is not None and len(rec.images):
        n = min(8, len(rec.images))
        fig, axes = plt.subplots(1, n, figsize=(2 * n, 2.4))
        for i in range(n):
            ax = axes[i] if n > 1 else axes
            ax.imshow(rec.images[i * len(rec.images) // n])
            ax.set_title(f"t={rec.image_stamps[i * len(rec.images) // n]:.1f}s", fontsize=7)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(out / "recording_images.png", dpi=110)
        plt.close(fig)

    print(f"wrote plots to {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
