"""Time the flagship's three serving lanes at B=64 (30-step DDIM with the
image-token cache, with raw frames, the distilled student) several times in
one process, through chip_smoke.py's flagship_path_phase (5 replan periods
each, launch counts checked):

    python tools/flagship_lanes.py [REPEATS]

Needs an NVIDIA GPU; builds the kernels like chip_smoke.py. Prints one line
of ms per period per repeat. To compare two trees, run it from the root of
each (it imports the chip_smoke.py and the package beside it).
"""

from __future__ import annotations

import os
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("flagship_lanes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    model = chip_smoke.build_model(chip_smoke.flagship_config(), "cuda", seed=3)
    for rep in range(repeats):
        _, periods = chip_smoke.flagship_path_phase(model, "cuda")
        print("lanes", rep, {k: round(v, 2) for k, v in periods.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
