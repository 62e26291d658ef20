"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--controls fp8] [--faults unchanged,half_batch,altered] [--out FILE]

Each reading is one run of ``run.run_cell`` with a short window at the
cell's own load: the program on every seed; with ``--controls``, the
reference in that lower precision in the program's place, on every seed;
with ``--faults``, each fault planted under the timed path, on the first
three seeds. So a control or a fault is judged by the same comparison as a
sound run, and comes out ``correct: false`` there. One JSON line per (seed,
side); the benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def reading(cell: str, seed: int, seconds: float, side: str, device: str = "cuda",
            overrides: dict | None = None) -> dict:
    """One run judged on ``side``, its program freed after."""
    import torch

    t0 = time.perf_counter()
    result = run.run_cell(ROOT, cell, seed, seconds, False, device=device, overrides=overrides,
                          side=side, t0=t0)
    gc.unfreeze()  # run_cell froze set-up's objects; let the next reading's set-up reclaim them
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return {"workload": cell, "seed": seed, "side": side, "wall_s": time.perf_counter() - t0,
            **result}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    split = lambda text: [x for x in text.split(",") if x]
    seeds = [int(s) for s in split(args.seeds)]
    plan = [(seed, side) for side in ["program"] + split(args.controls) for seed in seeds]
    plan += [(seed, fault) for fault in split(args.faults) for seed in seeds[:3]]
    for seed, side in plan:
        line = json.dumps(reading(args.workload, seed, args.seconds, side))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
