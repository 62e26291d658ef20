"""Training metrics (counterpart of ``soccerdiffusion_tpu/training/metrics.py``,
JSONL and the console; no wandb)."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any

logger = logging.getLogger("soccerdiffusion_tpu_torch")


class MetricsLogger:
    """Writes one JSON object per logged step (``step``, ``wall_dt`` since the
    previous record, the scalar metrics and ``grad_norms/<module>``) to
    ``out_path`` when given, and a line to the log. The caller decides
    which steps to log."""

    def __init__(self, out_path: str | Path | None = None):
        self.out_path = Path(out_path) if out_path else None
        self._fh = None
        if self.out_path:
            self.out_path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.out_path.open("a")
        self._last_time = time.perf_counter()

    def log(self, step: int, metrics: dict[str, Any], grads: dict[str, Any] | None = None) -> None:
        now = time.perf_counter()
        record = {"step": int(step), "wall_dt": now - self._last_time}
        self._last_time = now
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v
        for name, v in (grads or {}).items():
            record[f"grad_norms/{name}"] = float(v)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        logger.info(", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in record.items()))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
