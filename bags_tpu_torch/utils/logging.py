"""Structured training metrics: an append-only `metrics.jsonl` (port of
`bags_tpu/utils/logging.py`; the wandb mirror is not ported)."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, model_path: str):
        os.makedirs(model_path, exist_ok=True)
        self.path = os.path.join(model_path, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, **scalars) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
