"""Metrics aggregation and JSONL observability — port of
``safe_exploration_tpu/runtime/metrics.py``: buffered scalar series flushed
to a JSONL file (one record per scalar) plus an in-memory store."""

from __future__ import annotations

import json
import os
import time
from typing import Any

__all__ = ["AggregatedMetrics"]


class AggregatedMetrics:
    """Buffered scalar metric series with JSONL flushing."""

    def __init__(self, out_dir: str | None = None, run_name: str = "run"):
        self._buffer: list[dict[str, Any]] = []
        self.history: dict[str, list[tuple[int, float]]] = {}
        self._path = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")

    def log_scalar(self, name: str, value, step: int) -> None:
        rec = {"name": name, "value": float(value), "step": int(step),
               "t": time.time()}
        self._buffer.append(rec)
        self.history.setdefault(name, []).append((int(step), float(value)))

    def log_dict(self, values: dict, step: int) -> None:
        for k, v in values.items():
            self.log_scalar(k, v, step)

    def flush(self) -> None:
        if self._path is None:
            self._buffer.clear()
            return
        with open(self._path, "a") as f:
            for rec in self._buffer:
                f.write(json.dumps(rec) + "\n")
        self._buffer.clear()

    def summary(self) -> dict[str, float]:
        """Last value of every series (for end-of-run reporting)."""
        return {k: v[-1][1] for k, v in self.history.items() if v}
