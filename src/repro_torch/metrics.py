"""Minimal metrics logging: CSV + stdout, no external deps.

The CSV schema may *evolve*: later rows can introduce keys the first row
did not have (the fused round engine logs ``up_floats``/``down_floats``
per-round while a warmup row may not).  The writer keeps the union of all
keys seen and rewrites the file with the widened header when a new key
appears; missing values render as empty cells.
"""

from __future__ import annotations

import csv
import os
import sys
import time
from typing import Any, Dict, List, Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, print_every: int = 1):
        self.path = path
        self.print_every = print_every
        self._writer = None
        self._file = None
        self._fieldnames: List[str] = []
        self._t0 = time.time()
        self._n = 0

    def _reopen(self, extra_rows: List[Dict[str, Any]]) -> None:
        """Rewrite the file with the current (widened) header: previously
        written rows are re-read from disk, so steady-state memory is O(1)
        no matter how long the run logs."""
        old_rows: List[Dict[str, Any]] = []
        if self._file is not None:
            self._file.close()
            with open(self.path, newline="") as f:
                old_rows = list(csv.DictReader(f))
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._file = open(self.path, "w", newline="")
        self._writer = csv.DictWriter(
            self._file, fieldnames=self._fieldnames, restval=""
        )
        self._writer.writeheader()
        self._writer.writerows(old_rows)
        self._writer.writerows(extra_rows)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        row.update({
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in metrics.items()
        })
        if self.path:
            new_keys = [k for k in row if k not in self._fieldnames]
            if self._file is None or new_keys:
                self._fieldnames.extend(new_keys)
                self._reopen([row])
            else:
                self._writer.writerow(row)
            self._file.flush()
        self._n += 1
        if self._n % self.print_every == 0:
            msg = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()
            )
            print(msg, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
