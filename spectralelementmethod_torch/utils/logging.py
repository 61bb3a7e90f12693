"""Structured logging/observability: a copy of the JAX package's
``utils/logging.py``.

The reference's observability is bare ``print`` statements (SURVEY.md §5:
Newton residuals, secant progress).  This module provides a standard
``logging``-based replacement with a concise default format, plus a tiny
metrics recorder for solver histories.
"""

from __future__ import annotations

import json
import logging
import sys
import time


def get_logger(name: str = "semtpu", level: int = logging.INFO
               ) -> logging.Logger:
    """Package logger with a single concise stderr handler (idempotent)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] "
                              "%(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsRecorder:
    """Append-only metric series (e.g. Newton/CG residual histories).

    ``dump_jsonl`` writes one JSON object per record, consumable by any
    log pipeline.
    """

    def __init__(self):
        self.records: list[dict] = []
        self._t0 = time.time()

    def record(self, **fields) -> None:
        entry = {"t": round(time.time() - self._t0, 6)}
        entry.update(fields)
        self.records.append(entry)

    def series(self, key: str):
        return [r[key] for r in self.records if key in r]

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    def __len__(self):
        return len(self.records)
