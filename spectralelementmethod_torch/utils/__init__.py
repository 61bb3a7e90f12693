"""Auxiliary subsystems: host setup-stage accounting, logging, HDF5
checkpointing, invariant checks, chain-differenced timing and perf
instrumentation."""

from . import checkpoint, checks, logging, perf, stages, timing

__all__ = ["checkpoint", "checks", "logging", "perf", "stages", "timing"]
