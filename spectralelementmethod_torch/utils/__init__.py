"""Auxiliary subsystems: host setup-stage accounting, logging and HDF5
checkpointing."""

from . import checkpoint, logging, stages

__all__ = ["checkpoint", "logging", "stages"]
