"""Auxiliary subsystems: host setup-stage accounting."""

from . import stages

__all__ = ["stages"]
