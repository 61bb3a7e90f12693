"""Performance instrumentation: timers, FLOP/byte rooflines, profiler
traces (a PyTorch port of the JAX package's ``utils/perf.py``).

* :class:`Timer` / :func:`timed` — wall-clock blocks; :func:`timed`
  synchronizes the card after each call so device work is counted;
* :func:`roofline` — arithmetic-intensity analysis of a kernel against the
  card's published peak float32 rate and memory bandwidth
  (:data:`DEVICE_PEAKS`);
* :func:`trace` — ``torch.profiler`` around a block, written as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from .timing import sync


def _sync(x):
    sync(x)
    return x


@dataclass
class Timer:
    """Accumulating named wall-clock timer (device-synchronized)."""

    name: str = ""
    total: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return (f"{self.name}: {self.total * 1e3:.2f} ms total, "
                f"{self.mean * 1e3:.3f} ms/call over {self.count} calls")


def timed(fn, *args, reps: int = 10, warmup: int = 1, **kwargs):
    """(result, seconds_per_call) for a device function, warm-up excluded."""
    for _ in range(warmup):
        result = _sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(reps):
        result = _sync(fn(*args, **kwargs))
    return result, (time.perf_counter() - t0) / reps


#: published peaks per card, keyed by the full name that
#: ``torch.cuda.get_device_name`` gives: (float32 TFLOP/s outside the tensor
#: cores, memory GB/s).  NVIDIA's data sheet for the H100 SXM at its 700 W
#: limit (a card set below it runs slower); the PCIe and NVL parts have other
#: figures and no entry.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67.0, 3350.0),
}


def device_peaks(device=None):
    """(peak_tflops, hbm_gbps) of a card: the current CUDA device (None), a
    ``torch.device`` / device string, or a card's name as
    ``torch.cuda.get_device_name`` gives it.

    ``ValueError`` for a device without published figures in
    :data:`DEVICE_PEAKS` (the CPU among them): there is no default.
    """
    name = str(device)
    try:
        dev = torch.device("cuda" if device is None else device)
    except (RuntimeError, TypeError):
        dev = None                               # a card's name
    if dev is not None:
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise ValueError("no CUDA device: pass the card's name")
            name = torch.cuda.get_device_name(dev)
        else:
            name = dev.type
    if name in DEVICE_PEAKS:
        return DEVICE_PEAKS[name]
    raise ValueError(f"no published peak figures for {name!r} "
                     f"(known: {sorted(DEVICE_PEAKS)})")


@dataclass
class Roofline:
    flops: int
    bytes_moved: int
    seconds: float
    peak_tflops: float
    hbm_gbps: float

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOP per byte."""
        return self.flops / max(self.bytes_moved, 1)

    @property
    def bound(self) -> str:
        ridge = self.peak_tflops * 1e3 / self.hbm_gbps
        return "compute" if self.intensity > ridge else "memory"

    @property
    def roofline_gflops(self) -> float:
        """Attainable GFLOP/s at this intensity."""
        return min(self.peak_tflops * 1e3, self.intensity * self.hbm_gbps)

    @property
    def efficiency(self) -> float:
        """Fraction of the attainable (roofline) rate achieved."""
        return self.gflops / self.roofline_gflops

    def __str__(self):
        return (f"{self.gflops:.1f} GFLOP/s ({self.gbps:.1f} GB/s), "
                f"intensity {self.intensity:.2f} FLOP/B -> {self.bound}-"
                f"bound; {100 * self.efficiency:.1f}% of roofline "
                f"({self.roofline_gflops:.0f} GFLOP/s attainable)")


def roofline(flops: int, bytes_moved: int, seconds: float,
             device=None) -> Roofline:
    peak_tflops, hbm = device_peaks(device)
    return Roofline(flops, bytes_moved, seconds, peak_tflops, hbm)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block with ``torch.profiler`` (the card's activity too,
    when there is one) and write it to ``logdir/trace.json``, a Chrome
    trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
