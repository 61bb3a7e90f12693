"""Native (C++) host-side kernels, built on demand and loaded via ctypes.

A copy of the JAX package's ``native/`` (the port imports nothing of that
package).  The device compute path is PyTorch and the CUDA kernels of
``csrc/``; this package accelerates the *host* runtime around it (mesh
adjacency hashing, batched point location — see ``meshkit.cpp``).

``meshkit.cpp`` is compiled by ``g++`` at first use into
``spectralelementmethod_torch/_build/`` (keyed by a hash of the source and
flags, as the CUDA libraries are).  Everything here is optional: without a
C++ toolchain :func:`available` is False and callers use the numpy
fallbacks; the build error is logged once, not swallowed.

Reference parity note: the reference ships one native file,
``sem/bary_interp.c`` (barycentric interpolation, never built into an
extension); ``meshkit.cpp`` subsumes it (same barycentric node-hit
semantics inside the Newton point locator).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.logging import get_logger

_SRC = Path(__file__).resolve().parent / "meshkit.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """Build target of ``meshkit.cpp``, keyed by its source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libmeshkit-{h.hexdigest()[:16]}.so"


def _build_lib() -> Path | None:
    """Compile meshkit.cpp to a shared library unless it is built; None
    (the error logged) when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
        return out
    except subprocess.CalledProcessError as exc:
        get_logger("semtorch.native").warning(
            "meshkit build failed (numpy fallbacks in use): %s\n%s",
            " ".join(cmd), exc.stderr)
    except (OSError, subprocess.SubprocessError) as exc:
        get_logger("semtorch.native").warning(
            "meshkit build failed (numpy fallbacks in use): %s", exc)
    tmp.unlink(missing_ok=True)
    return None


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            get_logger("semtorch.native").warning(
                "meshkit load failed (numpy fallbacks in use): %s", exc)
            return None

        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.semn_match_keys.restype = i64
        lib.semn_match_keys.argtypes = [p_i64, i64, p_i64]
        lib.semn_lookup_keys.restype = None
        lib.semn_lookup_keys.argtypes = [p_i64, i64, p_i64, i64, p_i64]
        lib.semn_locate_points.restype = None
        lib.semn_locate_points.argtypes = [
            p_f64, i64,                    # centroids, E
            p_f64, p_f64,                  # x_coeffs, j_coeffs
            ctypes.c_int, ctypes.c_int,    # n0, n1
            p_f64, p_f64, p_f64, p_f64,    # nodes0, w0, nodes1, w1
            p_f64, i64,                    # points, Q
            ctypes.c_double, ctypes.c_double, i64,
            p_i64, p_f64,                  # elem, xi
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    return _load() is not None


def match_keys(keys: np.ndarray) -> np.ndarray:
    """partner[i] = j with keys[j] == keys[i] (exactly-paired), else -1.

    Raises ValueError if any key occurs more than twice.  The reference
    matches ``Mesh.find_neighbors``'s face keys with it; the port's
    ``find_neighbors`` keeps its numpy sort, which the hash did not beat at
    100k cells.
    """
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    partner = np.empty_like(keys)
    rc = lib.semn_match_keys(keys, keys.size, partner)
    if rc:
        raise ValueError(
            f"key {keys[rc - 1]} occurs more than twice "
            f"(a face shared by more than 2 cells)"
        )
    return partner


def lookup_keys(keys: np.ndarray, query: np.ndarray) -> np.ndarray:
    """For each query key, index of a matching entry in ``keys`` or -1."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.int64)
    out = np.empty(query.size, dtype=np.int64)
    lib.semn_lookup_keys(keys, keys.size, query, query.size, out)
    return out


def locate_points(centroids, x_coeffs, j_coeffs, nodes0, w0, nodes1, w1,
                  points, bound_tol: float = 1e-7,
                  extrapolate_tol: float = 0.0,
                  max_candidates: int = 16):
    """Batched 2D point location (bin-grid search + Newton inverse map).

    Returns (elem (Q,) int64 with -1 = not found, xi (Q, 2) float64;
    xi is zero where elem is -1, as the numpy scan leaves it: the C++
    locator writes no xi for a point it does not find).
    Parity: ``sem/mapping.py:146-178`` (it_max=8, tol=1e-8) +
    ``sem/discrete.py:263-280`` (centroid-distance candidate order).
    """
    lib = _load()
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    x_coeffs = np.ascontiguousarray(x_coeffs, dtype=np.float64)
    j_coeffs = np.ascontiguousarray(j_coeffs, dtype=np.float64)
    points = np.ascontiguousarray(points, dtype=np.float64)
    E = centroids.shape[0]
    Q = points.shape[0]
    n0, n1 = x_coeffs.shape[-2], x_coeffs.shape[-1]
    elem = np.empty(Q, dtype=np.int64)
    xi = np.zeros((Q, 2), dtype=np.float64)
    lib.semn_locate_points(
        centroids, E, x_coeffs, j_coeffs, n0, n1,
        np.ascontiguousarray(nodes0, dtype=np.float64),
        np.ascontiguousarray(w0, dtype=np.float64),
        np.ascontiguousarray(nodes1, dtype=np.float64),
        np.ascontiguousarray(w1, dtype=np.float64),
        points, Q, bound_tol, extrapolate_tol, max_candidates, elem, xi,
    )
    return elem, xi
