"""Hand-written CUDA kernels of the main path, their wrappers and plain
versions.

Three kernels replace the TPU Pallas kernels that the 2D affine
``solve_local`` runs (sources in ``../csrc``, one shared library each):

* :func:`affine_apply_dss` — ``DSS(sum_c a_c K_c u)``, the operator apply
  (``make_fused_affine_laplacian_T``);
* :func:`cg_kernel_a` — the direction half of a fused PCG iteration
  (kernel A of ``make_fused_cg_kernels``);
* :func:`cg_kernel_b` — the residual half (``_build_cg_kernel_b``).

Each wrapper runs its plain PyTorch version when the tensors lie on the
CPU, and for CUDA tensors launches the kernel or raises: there is no
fallback.  Each keeps a launch count (``wrapper.launches``), incremented
only where the kernel is launched.

The libraries are compiled with ``nvcc`` for ``sm_90a`` on first use into
``../_build`` (keyed by a hash of the sources and flags), in parallel with
:func:`build`, and bound with ``ctypes`` (plain C entry points; pointers
and the stream as ``c_void_p``; each returns ``cudaGetLastError()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .exchange import DSSPlan, roll_dss_T

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_HEADERS = ("sem_kernels.cuh",)
_REPLACED = "spectralelementmethod_tpu/ops/pallas_kernels.py"

#: kernel name -> (source in csrc/, the TPU kernel it replaces)
KERNELS = {
    "affine_apply_dss": ("affine_apply_dss.cu", f"{_REPLACED}:986"),
    "cg_kernel_a": ("cg_kernel_a.cu", f"{_REPLACED}:1480"),
    "cg_kernel_b": ("cg_kernel_b.cu", f"{_REPLACED}:1548"),
}
#: elements per block of the product kernels (one denominator partial each)
THREADS = 256
#: nodes per element with a compiled instantiation: (p + 1)^2 for p = 2..8
#: (``SEM_FOR_EACH_N`` in csrc/sem_kernels.cuh)
SUPPORTED_N = (9, 16, 25, 36, 49, 64, 81)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sem_affine_apply_dss": [_P] * 8 + [_I] * 3 + [_P],
    "sem_cg_kernel_a_f32": [_P] * 16 + [_I] * 3 + [_P],
    "sem_cg_kernel_a_bf16": [_P] * 16 + [_I] * 3 + [_P],
    "sem_cg_kernel_b_f32": [_P] * 7 + [ctypes.c_longlong, _I, _P],
    "sem_cg_kernel_b_bf16": [_P] * 7 + [ctypes.c_longlong, _I, _P],
}
#: kernel B's grid: blocks per SM of the card
BLOCKS_PER_SM_B = 4
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 Path("/usr/local/cuda/bin/nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are compiled from csrc/ on first use")


def library_path(name: str) -> Path:
    """Build target of kernel ``name``, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNELS[name][0], *_HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the kernels' libraries that are missing, one ``nvcc`` per
    source, all started together; returns ``{name: compiler output}``
    (with ``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises after every compiler has exited if any failed."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.sem_error_string.argtypes = [ctypes.c_int]
        lib.sem_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sem_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _require(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                         f"{' or '.join(str(d) for d in dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"tensors on {t.device}: the kernels run on CUDA, "
                         "their plain versions on the CPU")
    return t.device


def _scalar(v, device) -> torch.Tensor:
    """A float32 scalar on the device (device tensors pass through, so the
    CG loop never syncs with the host)."""
    if isinstance(v, torch.Tensor):
        _require(v.reshape(()), "scalar", (torch.float32,), (), device)
        return v.reshape(())
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _check_n(n: int) -> None:
    if n not in SUPPORTED_N:
        raise NotImplementedError(
            f"no kernel instantiation for n={n} nodes per element "
            f"(compiled: {SUPPORTED_N})")


def _check_plan(plan: DSSPlan, device) -> None:
    if plan.has_tail:
        raise NotImplementedError(
            "the exchange has pairs outside its roll classes (tails); the "
            "kernels take tail-free plans only")
    if device is not None and plan.device != device:
        raise ValueError(f"plan is on {plan.device}, tensors on {device}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _local_product(uT, Kst, aT):
    """S = sum_c a_c (K_c u): the element-local affine product."""
    V = torch.matmul(Kst, uT)                        # (3, n, E)
    return aT[0] * V[0] + aT[1] * V[1] + aT[2] * V[2]


# -- kernel 1: the operator apply ---------------------------------------------

def affine_apply_dss_plain(uT, Kst, aT, plan: DSSPlan):
    """Plain version of :func:`affine_apply_dss` (``torch.matmul`` plus the
    roll-class DSS)."""
    return roll_dss_T(_local_product(uT, Kst, aT), plan)


def affine_apply_dss(uT: torch.Tensor, Kst: torch.Tensor, aT: torch.Tensor,
                     plan: DSSPlan) -> torch.Tensor:
    """``out = DSS(sum_c a_c K_c u)`` on an (n, E) L-vector.

    ``Kst`` (3, n, n): the blocks ``K_c``; ``aT`` (3, E): the affine scales;
    ``plan``: the exchange's :class:`.DSSPlan` on the tensors' device.
    CUDA tensors must be float32 (a float64 CUDA tensor raises).
    """
    if uT.device.type == "cpu":
        _check_plan(plan, None)
        return affine_apply_dss_plain(uT, Kst, aT, plan)
    dev = _cuda_device(uT)
    _check_plan(plan, dev)
    n, E = uT.shape
    _check_n(n)
    f32 = (torch.float32,)
    _require(uT, "uT", f32, (n, E), dev)
    _require(Kst, "Kst", f32, (3, n, n), dev)
    _require(aT, "aT", f32, (3, E), dev)
    out = torch.empty_like(uT)
    B = torch.empty((max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    lib = _lib("affine_apply_dss")
    rc = lib.sem_affine_apply_dss(
        _ptr(uT), _ptr(Kst), _ptr(aT), _ptr(out), _ptr(B),
        _ptr(plan.row_ptr), _ptr(plan.entries), _ptr(plan.masks),
        n, E, plan.nb, _stream(dev))
    _check(lib, rc, f"affine_apply_dss (n={n}, E={E})")
    affine_apply_dss.launches += 1
    return out


affine_apply_dss.launches = 0


# -- kernel A: direction update + apply + denominator partials ----------------

def cg_kernel_a_plain(r, p, inv, x, beta, alpha_prev, Kst, aT,
                      plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a`; the denominator partials are
    one per element."""
    p32 = p.to(r.dtype)
    x_new = x + alpha_prev * p32
    p_st = (inv.to(r.dtype) * r + beta * p32).to(p.dtype)
    ps = p_st.to(r.dtype)
    S = _local_product(ps, Kst, aT)
    return p_st, roll_dss_T(S, plan), x_new, (ps * S).sum(0)


def cg_kernel_a(r, p, inv, x, beta, alpha_prev, Kst, aT, plan: DSSPlan):
    """``(p', Ap', x', dparts)`` of one fused PCG iteration (affine mesh).

    ``x' = x + alpha_prev p``; ``p' = inv r + beta p`` stored in ``p``'s
    dtype (float32 or bfloat16, with ``inv`` of the same dtype);
    ``Ap' = DSS(sum_c a_c K_c p')`` from the stored ``p'``; ``dparts`` the
    partial sums of ``p' . S`` before the DSS (their total is
    ``<p', A p'>``).  ``r`` and ``x`` are float32; ``beta`` and
    ``alpha_prev`` are floats or float32 scalars on the device.
    """
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_plain(r, p, inv, x, beta, alpha_prev, Kst, aT,
                                 plan)
    dev = _cuda_device(r)
    _check_plan(plan, dev)
    n, E = r.shape
    _check_n(n)
    f32 = (torch.float32,)
    _require(r, "r", f32, (n, E), dev)
    _require(x, "x", f32, (n, E), dev)
    _require(p, "p", (torch.float32, torch.bfloat16), (n, E), dev)
    _require(inv, "inv", (p.dtype,), (n, E), dev)
    _require(Kst, "Kst", f32, (3, n, n), dev)
    _require(aT, "aT", f32, (3, E), dev)
    beta, alpha_prev = _scalar(beta, dev), _scalar(alpha_prev, dev)
    p_out, x_out, ap = torch.empty_like(p), torch.empty_like(x), \
        torch.empty_like(r)
    B = torch.empty((max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    dparts = torch.empty(-(-E // THREADS), dtype=torch.float32, device=dev)
    lib = _lib("cg_kernel_a")
    fn = (lib.sem_cg_kernel_a_bf16 if p.dtype == torch.bfloat16
          else lib.sem_cg_kernel_a_f32)
    rc = fn(_ptr(r), _ptr(p), _ptr(inv), _ptr(x), _ptr(Kst), _ptr(aT),
            _ptr(beta), _ptr(alpha_prev), _ptr(p_out), _ptr(x_out), _ptr(ap),
            _ptr(B), _ptr(dparts), _ptr(plan.row_ptr), _ptr(plan.entries),
            _ptr(plan.masks), n, E, plan.nb, _stream(dev))
    _check(lib, rc, f"cg_kernel_a (n={n}, E={E}, p {p.dtype})")
    cg_kernel_a.launches += 1
    return p_out, ap, x_out, dparts


cg_kernel_a.launches = 0


# -- kernel B: residual update + the two weighted reductions ------------------

def cg_kernel_b_plain(r, Ap, inv, w_free, alpha):
    """Plain version of :func:`cg_kernel_b`; partials one per element."""
    r_new = r - alpha * Ap
    w = w_free.to(r.dtype)
    z = inv.to(r.dtype) * r_new
    return r_new, (w * r_new * z).sum(0), (w * r_new * r_new).sum(0)


def cg_kernel_b(r, Ap, inv, w_free, alpha):
    """``(r', rz_parts, rn2_parts)``: ``r' = r - alpha Ap`` and partial sums
    of ``<w r', inv r'>`` and ``<w r', r'>``.  ``r`` and ``Ap`` are
    float32; ``inv`` and ``w_free`` float32 or both bfloat16."""
    if r.device.type == "cpu":
        return cg_kernel_b_plain(r, Ap, inv, w_free, alpha)
    dev = _cuda_device(r)
    shape = tuple(r.shape)
    f32 = (torch.float32,)
    _require(r, "r", f32, shape, dev)
    _require(Ap, "Ap", f32, shape, dev)
    _require(inv, "inv", (torch.float32, torch.bfloat16), shape, dev)
    _require(w_free, "w_free", (inv.dtype,), shape, dev)
    alpha = _scalar(alpha, dev)
    lib = _lib("cg_kernel_b")
    blocks = BLOCKS_PER_SM_B * torch.cuda.get_device_properties(
        dev).multi_processor_count
    r_out = torch.empty_like(r)
    parts = torch.empty((2, blocks), dtype=torch.float32, device=dev)
    fn = (lib.sem_cg_kernel_b_bf16 if inv.dtype == torch.bfloat16
          else lib.sem_cg_kernel_b_f32)
    rc = fn(_ptr(r), _ptr(Ap), _ptr(inv), _ptr(w_free), _ptr(alpha),
            _ptr(r_out), _ptr(parts), r.numel(), blocks, _stream(dev))
    _check(lib, rc, f"cg_kernel_b (shape={shape}, inv {inv.dtype})")
    cg_kernel_b.launches += 1
    return r_out, parts[0], parts[1]


cg_kernel_b.launches = 0

def make_fused_cg_kernels(Kst: torch.Tensor, aT: torch.Tensor,
                          plan: DSSPlan):
    """``(kA, kB)`` for :func:`..solver.cg.cg_fused`: kernel A bound to one
    affine operator (``Kst``, ``aT``, ``plan``), and kernel B."""

    def kA(r, p, inv, x, beta, alpha_prev):
        return cg_kernel_a(r, p, inv, x, beta, alpha_prev, Kst, aT, plan)

    return kA, cg_kernel_b


#: the wrappers, by kernel name
WRAPPERS = {"affine_apply_dss": affine_apply_dss, "cg_kernel_a": cg_kernel_a,
            "cg_kernel_b": cg_kernel_b}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
