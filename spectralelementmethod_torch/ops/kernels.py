"""Hand-written CUDA kernels of the main path, their wrappers and plain
versions.

Nine CUDA sources (``../csrc``, one shared library each) replace the TPU
Pallas kernels that the 2D ``solve_local`` and ``solve_local_batch`` of the
Poisson and Helmholtz models run on affine and on curved meshes, and those
of the element-sharded operator and of the applies' far-class split.  Each
apply and CG kernel but the single-kernel iteration takes
one right-hand side or a ``(k * n, E)`` stack of k that share the operator
(the RHS is a grid dimension of every launch), and each wrapper below
launches one variant:

* :func:`affine_apply_dss` / :func:`affine_apply_dss_batched` —
  ``DSS(sum_c a_c K_c u)``, the operator apply on affine meshes
  (``make_fused_affine_laplacian_T``, ``n_rhs = 1`` / k), computed on the
  card in tensor-product form from the :class:`AffineFactors` of ``K_c``;
* :func:`general_apply_dss` / :func:`general_apply_dss_batched` — the
  apply on curved meshes, ``DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us])``
  with ``[ur; us] = Dhat u`` and full (3, n, E) factor slabs
  (``make_fused_general_laplacian_T``), computed on the card on the same
  tensor-product tile from the :class:`GeneralFactors` of ``Dhat``; with
  ``aux=True`` each also returns the raw exchanged rows it summed from, for
  :func:`far_update`;
* :func:`affine_block_apply_dss` — the affine apply on one shard's
  halo-extended element block, its scales and class masks runtime operands
  (``make_fused_affine_block_kernel``);
* at p = 1 (n = 4, the p-multigrid coarse level) each apply above is one
  launch of the p = 1 kernels (``csrc/sem_p1.cuh``): the element products
  from the assembled blocks or ``Dh`` by value, formed per tile in shared
  memory for the windows of deltas its sums read, and the DSS together,
  with the plan's entries by value (:func:`p1_classes`); with
  ``aux=True`` the same launch writes the raw rows;
* :func:`far_update` — adds the far roll classes of a split DSS into an
  apply's output in place (``make_far_update_kernel``);
* :func:`cg_kernel_a` / :func:`cg_kernel_a_deferred` — the direction half
  of a fused PCG iteration, with and without the lagged x update (kernel A
  of ``make_fused_cg_kernels``, ``defer_x`` False / True);
  :func:`cg_kernel_a_batched` / :func:`cg_kernel_a_batched_deferred` — the
  same for k RHS (``make_fused_cg_kernels_batched``); their product is the
  affine apply's tensor-product tile, from the same :class:`AffineFactors`;
  :func:`cg_kernel_a_general` / :func:`cg_kernel_a_general_batched` — the
  direction half on curved meshes (kernel A of
  ``make_fused_cg_kernels_general``), around the curved apply's product;
* :func:`cg_kernel_b` / :func:`cg_kernel_b_batched` — the residual half
  (``_build_cg_kernel_b``, ``_build_cg_kernel_b_batched``);
* :func:`cg_kernel_single` / :func:`cg_kernel_single_deferred` — one whole
  PCG iteration with the residual update deferred into the next kernel,
  with and without the lagged x update (``make_fused_cg_kernel_single``,
  one RHS, affine meshes), around the same tile;
* :func:`laplacian_local`, :func:`laplacian_local_batched` and
  :func:`vector_laplacian_local` — the element-local weak Laplacian on
  row-major (E, n) L-vectors without DSS, on one array, a (k, E, n) stack
  and k components packed as (E, k n) (``fused_laplacian_local`` and
  ``fused_vector_laplacian_local``): one kernel that takes the element and
  component strides and runs the curved product's tile from the
  :class:`GeneralFactors` of ``Dh``.

Each wrapper runs its plain PyTorch version when the tensors lie on the
CPU, and for CUDA tensors launches the kernel or raises: there is no
fallback.  The affine kernels (the applies, kernel A and the single
kernel) take ``factors=`` on CUDA tensors and read no assembled ``Kst``;
their plain versions multiply by ``Kst`` and ignore the factors.  The
curved kernels (the general apply and its kernel A) take ``factors=`` too,
a :class:`GeneralFactors`, and read no dense ``Dh``; so does the
element-local kernel, which builds them from ``Dh`` when none are given.
Each wrapper keeps its launch counts by n (``wrapper.launches``, n ->
launches), incremented only where the kernel is launched
(:func:`launch_counts`, :func:`launch_counts_by_n`).  Per-RHS scalars of
the batched kernels are (k,) float32 tensors on the device; their partial
sums are (G, k).

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

import numpy as np
import torch

from .exchange import DSSPlan, roll_dss_T

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_HEADERS = ("sem_kernels.cuh", "sem_affine.cuh", "sem_curved.cuh",
            "sem_p1.cuh")
_REPLACED = "spectralelementmethod_tpu/ops/pallas_kernels.py"
_APPLY, _CG_A, _CG_B = ("affine_apply_dss.cu", "cg_kernel_a.cu",
                        "cg_kernel_b.cu")
_GEN_APPLY, _GEN_CG_A = "general_apply_dss.cu", "cg_kernel_a_general.cu"
_SINGLE = "cg_kernel_single.cu"
_LOCAL = "laplacian_local.cu"
_FAR = "far_update.cu"

#: kernel name -> (source in csrc/, the TPU kernel it replaces)
KERNELS = {
    "affine_apply_dss": (_APPLY, f"{_REPLACED}:986"),
    "affine_apply_dss_batched": (_APPLY, f"{_REPLACED}:986"),
    "cg_kernel_a": (_CG_A, f"{_REPLACED}:1480"),
    "cg_kernel_a_deferred": (_CG_A, f"{_REPLACED}:1423"),
    "cg_kernel_a_batched": (_CG_A, f"{_REPLACED}:2153"),
    "cg_kernel_a_batched_deferred": (_CG_A, f"{_REPLACED}:2128"),
    "cg_kernel_b": (_CG_B, f"{_REPLACED}:1548"),
    "cg_kernel_b_batched": (_CG_B, f"{_REPLACED}:2189"),
    "general_apply_dss": (_GEN_APPLY, f"{_REPLACED}:1179"),
    "general_apply_dss_batched": (_GEN_APPLY, f"{_REPLACED}:1179"),
    "cg_kernel_a_general": (_GEN_CG_A, f"{_REPLACED}:1824"),
    "cg_kernel_a_general_batched": (_GEN_CG_A, f"{_REPLACED}:1824"),
    "cg_kernel_single": (_SINGLE, f"{_REPLACED}:1807"),
    "cg_kernel_single_deferred": (_SINGLE, f"{_REPLACED}:1765"),
    "laplacian_local": (_LOCAL, f"{_REPLACED}:76"),
    "laplacian_local_batched": (_LOCAL, f"{_REPLACED}:76"),
    "vector_laplacian_local": (_LOCAL, f"{_REPLACED}:149"),
    "affine_block_apply_dss": (_APPLY, f"{_REPLACED}:1110"),
    "far_update": (_FAR, f"{_REPLACED}:876"),
}
#: the sources, one shared library each
SOURCES = (_APPLY, _CG_A, _CG_B, _GEN_APPLY, _GEN_CG_A, _SINGLE, _LOCAL,
           _FAR)
#: threads per block of the class gather (``kThreads`` in
#: csrc/sem_kernels.cuh; one row of the single kernel's gather partials
#: each)
THREADS = 256
#: elements per tile of the affine product kernels (``kAffTile`` in
#: csrc/sem_affine.cuh; one denominator partial row each)
AFFINE_TILE = 32
#: elements per tile of the curved (n, E) kernels (``kAffTile``, the tile
#: of csrc/sem_curved.cuh; one denominator partial row each)
GENERAL_TILE = 32
#: nodes per element with a compiled instantiation of every kernel:
#: (p + 1)^2 for p = 2..8 (``SEM_FOR_EACH_N`` in csrc/sem_kernels.cuh)
SUPPORTED_N = (9, 16, 25, 36, 49, 64, 81)
#: nodes per element of the apply kernels (affine_apply_dss,
#: general_apply_dss, their stacks and the block apply): p = 1 as well,
#: the p-multigrid coarse level, which takes the one-launch p = 1 kernels
#: (csrc/sem_p1.cuh) instead of the tile
APPLY_N = (4,) + SUPPORTED_N
#: the p = 1 kernels' class table (csrc/sem_p1.cuh): the most windows,
#: products in shared memory and entries (``kP1MaxWindows``, ``kP1Slots``,
#: ``kP1MaxEntries``), and the tile sizes an apply of one RHS and of a
#: stack takes, the first whose windows fit
P1_MAX_WINDOWS, P1_SLOTS, P1_MAX_ENTRIES = 8, 3072, 32
P1_TILES, P1_TILES_STACK = (256,), (1024, 512, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sem_affine_apply_dss": [_P] * 8 + [_I] * 4 + [_P],
    "sem_cg_kernel_a_f32": [_P] * 16 + [_I] * 4 + [_P],
    "sem_cg_kernel_a_bf16": [_P] * 16 + [_I] * 4 + [_P],
    "sem_cg_kernel_a_defer_f32": [_P] * 13 + [_I] * 4 + [_P],
    "sem_cg_kernel_a_defer_bf16": [_P] * 13 + [_I] * 4 + [_P],
    "sem_cg_kernel_b_f32": [_P] * 7 + [ctypes.c_longlong, _I, _I, _P],
    "sem_cg_kernel_b_bf16": [_P] * 7 + [ctypes.c_longlong, _I, _I, _P],
    "sem_general_apply_dss": [_P] * 8 + [_I] * 4 + [_P],
    "sem_cg_kernel_a_general_f32": [_P] * 16 + [_I] * 4 + [_P],
    "sem_cg_kernel_a_general_bf16": [_P] * 16 + [_I] * 4 + [_P],
    "sem_cg_kernel_single_f32": [_P] * 19 + [_I] * 3 + [_P],
    "sem_cg_kernel_single_bf16": [_P] * 19 + [_I] * 3 + [_P],
    "sem_cg_kernel_single_defer_f32": [_P] * 17 + [_I] * 3 + [_P],
    "sem_cg_kernel_single_defer_bf16": [_P] * 17 + [_I] * 3 + [_P],
    "sem_laplacian_local": [_P] * 4 + [_I] * 3 + [ctypes.c_longlong] * 2
    + [_I, _P],
    "sem_laplacian_local_occupancy": [_I] * 3 + [_P],
    "sem_affine_block_apply_dss": [_P] * 8 + [_I] * 3 + [_P],
    "sem_affine_p1_apply_dss": [_P] * 8 + [_I] * 3 + [_P],
    "sem_general_p1_apply_dss": [_P] * 8 + [_I] * 3 + [_P],
    "sem_far_update": [_P] * 4 + [_I, _P],
    "sem_affine_tables_size": [],
    "sem_general_tables_size": [],
    "sem_far_tables_size": [],
    "sem_p1_classes_size": [],
    "sem_affine_p1_tables_size": [],
    "sem_general_p1_tables_size": [],
}
#: the partial sums of the single-kernel iteration, their columns in order
SINGLE_PARTS = ("denom", "c1", "c2", "e1", "e2")
#: kernel B's grid: blocks per SM of the card, over all RHS
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


def library_path(source: str) -> Path:
    """Build target of ``source``, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, *_HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=None) -> dict[str, str]:
    """Compile the libraries that are missing, one ``nvcc`` per source, all
    started together; returns ``{source: compiler output}`` (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises after every compiler has exited if any failed."""
    sources = SOURCES if sources is None else tuple(sources)
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        logs[src], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    return logs


def _lib(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.sem_error_string.argtypes = [ctypes.c_int]
        lib.sem_error_string.restype = ctypes.c_char_p
        for fn, dt, what in (
                ("sem_affine_tables_size", _AFFINE_TABLES,
                 "AffineTables (csrc/sem_affine.cuh)"),
                ("sem_general_tables_size", _GENERAL_TABLES,
                 "GeneralTables (csrc/sem_curved.cuh)"),
                ("sem_far_tables_size", _FAR_TABLES,
                 "FarTables (csrc/far_update.cu)"),
                ("sem_p1_classes_size", _P1_CLASSES,
                 "P1Classes (csrc/sem_p1.cuh)"),
                ("sem_affine_p1_tables_size", _AFFINE_P1_TABLES,
                 "AffineP1::Tables (csrc/sem_p1.cuh)"),
                ("sem_general_p1_tables_size", _GENERAL_P1_TABLES,
                 "GeneralP1::Tables (csrc/sem_p1.cuh)")):
            if hasattr(lib, fn) and getattr(lib, fn)() != dt.itemsize:
                raise RuntimeError(f"the layout of {what} differs from "
                                   "ops/kernels.py's")
        _LIBS[source] = lib
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


def _per_rhs(v, k: int, name: str, device) -> torch.Tensor:
    """A (k,) float32 vector of per-RHS scalars, already on the device."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{name}: the batched kernels take a ({k},) float32 "
                        "tensor on the device")
    _require(v, name, (torch.float32,), (k,), device)
    return v


def _check_n(n: int, compiled=SUPPORTED_N) -> None:
    if n not in compiled:
        raise NotImplementedError(
            f"no kernel instantiation for n={n} nodes per element "
            f"(compiled: {compiled})")


def _check_plan(plan: DSSPlan, device) -> None:
    if plan.has_tail:
        raise NotImplementedError(
            "the exchange has pairs outside its roll classes (tails); the "
            "kernels take tail-free plans only")
    if device is not None and plan.device != device:
        raise ValueError(f"plan is on {plan.device}, tensors on {device}")


def _n_rhs(rows: int, n: int) -> int:
    if n <= 0 or rows % n:
        raise ValueError(f"{rows} rows are no stack of {n}-node L-vectors")
    return rows // n


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _local_product(uT, Kst, aT):
    """S = sum_c a_c (K_c u): the element-local affine product of an (n, E)
    array or of each array of a (k, n, E) stack."""
    V = torch.matmul(Kst if uT.dim() == 2 else Kst[:, None], uT)
    return aT[0] * V[0] + aT[1] * V[1] + aT[2] * V[2]


def _general_local(uT, gT, Dh):
    """S = Dh^T [g0 ur + g1 us; g1 ur + g2 us] with [ur; us] = Dh u: the
    element-local product of a curved mesh on an (n, E) array or each
    array of a (k, n, E) stack.  ``gT`` (3, n, E): the factor slabs in lex
    node order; ``Dh`` (2n, n): the stacked derivative with its columns in
    the L-vector (hier) order, so the gradients come out in lex order and
    S in hier order."""
    n = Dh.shape[1]
    grads = torch.matmul(Dh, uT)
    ur, us = grads[..., :n, :], grads[..., n:, :]
    flux = torch.cat([gT[0] * ur + gT[1] * us, gT[1] * ur + gT[2] * us],
                     dim=-2)
    return torch.matmul(Dh.T, flux)


def _col(v, like: torch.Tensor) -> torch.Tensor:
    """Per-RHS scalars (a float, a 0-dim or a (k,) tensor) as (k, 1, 1)."""
    return torch.as_tensor(v, dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


# -- the affine applies' operand: the blocks K_c in tensor-product form -------

#: the by-value table operand of the affine apply kernels (``AffineTables``
#: in csrc/sem_affine.cuh): D and W as float32, the lex-to-row map as
#: uint8, each padded to the largest compiled n
_AFFINE_TABLES = np.dtype([("D", "<f4", (max(SUPPORTED_N),)),
                           ("W", "<f4", (max(SUPPORTED_N),)),
                           ("row", "u1", (max(SUPPORTED_N),))], align=True)


def _tensor_factors(D: np.ndarray, h: np.ndarray):
    """``(D0, D1)`` when ``D`` (2n, n) is ``[D0 (x) I; I (x) D1]`` with its
    columns permuted by ``h`` (L-vector row -> lex node), else None.  Lex
    node (a, b) is a M + b; column j holds lex node h[j], so each factor's
    columns are read through the inverse of ``h``."""
    n = D.shape[1]
    m = int(round(n ** 0.5))
    if m * m != n or D.shape[0] != 2 * n or not np.array_equal(
            np.sort(h), np.arange(n)):
        return None
    hinv = np.argsort(h)
    D0 = D[np.arange(m) * m][:, hinv[np.arange(m) * m]]
    D1 = D[n + np.arange(m)][:, hinv[np.arange(m)]]
    want = np.concatenate([np.kron(D0, np.eye(m)), np.kron(np.eye(m), D1)])
    return (D0, D1) if np.array_equal(D, want[:, h]) else None


class AffineFactors:
    """The affine apply kernels' operand: the element blocks ``K_c`` in
    tensor-product form (``sum_c a_c K_c u = Dr^T fr + Ds^T fs``, see
    csrc/sem_affine.cuh).

    ``Dh`` (2n, n): the stacked derivative ``[D (x) I; I (x) D]`` with its
    columns in the L-vector order ``hier`` ((n,), L-vector row -> lex
    node), as the general kernels take it; ``W`` (n,): the lex quadrature
    weights; ``Kst`` (3, n, n): the blocks these make, as
    :func:`.sumfac.affine_tensor_factors` checked them.  Host arrays: the
    kernels take D, W and the inverse of ``hier`` by value
    (:attr:`tables`).  Raises ``ValueError`` unless ``Dh`` has that form,
    one 1D derivative in both directions.
    """

    def __init__(self, Dh, W, hier, Kst):
        Dh = np.asarray(Dh, np.float64)
        hier = np.asarray(hier, np.int64)
        n = Dh.shape[1]
        fac = _tensor_factors(Dh, hier)
        if fac is None or not np.array_equal(*fac) or n > max(SUPPORTED_N):
            raise ValueError(
                f"Dh ({Dh.shape}) is not [D (x) I; I (x) D] with its columns "
                f"permuted by hier for n <= {max(SUPPORTED_N)}: the affine "
                "kernels take one 1D derivative for both directions")
        self.n = n
        #: the 1D derivative (M, M), lex: D[a, m] = d l_m / dr at node a
        self.D = fac[0]
        self.W = np.asarray(W, np.float64).reshape(n)
        self.hier = hier
        self.Kst = np.asarray(Kst, np.float64).reshape(3, n, n)
        self.tables = np.zeros((), _AFFINE_TABLES)
        self.tables["D"][:n] = self.D.ravel()
        self.tables["W"][:n] = self.W
        self.tables["row"][:n] = np.argsort(hier)
        #: the p = 1 kernel's operand (n = 4 only): the blocks K_c
        self.p1_tables = (np.ascontiguousarray(self.Kst, np.float32)
                          if n == 4 else None)


def _require_factors(factors, Kst: torch.Tensor, what: str) -> int:
    """The host pointer of ``factors``' tables, after checking (once per
    ``Kst`` state) that they make the blocks ``Kst`` the plain version
    uses, to 1e-6 of their max (``Kst`` is float32)."""
    n = Kst.shape[-1]
    if not isinstance(factors, AffineFactors) or factors.n != n:
        raise ValueError(
            f"{what} on CUDA tensors computes sum_c a_c K_c u in "
            "tensor-product form: pass factors= (the AffineFactors of Kst, "
            "as AffineLaplacianT.factors or sumfac.affine_tensor_factors("
            f"Kcat) give them for n={n}); got {factors!r}")
    key = (Kst.data_ptr(), Kst._version, id(factors))
    if getattr(Kst, "_affine_factors_checked", None) != key:
        K = Kst.detach().double().cpu().numpy()
        ref = factors.Kst
        if np.abs(K - ref).max() > 1e-6 * np.abs(ref).max():
            raise ValueError(f"{what}: Kst is not the blocks K_c of the "
                             "given factors")
        Kst._affine_factors_checked = key
    return _operand(factors)


# -- the curved kernels' operand: Dhat in tensor-product form ----------------

#: the by-value table operand of the curved kernels (``GeneralTables`` in
#: csrc/sem_curved.cuh): D0, D1 and their transposes as float32, the
#: lex-to-row map as uint8, each padded to the largest compiled n
_GENERAL_TABLES = np.dtype([("D0", "<f4", (max(SUPPORTED_N),)),
                            ("D1", "<f4", (max(SUPPORTED_N),)),
                            ("D0t", "<f4", (max(SUPPORTED_N),)),
                            ("D1t", "<f4", (max(SUPPORTED_N),)),
                            ("row", "u1", (max(SUPPORTED_N),))], align=True)


class GeneralFactors:
    """The curved kernels' operand: the stacked derivative in tensor-product
    form (``Dh = [D0 (x) I; I (x) D1]`` with its columns permuted by
    ``hier``, see csrc/sem_curved.cuh).

    ``Dh`` (2n, n): the stacked derivative with its columns in the L-vector
    order ``hier`` ((n,), L-vector row -> lex node), as the plain versions
    take it.  Host arrays: the kernels take D0, D1, their transposes and
    the inverse of ``hier`` by value (:attr:`tables`, float32).  Raises
    ``ValueError`` unless ``Dh`` has that form for an n up to the largest
    compiled one: the kernels read nothing else of ``Dh``.
    """

    def __init__(self, Dh, hier):
        Dh = np.asarray(Dh, np.float64)
        hier = np.asarray(hier, np.int64).reshape(-1)
        fac = (_tensor_factors(Dh, hier)
               if Dh.ndim == 2 and hier.shape == Dh.shape[1:] else None)
        if fac is None or Dh.shape[1] > max(SUPPORTED_N):
            raise ValueError(
                f"Dh ({Dh.shape}) is not [D0 (x) I; I (x) D1] with its "
                f"columns permuted by hier for n <= {max(SUPPORTED_N)}: the "
                "curved kernels compute the product in tensor-product form "
                "and take no other Dh")
        n = self.n = Dh.shape[1]
        self.Dh = Dh
        self.hier = hier
        # the 1D derivatives (M, M), lex: D0[a, m] along r, D1[b, c] along s
        D0, D1 = fac
        self.tables = np.zeros((), _GENERAL_TABLES)
        self.tables["D0"][:n] = D0.ravel()
        self.tables["D1"][:n] = D1.ravel()
        self.tables["D0t"][:n] = D0.T.ravel()
        self.tables["D1t"][:n] = D1.T.ravel()
        self.tables["row"][:n] = np.argsort(hier)
        #: the p = 1 kernel's operand (n = 4 only): Dh itself
        self.p1_tables = (np.ascontiguousarray(Dh, np.float32)
                          if n == 4 else None)


def _require_general_factors(factors, Dh: torch.Tensor, hier: torch.Tensor,
                             what: str) -> int:
    """The host pointer of ``factors``' tables, after checking (once per
    ``Dh`` and ``hier`` state) that they are the ``Dh`` (to 1e-6 of its
    max: ``Dh`` is float32) and the ``hier`` the plain version uses."""
    n = Dh.shape[-1]
    if not isinstance(factors, GeneralFactors) or factors.n != n:
        raise ValueError(
            f"{what} on CUDA tensors computes the product in tensor-product "
            "form: pass factors= (the GeneralFactors of Dh and hier, as "
            f"GeneralLaplacianT.factors gives them for n={n}); got "
            f"{factors!r}")
    key = (Dh.data_ptr(), Dh._version, hier.data_ptr(), hier._version,
           id(factors))
    if getattr(Dh, "_general_factors_checked", None) != key:
        D = Dh.detach().double().cpu().numpy()
        h = hier.detach().cpu().numpy()
        ref = factors.Dh
        if (D.shape != ref.shape or not np.array_equal(h, factors.hier)
                or np.abs(D - ref).max() > 1e-6 * np.abs(ref).max()):
            raise ValueError(f"{what}: Dh and hier are not those of the "
                             "given factors")
        Dh._general_factors_checked = key
    return _operand(factors)


def _operand(factors) -> int:
    """The host pointer of the by-value table the kernels read at
    ``factors.n``: the p = 1 kernels' at n = 4, else the tile's."""
    return (factors.p1_tables if factors.n == 4
            else factors.tables).ctypes.data


# -- kernel 1: the operator apply ---------------------------------------------

#: the by-value class table of the p = 1 kernels (``P1Classes`` in
#: csrc/sem_p1.cuh)
_P1_CLASSES = np.dtype([("tile", "<i4"), ("n_windows", "<i4"),
                        ("lo", "<i4", (P1_MAX_WINDOWS,)),
                        ("base", "<i4", (P1_MAX_WINDOWS + 1,)),
                        ("n_entries", "<i4"), ("own_slot", "<i4"),
                        ("delta", "<i4", (P1_MAX_ENTRIES,)),
                        ("slot", "<u2", (P1_MAX_ENTRIES,)),
                        ("mask", "<u2", (P1_MAX_ENTRIES,)),
                        ("bit", "u1", (P1_MAX_ENTRIES,)),
                        ("dst", "u1", (P1_MAX_ENTRIES,)),
                        ("src", "u1", (P1_MAX_ENTRIES,))], align=True)
#: the p = 1 kernels' operands (``AffineP1::Tables``,
#: ``GeneralP1::Tables``): the blocks K_c (3, 4, 4) and Dh (8, 4), float32
_AFFINE_P1_TABLES = np.dtype([("K", "<f4", (3, 4, 4))])
_GENERAL_P1_TABLES = np.dtype([("Dh", "<f4", (8, 4))])


def _p1_windows(deltas, tile: int):
    """The windows of a tile of ``tile`` elements for the sorted
    ``deltas``: ``(lo, hi)`` pairs, a tile's window holding the products
    of its elements shifted by lo .. hi (elements [b0 + lo, b0 + hi +
    tile)); deltas whose element ranges overlap or touch share one."""
    win = []
    for d in deltas:
        if win and d <= win[-1][1] + tile:
            win[-1][1] = d
        else:
            win.append([d, d])
    return win


def p1_classes(plan: DSSPlan, tiles=P1_TILES) -> np.ndarray:
    """The p = 1 kernels' by-value class table of ``plan``: every entry
    ``(dst_row, src_row, delta, mask_index)`` of the plan once, in its CSR
    order (by destination row, the plan's order within a row: the order of
    :func:`.roll_dss_T`'s sums), each entry's bit in the packed mask words
    (:func:`p1_mask_words`), and the windows of products a tile forms in
    shared memory (:func:`_p1_windows` of the plan's deltas and 0), for
    the first tile size of ``tiles`` whose windows fit :data:`P1_SLOTS`
    products.  Built once per plan and ``tiles``, and kept on the plan.
    Raises ``ValueError`` for a plan whose n is not 4, beyond
    :data:`P1_MAX_ENTRIES` entries, or when no tile fits."""
    tiles = tuple(int(T) for T in tiles)
    cache = plan.__dict__.setdefault("_p1_classes", {})
    if tiles in cache:
        return cache[tiles]
    if plan.n != 4:
        raise ValueError(f"the p = 1 class table is for n = 4, not {plan.n}")
    # (src, delta, mask, dst) in CSR order
    ent = plan.entries.cpu().numpy()[:plan.n_entries]
    if len(ent) > P1_MAX_ENTRIES or (len(ent) and ent[:, 2].max() > 65535):
        raise ValueError(f"the plan has {len(ent)} entries; the p = 1 "
                         f"kernels take at most {P1_MAX_ENTRIES}, with mask "
                         "rows below 65,536")
    deltas = sorted({0, *ent[:, 1].tolist()})
    for T in tiles:
        win = _p1_windows(deltas, T)
        size = sum(hi - lo + T for lo, hi in win)
        if len(win) <= P1_MAX_WINDOWS and size <= P1_SLOTS:
            break
    else:
        raise ValueError(f"the plan's deltas {deltas} need more than "
                         f"{P1_SLOTS} products in {P1_MAX_WINDOWS} windows "
                         f"for a tile of {T}: the p = 1 kernels' limit")
    base = np.cumsum([0] + [hi - lo + T for lo, hi in win])
    rows = _p1_mask_rows(plan)

    def slot(d):
        w = next(i for i, (lo, hi) in enumerate(win) if lo <= d <= hi)
        return base[w] + d - win[w][0]

    t = np.zeros((), _P1_CLASSES)
    t["tile"], t["n_windows"], t["n_entries"] = T, len(win), len(ent)
    t["lo"][:len(win)] = [lo for lo, _ in win]
    t["base"][:len(win) + 1] = base
    t["own_slot"] = slot(0)
    for i, (src, delta, mask, dst) in enumerate(ent.tolist()):
        t["slot"][i], t["delta"][i], t["mask"][i] = slot(delta), delta, mask
        t["bit"][i], t["src"][i], t["dst"][i] = rows.index(mask), src, dst
    cache[tiles] = t
    return t


def _p1_mask_rows(plan: DSSPlan) -> list:
    """The class-mask rows the plan's entries read, in order: row
    ``rows[b]`` is bit b of the packed mask words (at most 32, as the
    entries)."""
    return sorted(set(plan.entries.cpu().numpy()[:plan.n_entries, 2]
                      .tolist()))


def p1_mask_words(plan: DSSPlan) -> torch.Tensor:
    """The packed class masks of ``plan`` for the p = 1 kernels: (E,)
    int32 on the plan's device, bit b of element e's word the mask row
    :func:`_p1_mask_rows` ``[b]`` at e.  Built once per plan (its masks are
    static) and kept on it."""
    w = getattr(plan, "_p1_mask_words", None)
    if w is None:
        m = plan.masks.cpu().numpy()[_p1_mask_rows(plan)].astype(np.uint64)
        words = (m << np.arange(len(m), dtype=np.uint64)[:, None]).sum(0)
        w = plan._p1_mask_words = torch.as_tensor(
            words.astype(np.uint32).view(np.int32), device=plan.device)
    return w


def _launch_p1(lib, fn, what, uT, tables, coef, masks, plan, k: int,
               aux: bool):
    """One launch of a p = 1 apply (``fn`` of ``lib``) on CUDA tensors:
    (out, B), B the (k, nb, E) raw rows when ``aux``, else None.  ``masks``
    None: the plan's own, as packed words; else a (C, E) bool runtime
    operand."""
    dev, E = uT.device, uT.shape[-1]
    out = torch.empty_like(uT)
    B = (torch.empty((k, max(plan.nb, 1), E), dtype=torch.float32,
                     device=dev) if aux else None)
    words = p1_mask_words(plan) if masks is None else None
    cls = p1_classes(plan, P1_TILES if k == 1 else P1_TILES_STACK)
    rc = fn(_ptr(uT), tables, _ptr(coef), _ptr(masks), _ptr(words),
            cls.ctypes.data, _ptr(out), _ptr(B), E, plan.nb, k,
            _stream(dev))
    _check(lib, rc, f"{what} (n=4, E={E}, k={k})")
    return out, B


def _with_aux(S, plan: DSSPlan, aux: bool):
    """The roll-class DSS of the local product ``S``, and with ``aux`` the
    raw exchanged rows ``S[:nb]`` beside it."""
    out = roll_dss_T(S, plan)
    return (out, S[..., :plan.nb, :]) if aux else out


def affine_apply_dss_plain(uT, Kst, aT, plan: DSSPlan, *, aux: bool = False):
    """Plain version of :func:`affine_apply_dss` (``torch.matmul`` plus the
    roll-class DSS); also takes a (k, n, E) stack."""
    return _with_aux(_local_product(uT, Kst, aT), plan, aux)


def affine_apply_dss_batched_plain(uT, Kst, aT, plan: DSSPlan):
    """Plain version of :func:`affine_apply_dss_batched`."""
    u3 = uT.reshape(-1, Kst.shape[1], uT.shape[-1])
    return affine_apply_dss_plain(u3, Kst, aT, plan).reshape(uT.shape)


def _launch_apply(uT, Kst, aT, plan, k: int, factors, aux: bool = False):
    """The apply on CUDA tensors: (out, B), B the (k, nb, E) scratch of raw
    exchanged rows (at n = 4 one launch, B only with ``aux``)."""
    dev = _cuda_device(uT)
    _check_plan(plan, dev)
    n, E = Kst.shape[-1], uT.shape[-1]
    _check_n(n, APPLY_N)
    f32 = (torch.float32,)
    _require(uT, "uT", f32, (k * n, E), dev)
    _require(Kst, "Kst", f32, (3, n, n), dev)
    _require(aT, "aT", f32, (3, E), dev)
    tables = _require_factors(factors, Kst, "affine_apply_dss")
    lib = _lib(_APPLY)
    if n == 4:
        return _launch_p1(lib, lib.sem_affine_p1_apply_dss,
                          "affine_apply_dss", uT, tables, aT, None, plan, k,
                          aux)
    out = torch.empty_like(uT)
    B = torch.empty((k, max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    rc = lib.sem_affine_apply_dss(
        _ptr(uT), tables, _ptr(aT), _ptr(out), _ptr(B),
        _ptr(plan.row_ptr), _ptr(plan.entries), _ptr(plan.masks),
        n, E, plan.nb, k, _stream(dev))
    _check(lib, rc, f"affine_apply_dss (n={n}, E={E}, k={k})")
    return out, B


def affine_apply_dss(uT: torch.Tensor, Kst: torch.Tensor, aT: torch.Tensor,
                     plan: DSSPlan, *, aux: bool = False,
                     factors: AffineFactors | None = None):
    """``out = DSS(sum_c a_c K_c u)`` on an (n, E) L-vector.

    ``Kst`` (3, n, n): the blocks ``K_c``; ``aT`` (3, E): the affine scales;
    ``plan``: the exchange's :class:`.DSSPlan` on the tensors' device.
    CUDA tensors must be float32 (a float64 CUDA tensor raises), and the
    kernel computes the product in tensor-product form from ``factors``,
    the :class:`AffineFactors` of ``Kst`` (required there: checked once
    against ``Kst``; the plain version reads ``Kst``).  ``aux=True``
    returns ``(out, aux)``, ``aux`` (nb, E) the raw (pre-DSS) exchanged
    rows of the product, which :func:`far_update` reads.  At n = 4 the
    kernel is one launch, product and DSS together (csrc/sem_p1.cuh), with
    or without ``aux``.
    """
    if uT.device.type == "cpu":
        _check_plan(plan, None)
        return affine_apply_dss_plain(uT, Kst, aT, plan, aux=aux)
    if uT.dim() != 2 or uT.shape[0] != Kst.shape[-1]:
        raise ValueError(f"uT has shape {tuple(uT.shape)}; expected "
                         f"({Kst.shape[-1]}, E)")
    out, B = _launch_apply(uT, Kst, aT, plan, 1, factors, aux)
    _count(affine_apply_dss, Kst.shape[-1])
    return (out, B[0, :plan.nb]) if aux else out


def affine_apply_dss_batched(uT: torch.Tensor, Kst: torch.Tensor,
                             aT: torch.Tensor, plan: DSSPlan, *,
                             factors: AffineFactors | None = None
                             ) -> torch.Tensor:
    """:func:`affine_apply_dss` of each (n, E) block of a (k * n, E) stack:
    the k right-hand sides share ``Kst`` (``factors``), ``aT`` and the
    class tables."""
    k = _n_rhs(uT.shape[0], Kst.shape[-1])
    if uT.device.type == "cpu":
        _check_plan(plan, None)
        return affine_apply_dss_batched_plain(uT, Kst, aT, plan)
    out, _ = _launch_apply(uT, Kst, aT, plan, k, factors)
    _count(affine_apply_dss_batched, Kst.shape[-1])
    return out


# -- kernel A: direction update + apply + denominator partials ----------------

def _cg_a_plain(r, p, inv, x, beta, alpha_prev, local, plan: DSSPlan):
    """Kernel A's arithmetic with the element-local product ``local``:
    ``(p', DSS(S), x' or None, per-element partials of p' . S)`` on an
    (n, E) array or a (k, n, E) stack with (k, 1, 1) scalars."""
    p32 = p.to(r.dtype)
    x_new = None if x is None else x + alpha_prev * p32
    p_st = (inv.to(r.dtype) * r + beta * p32).to(p.dtype)
    ps = p_st.to(r.dtype)
    S = local(ps)
    return p_st, roll_dss_T(S, plan), x_new, (ps * S).sum(-2)


def _cg_a_batched_plain(r, p, inv, x, beta, alpha_prev, n, local,
                        plan: DSSPlan):
    """:func:`_cg_a_plain` on a (k * n, E) stack with (k,) scalars; the
    partials are (E, k)."""
    k = _n_rhs(r.shape[0], n)
    shp = (k, n, r.shape[-1])
    p_st, Ap, x_new, d = _cg_a_plain(
        r.reshape(shp), p.reshape(shp), inv,
        None if x is None else x.reshape(shp), _col(beta, r),
        None if x is None else _col(alpha_prev, r), local, plan)
    return (p_st.reshape(r.shape), Ap.reshape(r.shape),
            None if x is None else x_new.reshape(r.shape), d.T)


def cg_kernel_a_plain(r, p, inv, x, beta, alpha_prev, Kst, aT,
                      plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a` (``x=None``: of
    :func:`cg_kernel_a_deferred`, and ``x'`` is None); the denominator
    partials are one per element.  Also takes (k, n, E) stacks with
    (k, 1, 1) scalars, the partials then (k, E)."""
    return _cg_a_plain(r, p, inv, x, beta, alpha_prev,
                       lambda u: _local_product(u, Kst, aT), plan)


def cg_kernel_a_batched_plain(r, p, inv, x, beta, alpha_prev, Kst, aT,
                              plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a_batched` (``x=None``: of
    :func:`cg_kernel_a_batched_deferred`); the partials are (E, k)."""
    return _cg_a_batched_plain(r, p, inv, x, beta, alpha_prev,
                               Kst.shape[-1],
                               lambda u: _local_product(u, Kst, aT), plan)


def cg_kernel_a_deferred_plain(r, p, inv, beta, Kst, aT, plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a_deferred`."""
    p_st, Ap, _, d = cg_kernel_a_plain(r, p, inv, None, beta, None, Kst, aT,
                                       plan)
    return p_st, Ap, d


def cg_kernel_a_batched_deferred_plain(r, p, inv, beta, Kst, aT,
                                       plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a_batched_deferred`."""
    p_st, Ap, _, d = cg_kernel_a_batched_plain(r, p, inv, None, beta, None,
                                               Kst, aT, plan)
    return p_st, Ap, d


def _launch_a(r, p, inv, x, beta, alpha_prev, Kst, aT, plan, k, tables,
              what):
    """Kernel A on CUDA tensors: (p', Ap', x' or None, (G, k) partials, G
    the tiles of :data:`AFFINE_TILE` elements).  ``beta``/``alpha_prev``
    are float32 device tensors of k elements; ``tables`` the host pointer
    :func:`_require_factors` gave."""
    dev = _cuda_device(r)
    _check_plan(plan, dev)
    n, E = Kst.shape[-1], r.shape[-1]
    _check_n(n)
    f32 = (torch.float32,)
    shape = (k * n, E)
    _require(r, "r", f32, shape, dev)
    _require(p, "p", (torch.float32, torch.bfloat16), shape, dev)
    _require(inv, "inv", (p.dtype,), (n, E), dev)
    _require(Kst, "Kst", f32, (3, n, n), dev)
    _require(aT, "aT", f32, (3, E), dev)
    p_out, ap = torch.empty_like(p), torch.empty_like(r)
    B = torch.empty((k, max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    dparts = torch.empty((-(-E // AFFINE_TILE), k), dtype=torch.float32,
                         device=dev)
    lib = _lib(_CG_A)
    bf16 = p.dtype == torch.bfloat16
    dss = (_ptr(plan.row_ptr), _ptr(plan.entries), _ptr(plan.masks))
    tail = (n, E, plan.nb, k, _stream(dev))
    if x is None:
        x_out = None
        fn = (lib.sem_cg_kernel_a_defer_bf16 if bf16
              else lib.sem_cg_kernel_a_defer_f32)
        rc = fn(_ptr(r), _ptr(p), _ptr(inv), tables, _ptr(aT), _ptr(beta),
                _ptr(p_out), _ptr(ap), _ptr(B), _ptr(dparts), *dss, *tail)
    else:
        _require(x, "x", f32, shape, dev)
        x_out = torch.empty_like(x)
        fn = lib.sem_cg_kernel_a_bf16 if bf16 else lib.sem_cg_kernel_a_f32
        rc = fn(_ptr(r), _ptr(p), _ptr(inv), _ptr(x), tables, _ptr(aT),
                _ptr(beta), _ptr(alpha_prev), _ptr(p_out), _ptr(x_out),
                _ptr(ap), _ptr(B), _ptr(dparts), *dss, *tail)
    _check(lib, rc, f"{what} (n={n}, E={E}, k={k}, p {p.dtype})")
    return p_out, ap, x_out, dparts


def cg_kernel_a(r, p, inv, x, beta, alpha_prev, Kst, aT, plan: DSSPlan, *,
                factors: AffineFactors | None = None):
    """``(p', Ap', x', dparts)`` of one fused PCG iteration (affine mesh).

    ``x' = x + alpha_prev p``; ``p' = inv r + beta p`` stored in ``p``'s
    dtype (float32 or bfloat16, with ``inv`` of the same dtype);
    ``Ap' = DSS(sum_c a_c K_c p')`` from the stored ``p'``; ``dparts`` the
    partial sums of ``p' . S`` before the DSS (their total is
    ``<p', A p'>``; one per tile of :data:`AFFINE_TILE` elements on the
    card, one per element on the CPU).  ``r`` and ``x`` are float32;
    ``beta`` and ``alpha_prev`` are floats or float32 scalars on the
    device.  On CUDA tensors the kernel computes the product from
    ``factors``, the :class:`AffineFactors` of ``Kst`` (required there, as
    in :func:`affine_apply_dss`), so ``Ap'`` is that apply of the stored
    ``p'`` bit for bit.
    """
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_plain(r, p, inv, x, beta, alpha_prev, Kst, aT,
                                 plan)
    tables = _require_factors(factors, Kst, "cg_kernel_a")
    dev = _cuda_device(r)
    p_out, ap, x_out, dparts = _launch_a(
        r, p, inv, x, _scalar(beta, dev), _scalar(alpha_prev, dev), Kst, aT,
        plan, 1, tables, "cg_kernel_a")
    _count(cg_kernel_a, Kst.shape[-1])
    return p_out, ap, x_out, dparts.view(-1)


def cg_kernel_a_deferred(r, p, inv, beta, Kst, aT, plan: DSSPlan, *,
                         factors: AffineFactors | None = None):
    """``(p', Ap', dparts)``: :func:`cg_kernel_a` without the x update
    (``defer_x``: the CG driver catches x up once per m iterations)."""
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_deferred_plain(r, p, inv, beta, Kst, aT, plan)
    tables = _require_factors(factors, Kst, "cg_kernel_a_deferred")
    dev = _cuda_device(r)
    p_out, ap, _, dparts = _launch_a(r, p, inv, None, _scalar(beta, dev),
                                     None, Kst, aT, plan, 1, tables,
                                     "cg_kernel_a_deferred")
    _count(cg_kernel_a_deferred, Kst.shape[-1])
    return p_out, ap, dparts.view(-1)


def cg_kernel_a_batched(r, p, inv, x, beta, alpha_prev, Kst, aT,
                        plan: DSSPlan, *,
                        factors: AffineFactors | None = None):
    """:func:`cg_kernel_a` for a (k * n, E) stack of k right-hand sides:
    ``r``, ``p``, ``x`` are stacks, ``inv`` (n, E) is shared, ``beta`` and
    ``alpha_prev`` are (k,) float32 device tensors, the partials (G, k)."""
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_batched_plain(r, p, inv, x, beta, alpha_prev,
                                         Kst, aT, plan)
    tables = _require_factors(factors, Kst, "cg_kernel_a_batched")
    dev = _cuda_device(r)
    k = _n_rhs(r.shape[0], Kst.shape[-1])
    out = _launch_a(r, p, inv, x, _per_rhs(beta, k, "beta", dev),
                    _per_rhs(alpha_prev, k, "alpha_prev", dev), Kst, aT,
                    plan, k, tables, "cg_kernel_a_batched")
    _count(cg_kernel_a_batched, Kst.shape[-1])
    return out


def cg_kernel_a_batched_deferred(r, p, inv, beta, Kst, aT, plan: DSSPlan, *,
                                 factors: AffineFactors | None = None):
    """``(p', Ap', dparts)``: :func:`cg_kernel_a_batched` without x."""
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_batched_deferred_plain(r, p, inv, beta, Kst, aT,
                                                  plan)
    tables = _require_factors(factors, Kst, "cg_kernel_a_batched_deferred")
    dev = _cuda_device(r)
    k = _n_rhs(r.shape[0], Kst.shape[-1])
    p_out, ap, _, dparts = _launch_a(
        r, p, inv, None, _per_rhs(beta, k, "beta", dev), None, Kst, aT, plan,
        k, tables, "cg_kernel_a_batched_deferred")
    _count(cg_kernel_a_batched_deferred, Kst.shape[-1])
    return p_out, ap, dparts


# -- kernel B: residual update + the two weighted reductions ------------------

def cg_kernel_b_plain(r, Ap, inv, w_free, alpha):
    """Plain version of :func:`cg_kernel_b`; partials one per element
    (also of a (k, n, E) stack with (k, 1, 1) ``alpha``: (k, E))."""
    r_new = r - alpha * Ap
    w = w_free.to(r.dtype)
    z = inv.to(r.dtype) * r_new
    return r_new, (w * r_new * z).sum(-2), (w * r_new * r_new).sum(-2)


def cg_kernel_b_batched_plain(r, Ap, inv, w_free, alpha):
    """Plain version of :func:`cg_kernel_b_batched`; partials (E, k)."""
    k = _n_rhs(r.shape[0], inv.shape[0])
    shp = (k, *inv.shape)
    r_new, rz, rn = cg_kernel_b_plain(r.reshape(shp), Ap.reshape(shp), inv,
                                      w_free, _col(alpha, r))
    return r_new.reshape(r.shape), rz.T, rn.T


def _launch_b(r, Ap, inv, w_free, alpha, k, what):
    dev = _cuda_device(r)
    per = inv.numel()
    f32 = (torch.float32,)
    _require(r, "r", f32, (k * inv.shape[0], *inv.shape[1:]), dev)
    _require(Ap, "Ap", f32, tuple(r.shape), dev)
    _require(inv, "inv", (torch.float32, torch.bfloat16), tuple(inv.shape),
             dev)
    _require(w_free, "w_free", (inv.dtype,), tuple(inv.shape), dev)
    lib = _lib(_CG_B)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, -(-BLOCKS_PER_SM_B * sms // k))
    r_out = torch.empty_like(r)
    parts = torch.empty((2, blocks, k), dtype=torch.float32, device=dev)
    fn = (lib.sem_cg_kernel_b_bf16 if inv.dtype == torch.bfloat16
          else lib.sem_cg_kernel_b_f32)
    rc = fn(_ptr(r), _ptr(Ap), _ptr(inv), _ptr(w_free), _ptr(alpha),
            _ptr(r_out), _ptr(parts), per, blocks, k, _stream(dev))
    _check(lib, rc, f"{what} (shape={tuple(r.shape)}, k={k}, "
                    f"inv {inv.dtype})")
    return r_out, parts[0], parts[1]


def cg_kernel_b(r, Ap, inv, w_free, alpha):
    """``(r', rz_parts, rn2_parts)``: ``r' = r - alpha Ap`` and partial sums
    of ``<w r', inv r'>`` and ``<w r', r'>``.  ``r`` and ``Ap`` are
    float32; ``inv`` and ``w_free`` float32 or both bfloat16, of ``r``'s
    shape."""
    if r.device.type == "cpu":
        return cg_kernel_b_plain(r, Ap, inv, w_free, alpha)
    dev = _cuda_device(r)
    if tuple(inv.shape) != tuple(r.shape):
        raise ValueError(f"inv has shape {tuple(inv.shape)}, r "
                         f"{tuple(r.shape)}")
    r_out, rz, rn = _launch_b(r, Ap, inv, w_free, _scalar(alpha, dev), 1,
                              "cg_kernel_b")
    _count(cg_kernel_b, inv.shape[0])
    return r_out, rz.view(-1), rn.view(-1)


def cg_kernel_b_batched(r, Ap, inv, w_free, alpha):
    """:func:`cg_kernel_b` for a (k * n, E) stack: ``inv`` and ``w_free``
    (n, E) are shared, ``alpha`` is a (k,) float32 device tensor, the
    partials are (G, k)."""
    k = _n_rhs(r.shape[0], inv.shape[0])
    if r.device.type == "cpu":
        return cg_kernel_b_batched_plain(r, Ap, inv, w_free, alpha)
    dev = _cuda_device(r)
    out = _launch_b(r, Ap, inv, w_free, _per_rhs(alpha, k, "alpha", dev), k,
                    "cg_kernel_b_batched")
    _count(cg_kernel_b_batched, inv.shape[0])
    return out


def make_fused_cg_kernels(Kst: torch.Tensor, aT: torch.Tensor,
                          plan: DSSPlan, *, defer_x: bool = False,
                          factors: AffineFactors | None = None):
    """``(kA, kB)`` for :func:`..solver.cg.cg_fused`: kernel A bound to one
    affine operator (``Kst``, ``aT``, ``plan`` and ``factors``, the
    :class:`AffineFactors` its kernel reads on a CUDA device), and kernel
    B.

    ``defer_x=True``: ``kA(r, p, inv, beta) -> (p', Ap', dparts)`` without
    the x update, for ``cg_fused(defer_x=m)``; otherwise
    ``kA(r, p, inv, x, beta, alpha_prev) -> (p', Ap', x', dparts)``.
    ``kA.defer_x`` records which, ``kA.factors`` the factors."""
    if defer_x:
        def kA(r, p, inv, beta):
            return cg_kernel_a_deferred(r, p, inv, beta, Kst, aT, plan,
                                        factors=factors)
    else:
        def kA(r, p, inv, x, beta, alpha_prev):
            return cg_kernel_a(r, p, inv, x, beta, alpha_prev, Kst, aT, plan,
                               factors=factors)
    kA.defer_x, kA.n_rhs, kA.factors = bool(defer_x), 1, factors
    return kA, cg_kernel_b


def make_fused_cg_kernels_batched(Kst: torch.Tensor, aT: torch.Tensor,
                                  plan: DSSPlan, n_rhs: int, *,
                                  defer_x: bool = False,
                                  factors: AffineFactors | None = None):
    """``(kA, kB)`` for :func:`..solver.cg.cg_fused_batched` on (k * n, E)
    stacks of ``n_rhs`` right-hand sides (per-RHS scalars (k,), partials
    (G, k)); ``defer_x`` and ``factors`` as in
    :func:`make_fused_cg_kernels`."""
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    if defer_x:
        def kA(r, p, inv, beta):
            return cg_kernel_a_batched_deferred(r, p, inv, beta, Kst, aT,
                                                plan, factors=factors)
    else:
        def kA(r, p, inv, x, beta, alpha_prev):
            return cg_kernel_a_batched(r, p, inv, x, beta, alpha_prev, Kst,
                                       aT, plan, factors=factors)
    kA.defer_x, kA.n_rhs, kA.factors = bool(defer_x), int(n_rhs), factors
    return kA, cg_kernel_b_batched


# -- curved meshes: the general apply and its kernel A ------------------------

def general_apply_dss_plain(uT, gT, Dh, hier, plan: DSSPlan, *,
                            aux: bool = False):
    """Plain version of :func:`general_apply_dss` (``torch.matmul`` with the
    dense stacked derivative, the flux, the roll-class DSS; ``hier`` is
    already folded into ``Dh``); also takes a (k, n, E) stack."""
    return _with_aux(_general_local(uT, gT, Dh), plan, aux)


def general_apply_dss_batched_plain(uT, gT, Dh, hier, plan: DSSPlan):
    """Plain version of :func:`general_apply_dss_batched`."""
    u3 = uT.reshape(-1, Dh.shape[1], uT.shape[-1])
    return general_apply_dss_plain(u3, gT, Dh, hier, plan).reshape(uT.shape)


def _launch_general_apply(uT, gT, Dh, plan, k: int, tables: int,
                          aux: bool = False):
    """The general apply on CUDA tensors: (out, B) as in
    :func:`_launch_apply`; ``tables`` the host pointer
    :func:`_require_general_factors` gave."""
    dev = _cuda_device(uT)
    _check_plan(plan, dev)
    n, E = Dh.shape[1], uT.shape[-1]
    _check_n(n, APPLY_N)
    f32 = (torch.float32,)
    _require(uT, "uT", f32, (k * n, E), dev)
    _require(gT, "gT", f32, (3, n, E), dev)
    lib = _lib(_GEN_APPLY)
    if n == 4:
        return _launch_p1(lib, lib.sem_general_p1_apply_dss,
                          "general_apply_dss", uT, tables, gT, None, plan, k,
                          aux)
    out = torch.empty_like(uT)
    B = torch.empty((k, max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    rc = lib.sem_general_apply_dss(
        _ptr(uT), tables, _ptr(gT), _ptr(out), _ptr(B),
        _ptr(plan.row_ptr), _ptr(plan.entries), _ptr(plan.masks),
        n, E, plan.nb, k, _stream(dev))
    _check(lib, rc, f"general_apply_dss (n={n}, E={E}, k={k})")
    return out, B


def general_apply_dss(uT: torch.Tensor, gT: torch.Tensor, Dh: torch.Tensor,
                      hier: torch.Tensor, plan: DSSPlan, *,
                      aux: bool = False,
                      factors: GeneralFactors | None = None):
    """``out = DSS(Dh^T [g0 ur + g1 us; g1 ur + g2 us])``, ``[ur; us] =
    Dh u``, on an (n, E) L-vector of a curved mesh.

    ``gT`` (3, n, E): the geometric-factor slabs in lex node order; ``Dh``
    (2n, n): the stacked derivative ``[D0 (x) I; I (x) D1]`` with its
    columns in the L-vector order ``hier`` ((n,) int32, L-vector row ->
    lex node); ``plan``: the exchange's :class:`.DSSPlan` on the tensors'
    device.  CUDA tensors must be float32, and the kernel computes the
    product in tensor-product form from ``factors``, the
    :class:`GeneralFactors` of ``Dh`` and ``hier`` (required there:
    checked once against them; the plain version reads ``Dh``).  ``aux``
    as in :func:`affine_apply_dss`.
    """
    if uT.device.type == "cpu":
        _check_plan(plan, None)
        return general_apply_dss_plain(uT, gT, Dh, hier, plan, aux=aux)
    tables = _require_general_factors(factors, Dh, hier, "general_apply_dss")
    if uT.dim() != 2 or uT.shape[0] != Dh.shape[1]:
        raise ValueError(f"uT has shape {tuple(uT.shape)}; expected "
                         f"({Dh.shape[1]}, E)")
    out, B = _launch_general_apply(uT, gT, Dh, plan, 1, tables, aux)
    _count(general_apply_dss, Dh.shape[1])
    return (out, B[0, :plan.nb]) if aux else out


def general_apply_dss_batched(uT: torch.Tensor, gT: torch.Tensor,
                              Dh: torch.Tensor, hier: torch.Tensor,
                              plan: DSSPlan, *,
                              factors: GeneralFactors | None = None
                              ) -> torch.Tensor:
    """:func:`general_apply_dss` of each (n, E) block of a (k * n, E)
    stack: the k right-hand sides share the slabs, ``Dh`` (``factors``)
    and the class tables."""
    k = _n_rhs(uT.shape[0], Dh.shape[1])
    if uT.device.type == "cpu":
        _check_plan(plan, None)
        return general_apply_dss_batched_plain(uT, gT, Dh, hier, plan)
    tables = _require_general_factors(factors, Dh, hier,
                                      "general_apply_dss_batched")
    out, _ = _launch_general_apply(uT, gT, Dh, plan, k, tables)
    _count(general_apply_dss_batched, Dh.shape[1])
    return out


def cg_kernel_a_general_plain(r, p, inv, x, beta, alpha_prev, gT, Dh, hier,
                              plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a_general`; the denominator
    partials are one per element."""
    return _cg_a_plain(r, p, inv, x, beta, alpha_prev,
                       lambda u: _general_local(u, gT, Dh), plan)


def cg_kernel_a_general_batched_plain(r, p, inv, x, beta, alpha_prev, gT,
                                      Dh, hier, plan: DSSPlan):
    """Plain version of :func:`cg_kernel_a_general_batched`; the partials
    are (E, k)."""
    return _cg_a_batched_plain(r, p, inv, x, beta, alpha_prev, Dh.shape[1],
                               lambda u: _general_local(u, gT, Dh), plan)


def _launch_a_general(r, p, inv, x, beta, alpha_prev, gT, Dh, plan, k,
                      tables, what):
    """General kernel A on CUDA tensors: (p', Ap', x', (G, k) partials, G
    the tiles of :data:`GENERAL_TILE` elements); ``tables`` the host
    pointer :func:`_require_general_factors` gave."""
    dev = _cuda_device(r)
    _check_plan(plan, dev)
    n, E = Dh.shape[1], r.shape[-1]
    _check_n(n)
    f32 = (torch.float32,)
    shape = (k * n, E)
    _require(r, "r", f32, shape, dev)
    _require(p, "p", (torch.float32, torch.bfloat16), shape, dev)
    _require(inv, "inv", (p.dtype,), (n, E), dev)
    _require(x, "x", f32, shape, dev)
    _require(gT, "gT", f32, (3, n, E), dev)
    p_out, ap, x_out = torch.empty_like(p), torch.empty_like(r), \
        torch.empty_like(x)
    B = torch.empty((k, max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    dparts = torch.empty((-(-E // GENERAL_TILE), k), dtype=torch.float32,
                         device=dev)
    lib = _lib(_GEN_CG_A)
    fn = (lib.sem_cg_kernel_a_general_bf16 if p.dtype == torch.bfloat16
          else lib.sem_cg_kernel_a_general_f32)
    rc = fn(_ptr(r), _ptr(p), _ptr(inv), _ptr(x), tables, _ptr(gT),
            _ptr(beta), _ptr(alpha_prev), _ptr(p_out), _ptr(x_out), _ptr(ap),
            _ptr(B), _ptr(dparts), _ptr(plan.row_ptr), _ptr(plan.entries),
            _ptr(plan.masks), n, E, plan.nb, k, _stream(dev))
    _check(lib, rc, f"{what} (n={n}, E={E}, k={k}, p {p.dtype})")
    return p_out, ap, x_out, dparts


def cg_kernel_a_general(r, p, inv, x, beta, alpha_prev, gT, Dh, hier,
                        plan: DSSPlan, *,
                        factors: GeneralFactors | None = None):
    """``(p', Ap', x', dparts)`` of one fused PCG iteration on a curved
    mesh: :func:`cg_kernel_a` with the apply of :func:`general_apply_dss`
    (``gT``, ``Dh``, ``hier`` and, on CUDA tensors, ``factors`` as
    there), so ``Ap'`` is that apply of the stored ``p'`` bit for bit.
    There is no deferred-x variant, as in the reference."""
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_general_plain(r, p, inv, x, beta, alpha_prev, gT,
                                         Dh, hier, plan)
    tables = _require_general_factors(factors, Dh, hier,
                                      "cg_kernel_a_general")
    dev = _cuda_device(r)
    p_out, ap, x_out, dparts = _launch_a_general(
        r, p, inv, x, _scalar(beta, dev), _scalar(alpha_prev, dev), gT, Dh,
        plan, 1, tables, "cg_kernel_a_general")
    _count(cg_kernel_a_general, Dh.shape[1])
    return p_out, ap, x_out, dparts.view(-1)


def cg_kernel_a_general_batched(r, p, inv, x, beta, alpha_prev, gT, Dh, hier,
                                plan: DSSPlan, *,
                                factors: GeneralFactors | None = None):
    """:func:`cg_kernel_a_general` for a (k * n, E) stack of k right-hand
    sides (``inv`` (n, E) shared, ``beta`` and ``alpha_prev`` (k,) float32
    device tensors, the partials (G, k))."""
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_a_general_batched_plain(r, p, inv, x, beta,
                                                 alpha_prev, gT, Dh, hier,
                                                 plan)
    tables = _require_general_factors(factors, Dh, hier,
                                      "cg_kernel_a_general_batched")
    dev = _cuda_device(r)
    k = _n_rhs(r.shape[0], Dh.shape[1])
    out = _launch_a_general(r, p, inv, x, _per_rhs(beta, k, "beta", dev),
                            _per_rhs(alpha_prev, k, "alpha_prev", dev), gT,
                            Dh, plan, k, tables,
                            "cg_kernel_a_general_batched")
    _count(cg_kernel_a_general_batched, Dh.shape[1])
    return out


def make_fused_cg_kernels_general(gT: torch.Tensor, Dh: torch.Tensor,
                                  hier: torch.Tensor, plan: DSSPlan,
                                  n_rhs: int | None = None, *,
                                  factors: GeneralFactors | None = None):
    """``(kA, kB)`` on a curved mesh: the general kernel A bound to one
    operator (``gT``, ``Dh``, ``hier``, ``plan`` and ``factors``, the
    :class:`GeneralFactors` its kernel reads on a CUDA device) and the
    shared kernel B, for :func:`..solver.cg.cg_fused` (``n_rhs=None``) or,
    for a stack of ``n_rhs`` right-hand sides (1 included), for
    :func:`..solver.cg.cg_fused_batched`.

    ``kA(r, p, inv, x, beta, alpha_prev) -> (p', Ap', x', dparts)``.  The
    general kernels have no deferred-x mode: ``kA.defer_x`` is False and
    ``kA.offers_defer_x`` makes :func:`..solver.cg.cg_fused` and
    ``cg_fused_batched`` refuse ``defer_x``.  ``kA.factors`` records the
    factors."""
    if n_rhs is not None and n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    fn = (cg_kernel_a_general if n_rhs is None
          else cg_kernel_a_general_batched)

    def kA(r, p, inv, x, beta, alpha_prev):
        return fn(r, p, inv, x, beta, alpha_prev, gT, Dh, hier, plan,
                  factors=factors)

    kA.defer_x, kA.offers_defer_x = False, False
    kA.n_rhs = 1 if n_rhs is None else int(n_rhs)
    kA.factors = factors
    return kA, cg_kernel_b if n_rhs is None else cg_kernel_b_batched


# -- the element-sharded operator's block apply -------------------------------

def affine_block_apply_dss_plain(uT_ext, Kst, aT_ext, M_ext,
                                 block_plan: DSSPlan):
    """Plain version of :func:`affine_block_apply_dss`: the local product
    and the roll-class DSS with the runtime masks, a source outside the
    block counting as zero."""
    return roll_dss_T(_local_product(uT_ext, Kst, aT_ext), block_plan,
                      masks=M_ext)


def affine_block_apply_dss(uT_ext: torch.Tensor, Kst: torch.Tensor,
                           aT_ext: torch.Tensor, M_ext: torch.Tensor,
                           block_plan: DSSPlan, *,
                           factors: AffineFactors | None = None
                           ) -> torch.Tensor:
    """``DSS(sum_c a_c K_c u)`` on one shard's halo-extended (n, E_ext)
    block: the reference's ``apply_block(uT, aT, M)``.

    ``Kst`` (3, n, n): the blocks ``K_c``; ``aT_ext`` (3, E_ext) and
    ``M_ext`` (C, E_ext) bool: the block's slices of the global affine
    scales and class masks (runtime operands: each shard has its own);
    ``block_plan``: the exchange's classes on E_ext elements
    (:meth:`.DSSPlan.block_view`).  Sources outside the block count as
    zero, so the result is exact on the columns at least the largest
    |delta| from either end (the shard's centre).  CUDA tensors must be
    float32; ``factors`` as in :func:`affine_apply_dss`.
    """
    if uT_ext.device.type == "cpu":
        _check_plan(block_plan, None)
        return affine_block_apply_dss_plain(uT_ext, Kst, aT_ext, M_ext,
                                            block_plan)
    dev = _cuda_device(uT_ext)
    _check_plan(block_plan, dev)
    n, E = Kst.shape[-1], uT_ext.shape[-1]
    _check_n(n, APPLY_N)
    f32 = (torch.float32,)
    _require(uT_ext, "uT_ext", f32, (n, E), dev)
    _require(Kst, "Kst", f32, (3, n, n), dev)
    _require(aT_ext, "aT_ext", f32, (3, E), dev)
    _require(M_ext, "M_ext", (torch.bool,), (M_ext.shape[0], E), dev)
    if block_plan.E != E or M_ext.shape[0] < block_plan.n_classes:
        raise ValueError(f"block plan of E={block_plan.E} with "
                         f"{block_plan.n_classes} classes; got E={E} and "
                         f"{M_ext.shape[0]} mask rows")
    tables = _require_factors(factors, Kst, "affine_block_apply_dss")
    lib = _lib(_APPLY)
    if n == 4:
        out, _ = _launch_p1(lib, lib.sem_affine_p1_apply_dss,
                            "affine_block_apply_dss", uT_ext, tables, aT_ext,
                            M_ext, block_plan, 1, False)
    else:
        out = torch.empty_like(uT_ext)
        B = torch.empty((max(block_plan.nb, 1), E), dtype=torch.float32,
                        device=dev)
        rc = lib.sem_affine_block_apply_dss(
            _ptr(uT_ext), tables, _ptr(aT_ext), _ptr(M_ext), _ptr(out),
            _ptr(B), _ptr(block_plan.row_ptr), _ptr(block_plan.entries), n,
            E, block_plan.nb, _stream(dev))
        _check(lib, rc, f"affine_block_apply_dss (n={n}, E={E})")
    _count(affine_block_apply_dss, Kst.shape[-1])
    return out


# -- the far-class update of a split DSS --------------------------------------

#: the most far entries (and destination rows) a plan may have
#: (``kFarMaxEntries`` in csrc/far_update.cu)
FAR_MAX_ENTRIES = 128
#: the by-value table operand of the far update (``FarTables`` in
#: csrc/far_update.cu): the destination rows, their first entries, and per
#: entry its source row, class mask and element offset
_FAR_TABLES = np.dtype([("n_rows", "<i4"),
                        ("dst", "u1", (FAR_MAX_ENTRIES,)),
                        ("first", "u1", (FAR_MAX_ENTRIES + 1,)),
                        ("src", "u1", (FAR_MAX_ENTRIES,)),
                        ("mask", "u1", (FAR_MAX_ENTRIES,)),
                        ("delta", "<i4", (FAR_MAX_ENTRIES,))], align=True)


def far_tables(far_plan: DSSPlan) -> np.ndarray:
    """The far update's by-value operand of ``far_plan`` (built once per
    plan and kept on it): the rows with entries in order, each row's
    entries in the plan's order (class order within a row).  Raises
    ``ValueError`` beyond :data:`FAR_MAX_ENTRIES` entries or for a row or
    class index past 255."""
    t = getattr(far_plan, "_far_tables", None)
    if t is not None:
        return t
    ent = far_plan.entries.cpu().numpy()[:far_plan.n_entries]
    if len(ent) > FAR_MAX_ENTRIES:
        raise ValueError(f"the far plan has {len(ent)} entries; the far "
                         f"update takes at most {FAR_MAX_ENTRIES}")
    if len(ent) and (ent[:, [0, 2, 3]].max() > 255
                     or ent[:, [0, 2, 3]].min() < 0):
        raise ValueError("the far update takes rows and class masks below "
                         "256")
    # DSSPlan sorts its entries by row, stably: class order within a row
    src, delta, mask, dst = ent.T if len(ent) else (np.zeros(0, int),) * 4
    rows, first = np.unique(dst, return_index=True)
    t = np.zeros((), _FAR_TABLES)
    t["n_rows"] = len(rows)
    t["dst"][:len(rows)] = rows
    t["first"][:len(rows) + 1] = np.append(first, len(ent))
    t["src"][:len(ent)] = src
    t["mask"][:len(ent)] = mask
    t["delta"][:len(ent)] = delta
    far_plan._far_tables = t
    return t


def far_update_plain(out, aux, far_plan: DSSPlan):
    """Plain version of :func:`far_update`: per far class, ``out[dst rows]
    += where(mask, roll(aux[src rows], -delta), 0)``, in place."""
    return roll_dss_T(aux, far_plan, out=out)


def far_update(out: torch.Tensor, aux: torch.Tensor,
               far_plan: DSSPlan) -> torch.Tensor:
    """Add every far class's masked, rolled source rows of ``aux`` into the
    exchanged rows of ``out``, in place; returns ``out``.

    ``out`` (n, E): an apply's output whose DSS gathered the near classes
    only; ``aux`` (nb, E): the raw exchanged rows of its product (the
    applies' ``aux=True``); ``far_plan``: the far half of
    :meth:`.DSSPlan.split`, at most :data:`FAR_MAX_ENTRIES` entries (the
    kernel takes them by value, :func:`far_tables`).  CUDA tensors must be
    float32.
    """
    if out.device.type == "cpu":
        _check_plan(far_plan, None)
        return far_update_plain(out, aux, far_plan)
    dev = _cuda_device(out)
    _check_plan(far_plan, dev)
    E = far_plan.E
    f32 = (torch.float32,)
    _require(out, "out", f32, (out.shape[0], E), dev)
    _require(aux, "aux", f32, (far_plan.nb, E), dev)
    if out.shape[0] < far_plan.nb:
        raise ValueError(f"out has {out.shape[0]} rows; the plan exchanges "
                         f"{far_plan.nb}")
    tables = far_tables(far_plan)
    lib = _lib(_FAR)
    rc = lib.sem_far_update(_ptr(out), _ptr(aux), _ptr(far_plan.masks),
                            tables.ctypes.data, E, _stream(dev))
    _check(lib, rc, f"far_update (E={E}, {far_plan.n_entries} entries)")
    _count(far_update, out.shape[0])
    return out


# -- the single-kernel iteration: residual update + kernel A + all dots ------

def cg_kernel_single_plain(r, Ap, p, x, inv, w_free, alpha_prev, beta, Kst,
                           aT, plan: DSSPlan):
    """Plain version of :func:`cg_kernel_single` (``x=None``: of
    :func:`cg_kernel_single_deferred`, and ``x'`` is None): kernel A's
    arithmetic on ``r' = r - alpha_prev Ap``, then the partials of
    :data:`SINGLE_PARTS`, one row per element, (E, 5)."""
    r_new = r - alpha_prev * Ap
    p_st, Ap_new, x_new, denom = _cg_a_plain(
        r_new, p, inv, x, beta, alpha_prev,
        lambda u: _local_product(u, Kst, aT), plan)
    w = w_free.to(r.dtype)
    iv = inv.to(r.dtype)
    inv_ap = iv * Ap_new
    parts = torch.stack([denom, (w * r_new * inv_ap).sum(-2),
                         (w * Ap_new * inv_ap).sum(-2),
                         (w * r_new * (iv * r_new)).sum(-2),
                         (w * r_new * r_new).sum(-2)], dim=-1)
    return r_new, p_st, Ap_new, x_new, parts


def cg_kernel_single_deferred_plain(r, Ap, p, inv, w_free, alpha_prev, beta,
                                    Kst, aT, plan: DSSPlan):
    """Plain version of :func:`cg_kernel_single_deferred`."""
    r_new, p_st, Ap_new, _, parts = cg_kernel_single_plain(
        r, Ap, p, None, inv, w_free, alpha_prev, beta, Kst, aT, plan)
    return r_new, p_st, Ap_new, parts


def _launch_single(r, Ap, p, x, inv, w_free, alpha_prev, beta, Kst, aT,
                   plan, tables, what):
    """The single kernel on CUDA tensors: (r', p', Ap', x' or None, parts
    (G_tile + G_gather, 5)): a row per tile of :data:`AFFINE_TILE`
    elements, then, when the plan exchanges rows, a row per gather block of
    :data:`THREADS` elements (c1 and c2 of the exchanged rows)."""
    dev = _cuda_device(r)
    _check_plan(plan, dev)
    n, E = Kst.shape[-1], r.shape[-1]
    _check_n(n)
    f32 = (torch.float32,)
    shape = (n, E)
    _require(r, "r", f32, shape, dev)
    _require(Ap, "Ap", f32, shape, dev)
    _require(p, "p", (torch.float32, torch.bfloat16), shape, dev)
    _require(inv, "inv", (p.dtype,), shape, dev)
    _require(w_free, "w_free", (p.dtype,), shape, dev)
    _require(Kst, "Kst", f32, (3, n, n), dev)
    _require(aT, "aT", f32, (3, E), dev)
    r_out, p_out, ap = (torch.empty_like(r), torch.empty_like(p),
                        torch.empty_like(r))
    B = torch.empty((max(plan.nb, 1), E), dtype=torch.float32, device=dev)
    rows = -(-E // AFFINE_TILE) + (-(-E // THREADS) if plan.nb else 0)
    parts = torch.empty((rows, len(SINGLE_PARTS)), dtype=torch.float32,
                        device=dev)
    lib = _lib(_SINGLE)
    bf16 = p.dtype == torch.bfloat16
    head = (_ptr(r), _ptr(Ap), _ptr(p))
    ops = (_ptr(inv), _ptr(w_free), tables, _ptr(aT), _ptr(alpha_prev),
           _ptr(beta))
    tail = (_ptr(B), _ptr(parts), _ptr(plan.row_ptr), _ptr(plan.entries),
            _ptr(plan.masks), n, E, plan.nb, _stream(dev))
    if x is None:
        x_out = None
        fn = (lib.sem_cg_kernel_single_defer_bf16 if bf16
              else lib.sem_cg_kernel_single_defer_f32)
        rc = fn(*head, *ops, _ptr(r_out), _ptr(p_out), _ptr(ap), *tail)
    else:
        _require(x, "x", f32, shape, dev)
        x_out = torch.empty_like(x)
        fn = (lib.sem_cg_kernel_single_bf16 if bf16
              else lib.sem_cg_kernel_single_f32)
        rc = fn(*head, _ptr(x), *ops, _ptr(r_out), _ptr(p_out), _ptr(ap),
                _ptr(x_out), *tail)
    _check(lib, rc, f"{what} (n={n}, E={E}, p {p.dtype})")
    return r_out, p_out, ap, x_out, parts


def cg_kernel_single(r, Ap, p, x, inv, w_free, alpha_prev, beta, Kst, aT,
                     plan: DSSPlan, *, factors: AffineFactors | None = None):
    """``(r', p', Ap', x', parts)``: one whole PCG iteration (affine mesh).

    ``r' = r - alpha_prev Ap`` (the previous iteration's residual update,
    ``Ap`` its ``Ap'``); ``p' = inv r' + beta p`` stored in ``p``'s dtype;
    ``Ap' = DSS(sum_c a_c K_c p')`` from the stored ``p'``;
    ``x' = x + alpha_prev p``; ``parts`` (rows, 5): partial sums, over
    their rows, of ``[<p', A p'>`` (before the DSS), ``<r', inv Ap'>_w``,
    ``<Ap', inv Ap'>_w``, ``<r', inv r'>_w``, ``<r', r'>_w]``
    (:data:`SINGLE_PARTS`).  ``r``, ``Ap`` and ``x`` are float32; ``p``,
    ``inv`` and ``w_free`` float32 or all bfloat16; ``alpha_prev`` and
    ``beta`` floats or float32 scalars on the device.  ``factors`` as in
    :func:`cg_kernel_a` (required on CUDA tensors: ``Ap'`` is then
    :func:`affine_apply_dss` of the stored ``p'`` bit for bit).
    """
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_single_plain(r, Ap, p, x, inv, w_free, alpha_prev,
                                      beta, Kst, aT, plan)
    tables = _require_factors(factors, Kst, "cg_kernel_single")
    dev = _cuda_device(r)
    out = _launch_single(r, Ap, p, x, inv, w_free, _scalar(alpha_prev, dev),
                         _scalar(beta, dev), Kst, aT, plan, tables,
                         "cg_kernel_single")
    _count(cg_kernel_single, Kst.shape[-1])
    return out


def cg_kernel_single_deferred(r, Ap, p, inv, w_free, alpha_prev, beta, Kst,
                              aT, plan: DSSPlan, *,
                              factors: AffineFactors | None = None):
    """``(r', p', Ap', parts)``: :func:`cg_kernel_single` without the x
    update (``defer_x``: the CG driver catches x up once per m
    iterations)."""
    if r.device.type == "cpu":
        _check_plan(plan, None)
        return cg_kernel_single_deferred_plain(r, Ap, p, inv, w_free,
                                               alpha_prev, beta, Kst, aT,
                                               plan)
    tables = _require_factors(factors, Kst, "cg_kernel_single_deferred")
    dev = _cuda_device(r)
    r_out, p_out, ap, _, parts = _launch_single(
        r, Ap, p, None, inv, w_free, _scalar(alpha_prev, dev),
        _scalar(beta, dev), Kst, aT, plan, tables,
        "cg_kernel_single_deferred")
    _count(cg_kernel_single_deferred, Kst.shape[-1])
    return r_out, p_out, ap, parts


def make_fused_cg_kernel_single(Kst: torch.Tensor, aT: torch.Tensor,
                                plan: DSSPlan, *, defer_x: bool = False,
                                factors: AffineFactors | None = None):
    """``kAB`` for :func:`..solver.cg.cg_fused` with ``kB=None``: the single
    kernel bound to one affine operator (``Kst``, ``aT``, ``plan`` and
    ``factors``, as in :func:`make_fused_cg_kernels`).

    ``kAB(r, Ap, p, x, inv, w_free, alpha_prev, beta) -> (r', p', Ap', x',
    parts)``; with ``defer_x=True``, ``kAB(r, Ap, p, inv, w_free,
    alpha_prev, beta) -> (r', p', Ap', parts)`` for ``cg_fused(defer_x=m)``.
    ``kAB.single`` is True, ``kAB.defer_x`` records which and
    ``kAB.factors`` the factors."""
    if defer_x:
        def kAB(r, Ap, p, inv, w_free, alpha_prev, beta):
            return cg_kernel_single_deferred(r, Ap, p, inv, w_free,
                                             alpha_prev, beta, Kst, aT, plan,
                                             factors=factors)
    else:
        def kAB(r, Ap, p, x, inv, w_free, alpha_prev, beta):
            return cg_kernel_single(r, Ap, p, x, inv, w_free, alpha_prev,
                                    beta, Kst, aT, plan, factors=factors)
    kAB.single, kAB.defer_x, kAB.factors = True, bool(defer_x), factors
    return kAB


# -- the element-local Laplacian on row-major (E, n) L-vectors ---------------

def laplacian_local_plain(uL, g, Dh, hier):
    """Plain version of :func:`laplacian_local` (``torch.matmul`` with the
    dense stacked derivative; ``hier`` is already folded into ``Dh``):
    ``grads = u Dh^T``, ``[fr fs] = [g0 ur + g1 us, g1 ur + g2 us]``,
    ``out = [fr fs] Dh``.  Also takes a (k, E, n) stack."""
    n = Dh.shape[1]
    grads = torch.matmul(uL, Dh.T)                          # (..., E, 2n)
    ur, us = grads[..., :n], grads[..., n:]
    flux = torch.cat([g[0] * ur + g[1] * us, g[1] * ur + g[2] * us], dim=-1)
    return torch.matmul(flux, Dh)


def laplacian_local_batched_plain(uL, g, Dh, hier):
    """Plain version of :func:`laplacian_local_batched`."""
    return laplacian_local_plain(uL, g, Dh, hier)


def vector_laplacian_local_plain(uL, g, Dh, hier):
    """Plain version of :func:`vector_laplacian_local`: each of the k
    components of an (E, k n) array on its own."""
    E, kn = uL.shape
    n = Dh.shape[1]
    u3 = uL.reshape(E, kn // n, n).transpose(0, 1)          # (k, E, n)
    out = laplacian_local_plain(u3, g, Dh, hier)
    return out.transpose(0, 1).reshape(E, kn)


def _local_factors(Dh: torch.Tensor, hier: torch.Tensor) -> GeneralFactors:
    """The :class:`GeneralFactors` of ``Dh`` and ``hier``, built once per
    (``Dh``, ``hier``) state and remembered on ``Dh``; raises
    ``ValueError`` unless ``Dh`` is ``[D0 (x) I; I (x) D1]`` with its
    columns permuted by ``hier``, the only form the kernel computes."""
    key = (Dh._version, hier.data_ptr(), hier._version)
    got = getattr(Dh, "_local_factors", None)
    if got is not None and got[0] == key:
        return got[1]
    f = GeneralFactors(Dh.detach().double().cpu().numpy(),
                       hier.detach().cpu().numpy())
    Dh._local_factors = (key, f)
    return f


def local_pitch(n: int) -> int:
    """Floats per element in the element-local kernel's staging (odd, so
    that the 32 elements of a tile fall in 32 banks)."""
    return n if n % 2 else n + 1


def local_vec(n: int, E: int, estride: int, cstride: int, ptrs) -> bool:
    """Whether the element-local kernel stages its tiles by 16-byte copies:
    each tile's u, factor arrays and output are then contiguous runs at
    16-byte aligned addresses (n odd, the elements contiguous, E n, the
    component stride and the pointers ``ptrs`` multiples of 16 bytes);
    else it copies 4 bytes at a time at the pitch :func:`local_pitch`."""
    return (n % 2 == 1 and estride == n and (E * n) % 4 == 0
            and cstride % 4 == 0 and all(p % 16 == 0 for p in ptrs))


def _launch_local(uL, g, Dh, hier, k: int, estride: int, cstride: int,
                  factors, what: str):
    """The element-local kernel on CUDA tensors: k components, element e's
    component c at ``e * estride + c * cstride``."""
    tables = _require_general_factors(
        _local_factors(Dh, hier) if factors is None else factors, Dh, hier,
        what)
    dev = _cuda_device(uL)
    n, E = Dh.shape[1], g.shape[1]
    _check_n(n)
    f32 = (torch.float32,)
    _require(uL, "uL", f32, uL.shape, dev)
    _require(g, "g", f32, (3, E, n), dev)
    _require(Dh, "Dh", f32, (2 * n, n), dev)
    _require(hier, "hier", (torch.int32,), (n,), dev)
    out = torch.empty_like(uL)
    vec = local_vec(n, E, estride, cstride, (_ptr(uL), _ptr(g), _ptr(out)))
    lib = _lib(_LOCAL)
    rc = lib.sem_laplacian_local(_ptr(uL), _ptr(g), tables, _ptr(out), n, E,
                                 k, estride, cstride, int(vec), _stream(dev))
    _check(lib, rc, f"{what} (n={n}, E={E}, k={k})")
    return out


def local_occupancy(n: int, vec: bool = True, k: int = 1):
    """``(shared memory bytes, blocks per SM)`` of the element-local kernel
    for k components at n on the current card (the 16-byte staging with
    ``vec``)."""
    lib = _lib(_LOCAL)
    smem = ctypes.c_int(0)
    blocks = lib.sem_laplacian_local_occupancy(n, int(vec), k,
                                               ctypes.byref(smem))
    return smem.value, blocks


def _local_shape(uL, g, Dh, shape, what: str) -> None:
    if tuple(uL.shape) != tuple(shape):
        raise ValueError(f"{what}: uL has shape {tuple(uL.shape)}, expected "
                         f"{tuple(shape)} (g {tuple(g.shape)}, Dh "
                         f"{tuple(Dh.shape)})")


def laplacian_local(uL: torch.Tensor, g: torch.Tensor, Dh: torch.Tensor,
                    hier: torch.Tensor, *,
                    factors: GeneralFactors | None = None) -> torch.Tensor:
    """``out = [fr fs] Dh`` with ``[fr fs] = [g0 ur + g1 us, g1 ur + g2 us]``
    and ``[ur us] = u Dh^T``, per element of a row-major (E, n) L-vector,
    without DSS.

    ``g`` (3, E, n): the geometric factors [G00, G01, G11] in lex node
    order; ``Dh`` (2n, n): the stacked derivative with its columns in the
    L-vector order ``hier`` ((n,) int32, L-vector column -> lex node).
    The kernel applies ``Dh`` in tensor-product form from ``factors``, the
    :class:`GeneralFactors` of ``Dh`` and ``hier`` (as
    :class:`..ops.sumfac.LaplacianEN` builds them once; checked once
    against ``Dh`` and ``hier``); without them the wrapper builds them from
    ``Dh`` once per ``Dh`` state, and raises unless ``Dh`` is ``[D0 (x) I;
    I (x) D1]`` with its columns permuted by ``hier`` (as
    :func:`..ops.sumfac.make_stacked_derivative` builds it).  CUDA tensors
    must be float32.
    """
    if uL.device.type == "cpu":
        return laplacian_local_plain(uL, g, Dh, hier)
    _local_shape(uL, g, Dh, g.shape[1:], "laplacian_local")
    n = Dh.shape[1]
    out = _launch_local(uL, g, Dh, hier, 1, n, 0, factors, "laplacian_local")
    _count(laplacian_local, n)
    return out


def laplacian_local_batched(uL: torch.Tensor, g: torch.Tensor,
                            Dh: torch.Tensor, hier: torch.Tensor, *,
                            factors: GeneralFactors | None = None
                            ) -> torch.Tensor:
    """:func:`laplacian_local` of each (E, n) array of a (k, E, n) stack,
    in one launch: the k arrays share ``g`` and ``Dh``."""
    if uL.device.type == "cpu":
        return laplacian_local_batched_plain(uL, g, Dh, hier)
    E, n = g.shape[1:]
    if uL.dim() != 3:
        raise ValueError(f"uL has shape {tuple(uL.shape)}; expected "
                         f"(k, {E}, {n})")
    _local_shape(uL, g, Dh, (uL.shape[0], E, n), "laplacian_local_batched")
    out = _launch_local(uL, g, Dh, hier, uL.shape[0], n, E * n, factors,
                        "laplacian_local_batched")
    _count(laplacian_local_batched, n)
    return out


def vector_laplacian_local(uL: torch.Tensor, g: torch.Tensor,
                           Dh: torch.Tensor, hier: torch.Tensor, *,
                           factors: GeneralFactors | None = None
                           ) -> torch.Tensor:
    """:func:`laplacian_local` of each of k components packed side by side
    as an (E, k n) array (component c of element e in columns
    [c n, (c + 1) n)), in one launch; the components share ``g`` and
    ``Dh``."""
    if uL.device.type == "cpu":
        return vector_laplacian_local_plain(uL, g, Dh, hier)
    E, n = g.shape[1:]
    if uL.dim() != 2 or uL.shape[1] % n:
        raise ValueError(f"uL has shape {tuple(uL.shape)}; expected "
                         f"({E}, k * {n})")
    k = uL.shape[1] // n
    _local_shape(uL, g, Dh, (E, k * n), "vector_laplacian_local")
    out = _launch_local(uL, g, Dh, hier, k, k * n, n, factors,
                        "vector_laplacian_local")
    _count(vector_laplacian_local, n)
    return out


#: the wrappers, by kernel name
WRAPPERS = {"affine_apply_dss": affine_apply_dss,
            "affine_apply_dss_batched": affine_apply_dss_batched,
            "cg_kernel_a": cg_kernel_a,
            "cg_kernel_a_deferred": cg_kernel_a_deferred,
            "cg_kernel_a_batched": cg_kernel_a_batched,
            "cg_kernel_a_batched_deferred": cg_kernel_a_batched_deferred,
            "cg_kernel_b": cg_kernel_b,
            "cg_kernel_b_batched": cg_kernel_b_batched,
            "general_apply_dss": general_apply_dss,
            "general_apply_dss_batched": general_apply_dss_batched,
            "cg_kernel_a_general": cg_kernel_a_general,
            "cg_kernel_a_general_batched": cg_kernel_a_general_batched,
            "cg_kernel_single": cg_kernel_single,
            "cg_kernel_single_deferred": cg_kernel_single_deferred,
            "laplacian_local": laplacian_local,
            "laplacian_local_batched": laplacian_local_batched,
            "vector_laplacian_local": vector_laplacian_local,
            "affine_block_apply_dss": affine_block_apply_dss,
            "far_update": far_update}


def _count(fn, n: int) -> None:
    """One launch of ``fn``'s kernel at n nodes per element."""
    fn.launches[n] = fn.launches.get(n, 0) + 1


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = {}


def launch_counts() -> dict[str, int]:
    """The launches of each wrapper, over every n."""
    return {name: sum(fn.launches.values()) for name, fn in WRAPPERS.items()}


def launch_counts_by_n() -> dict[str, dict[int, int]]:
    """The launches of each wrapper, by n."""
    return {name: dict(fn.launches) for name, fn in WRAPPERS.items()}


reset_launch_counts()
