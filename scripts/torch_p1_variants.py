#!/usr/bin/env python3
"""Time variants of the p = 1 apply kernel (n = 4, the p-multigrid coarse
level) against each other on one card.

    python3 scripts/torch_p1_variants.py

Builds ``scripts/torch_p1_variants.cu`` (which includes the tree's
``csrc/sem_p1.cuh``) and the tree's apply sources, then, on the p = 1
rectangle and annulus of ``chip_smoke.py`` (E = 99,856), one RHS and
k = 4, holds each variant against the plain version and times it (CUDA
events, inputs rotated past the L2, ``chip_smoke.gpu_ms``):

* the one-launch kernel of ``csrc/sem_p1.cuh`` as it is (``U2``: 2
  products per thread in flight) and copies of it with one change,
  compiled into ``spectralelementmethod_torch/_build/p1_variants``: 4
  products in flight (``U4``), 4 and 3 resident blocks in the launch
  bounds (``U4B3``), 2 and 4 blocks (``U2B4``); each with class tables
  for tiles of 256, 512 and 1,024 elements
  (``kernels.p1_classes(plan, (tile,))``), reading the plan's class masks
  packed into one word per element (as the global applies do) or as bytes
  (as the block apply does); and the wrapper, with the tile it takes;
* a thread per (element, RHS) recomputing each neighbour's product, one
  entry after the other;
* a cooperative launch: the products into a scratch array, a grid
  barrier, the gather from it;
* floors and references: the element product alone (no DSS), a
  ``torch.clone`` of u, the local product as one ``torch.matmul`` (the
  kernel rows' library call) and the plain version.

Prints the compiler's registers and spills of the one-launch kernels, one
line per variant and a JSON object, then the card's name and power
limit.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K = 4
#: name -> (products in flight per thread, resident blocks in the launch
#: bounds; None: as in the source)
VARIANTS = {"U2": (2, None), "U4": (4, None), "U4B3": (4, 3),
            "U2B4": (2, 4)}
_ENTRY = r"""
#include "sem_p1.cuh"
extern "C" int var_apply(int curved, const void* u, const void* tables,
                         const void* coef, const void* masks,
                         const void* bits, const void* classes, void* out,
                         int E, int nb, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      curved ? sem::launch_p1_apply_dss<sem::GeneralP1>(
                   u, tables, coef, masks, bits, classes, out, nullptr, E,
                   nb, k, s)
             : sem::launch_p1_apply_dss<sem::AffineP1>(
                   u, tables, coef, masks, bits, classes, out, nullptr, E,
                   nb, k, s));
}
"""


def _build_variants(kernels) -> dict:
    """Compile every variant (all at once); returns name -> (library,
    compiler report of its kernels)."""
    src = (kernels.CSRC / "sem_p1.cuh").read_text()
    procs = {}
    for name, (unroll, blocks) in VARIANTS.items():
        # each edit must match the header once, or the variant would time
        # the unchanged kernel under another name
        text, n_unroll = re.subn(r"kP1Unroll = \d+;",
                                 f"kP1Unroll = {unroll};", src)
        n_bounds = 1
        if blocks is not None:
            text, n_bounds = re.subn(
                r"__launch_bounds__\(kP1Threads\)",
                f"__launch_bounds__(kP1Threads, {blocks})", text)
        if (n_unroll, n_bounds) != (1, 1):
            raise RuntimeError(f"variant {name}: the edits of sem_p1.cuh "
                               "did not each match once")
        d = kernels.BUILD_DIR / "p1_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sem_p1.cuh").write_text(text)
        (d / "entry.cu").write_text(_ENTRY)
        so = d / "libvariant.so"
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(d / "entry.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.var_apply.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lines = log.splitlines()
        rep_ = [" | ".join(r.strip().replace("ptxas info    : ", "")
                           for r in lines[i + 1:i + 5]
                           if "stack frame" in r or "registers" in r)
                for i, ln in enumerate(lines)
                if "Compiling entry function" in ln]
        out[name] = (lib, rep_)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels

    dev = resolve_device()
    kernels.build([kernels._APPLY, kernels._GEN_APPLY])
    built = _build_variants(kernels)
    for name, (_, rep_) in built.items():
        print(f"{name}: " + "; ".join(rep_), flush=True)
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    so = kernels.BUILD_DIR / "libtorch_p1_variants.so"
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                        str(ROOT / "scripts" / "torch_p1_variants.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_coop.argtypes = [I, I] + [P] * 7 + [I, I, I, P]
    lib.exp_other.argtypes = [I, I] + [P] * 6 + [I, I, P]
    flat_t = np.dtype([("n", "<i4"), ("delta", "<i4", (32,)),
                       ("dst", "u1", (32,)), ("src", "u1", (32,)),
                       ("mask", "<u2", (32,))], align=True)
    g = torch.Generator(device=dev).manual_seed(0)
    st = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for pk, mesh_ in (("rect", rectangle_mesh(cs.NX, cs.NY, 1)),
                      ("annulus", annulus_mesh(1, **cs.ANNULUS))):
        A = Poisson(Discretization(mesh_, gll_basis_2d(1)),
                    dtype=np.float32)._local_setup(dev)["A"]
        curved = int(pk == "annulus")
        E, plan, mk = A.E, A.plan, A.plan.masks
        coef = A.gT if curved else A.aT
        opnd = kernels._operand(A.factors)
        tabs = {T: kernels.p1_classes(plan, (T,)) for T in (256, 512, 1024)}
        words = kernels.p1_mask_words(plan)
        flat = np.zeros((), flat_t)
        m = int(tabs[512]["n_entries"])
        flat["n"] = m
        for f in ("delta", "dst", "src", "mask"):
            flat[f][:m] = tabs[512][f][:m]
        name = "general_apply_dss" if curved else "affine_apply_dss"
        ops = (A.gT, A.Dh, A.hier) if curved else (A.Kst, A.aT)
        for k in (1, K):
            wname = name + ("_batched" if k > 1 else "")
            plain = functools.partial(getattr(kernels, wname + "_plain"),
                                      plan=plan)
            wrapper = functools.partial(getattr(kernels, wname),
                                        factors=A.factors)

            def tiled(u, lib_, T, packed):
                o = torch.empty_like(u)
                rc = lib_.var_apply(curved, u.data_ptr(), opnd,
                                    coef.data_ptr(),
                                    None if packed else mk.data_ptr(),
                                    words.data_ptr() if packed else None,
                                    tabs[T].ctypes.data, o.data_ptr(), E,
                                    plan.nb, k, st)
                if rc:
                    raise RuntimeError(f"p = 1 apply: error {rc}")
                return o

            def other(u, which):
                o = torch.empty_like(u)
                lib.exp_other(curved, which, u.data_ptr(), opnd,
                              coef.data_ptr(), mk.data_ptr(),
                              flat.ctypes.data, o.data_ptr(), E, k, st)
                return o

            def coop(u):
                o, b = torch.empty_like(u), torch.empty_like(u)
                rc = lib.exp_coop(curved, 256, u.data_ptr(), opnd,
                                  coef.data_ptr(), mk.data_ptr(),
                                  flat.ctypes.data, o.data_ptr(),
                                  b.data_ptr(), E, k, 0, st)
                if rc:
                    raise RuntimeError(f"cooperative launch: error {rc}")
                return o

            if curved:
                DhT = A.Dh.T.contiguous()
                fl = torch.randn((k, 8, E) if k > 1 else (8, E), generator=g,
                                 device=dev)

                def library(u):
                    v = u.view(k, 4, E) if k > 1 else u
                    return torch.matmul(A.Dh, v), torch.matmul(DhT, fl)
            else:
                K1 = A.Kst.reshape(12, 4)

                def library(u):
                    return torch.matmul(K1, u.view(k, 4, E) if k > 1 else u)

            variants = {
                f"{vn} tile {T}, {'packed' if pk_ else 'byte'} masks":
                    functools.partial(tiled, lib_=built[vn][0], T=T,
                                      packed=pk_)
                for vn in VARIANTS for T in (256, 512, 1024)
                for pk_ in (True, False)}
            variants.update({
                "wrapper": lambda u: wrapper(u, *ops, plan),
                "thread per element, recompute": functools.partial(
                    other, which=1),
                "cooperative, grid barrier": coop,
                "product only (no DSS)": functools.partial(other, which=0),
                "torch.clone of u": torch.clone,
                "library torch.matmul": library,
                "plain": lambda u: plain(u, *ops)})
            sets = [torch.randn((4 * k, E), generator=g, device=dev)
                    for _ in range(24 // k)]
            ref = plain(sets[0], *ops)
            for vn, fn in variants.items():
                got = fn(sets[0])
                torch.cuda.synchronize()
                err = (float((got - ref).abs().max() / ref.abs().max())
                       if isinstance(got, torch.Tensor)
                       and got.shape == ref.shape else None)
                ms = cs.gpu_ms(fn, [(s_,) for s_ in sets])
                res[f"{pk} k={k} {vn}"] = dict(ms=ms, rel_err=err)
                print(f"{pk:8s} k={k} {vn:34s} {ms:.4f} ms  rel err {err}",
                      flush=True)
    print(json.dumps(res), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
