#!/usr/bin/env python3
"""Time design variants of the port's affine kernel A and single kernel on
one card, built from this tree's sources.

    python3 scripts/torch_cg_variants.py

Each variant is a copy of ``csrc/cg_kernel_a.cu`` or
``csrc/cg_kernel_single.cu`` with one change, compiled into
``spectralelementmethod_torch/_build/variants`` with the port's ``nvcc``
flags:

* ``A3`` / ``S2``: the sources as they are (3 and 2 resident blocks per SM
  in the launch bounds);
* ``A4``, ``A2`` / ``S3``: other launch bounds (the compiler may spill);
* ``A4e``, ``A3e``: kernel A with the denominator formed in the flux phase
  as ``sum ur fr + us fs`` (the same ``p' . S`` of each element, as its
  energy ``p'^T K p'``) instead of from the row-line p', which frees the
  registers that keep that p' through the product.

Prints the compiler's register and spill report of each variant at n = 81,
then the device time of each (CUDA events, inputs rotated past the L2, as
``chip_smoke.py`` phase 2) on ``rectangle_mesh(316, 316, 8)``, f32, k = 4
for the batched rows, twice, and the card's name and power limit.  Each variant's Ap' is held to
1e-5 of max against the plain version.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K = 4


def energy_form(hdr: str, src: str) -> tuple[str, str]:
    """sem_affine.cuh with an ``en`` output summed in the flux phase, and
    cg_kernel_a.cu reducing it instead of ``y . S``."""
    he = hdr.replace(
        "float (&y)[AffSmem<N>::M], const Hook& hook = Hook()) {",
        "float (&y)[AffSmem<N>::M], float& en, const Hook& hook = Hook()) {"
    ).replace("  hook(sm);\n", "  hook(sm);\n#pragma unroll\n  for (int a = 0; "
              "a < M; ++a) en = fmaf(ur[a], fr[a], fmaf(us[a], fs[a], en));\n")
    se = src.replace('#include "sem_affine.cuh"',
                     '#include "sem_affine_e.cuh"').replace(
        "aff_product<N>(sm, t, xv, a0, a1, a2, S, y);",
        "float en = 0.f;\n  aff_product<N>(sm, t, xv, a0, a1, a2, S, y, en);"
    ).replace("d = fmaf(y[c], S[c], d);", "").replace(
        "block_sum(d)", "block_sum(en)")
    if he == hdr or "block_sum(en)" not in se or "fmaf(y[c]" in se:
        raise RuntimeError("the sources no longer have the expected form")
    return he, se


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, gpu_ms
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels
    from spectralelementmethod_torch.ops.exchange import roll_dss_T

    work = kernels.BUILD_DIR / "variants"
    work.mkdir(parents=True, exist_ok=True)
    for f in kernels.CSRC.iterdir():
        (work / f.name).write_text(f.read_text())
    A = (work / kernels._CG_A).read_text()
    S = (work / kernels._SINGLE).read_text()
    he, Ae = energy_form((work / "sem_affine.cuh").read_text(), A)
    (work / "sem_affine_e.cuh").write_text(he)
    bounds = "kCgAMinBlocks = 3"
    changed = {"A4": A.replace(bounds, "kCgAMinBlocks = 4"),
               "A2": A.replace(bounds, "kCgAMinBlocks = 2"), "A3e": Ae,
               "A4e": Ae.replace(bounds, "kCgAMinBlocks = 4"),
               "S3": S.replace("kSingleMinBlocks = 2",
                               "kSingleMinBlocks = 3")}
    for name, text in changed.items():
        if text in (A, S, Ae) and name != "A3e":
            raise RuntimeError(f"variant {name} changed nothing")
    variants = {"A3": A, **changed, "S2": S}
    procs = {}
    for name, text in variants.items():
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(work / f"lib{name}.so"), str(work / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-3000:])
            return 1
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "Li81E" in ln:
                info = [r.strip().replace("ptxas info    : ", "")
                        for r in lines[i + 1:i + 5]
                        if "stack frame" in r or "registers" in r]
                print(f"{name} {ln.split(chr(39))[1][:60]}: "
                      + " | ".join(info), flush=True)

    def load(name):
        lib = ctypes.CDLL(str(work / f"lib{name}.so"))
        for fn, argtypes in kernels._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.sem_error_string.argtypes = [ctypes.c_int]
        lib.sem_error_string.restype = ctypes.c_char_p
        return lib

    disc = Discretization(rectangle_mesh(316, 316, 8), gll_basis_2d(8))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    dev = resolve_device()
    ctx = prob._local_setup(dev)
    Kst, aT, plan, fac = (ctx["A"].Kst, ctx["A"].aT, ctx["A"].plan,
                          ctx["A"].factors)
    n, E = disc.n_loc, disc.E
    g = torch.Generator(device=dev).manual_seed(0)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    inv, w = {}, {}
    for tag in dt:
        inv[tag], w[tag] = prob._fused_cg_operands(
            ctx["ex"], ctx["free_np"], None if tag == "f32" else dt[tag],
            dev)

    def rnd(k=1, dtype=torch.float32):
        return torch.randn((k * n, E), generator=g, device=dev).to(dtype)

    scal = {1: (torch.tensor(0.7, device=dev), torch.tensor(0.4, device=dev)),
            K: (torch.tensor([0.7, 0.4, 1.1, 0.0], device=dev),
                torch.tensor([0.4, 0.0, 0.9, 0.3], device=dev))}
    cases = {}
    for base, k, with_x in (("cg_kernel_a", 1, True),
                            ("cg_kernel_a_deferred", 1, False),
                            ("cg_kernel_a_batched", K, True),
                            ("cg_kernel_a_batched_deferred", K, False)):
        for tag in dt:
            cases[f"{base}[{tag}]"] = (base, [
                (rnd(k), rnd(k, dt[tag]), inv[tag],
                 *((rnd(k), *scal[k]) if with_x else (scal[k][0],)), Kst,
                 aT, plan) for _ in range(2)])

    def consistent(dtype=torch.float32):
        return roll_dss_T(rnd(), plan).to(dtype)

    for base, with_x in (("cg_kernel_single", True),
                         ("cg_kernel_single_deferred", False)):
        for tag in dt:
            cases[f"{base}[{tag}]"] = (base, [
                (consistent(), consistent(), consistent(dt[tag]),
                 *((rnd(),) if with_x else ()), inv[tag], w[tag],
                 *scal[1][::-1], Kst, aT, plan) for _ in range(2)])
    times = {}
    for _ in range(2):
        for name in variants:
            single = name.startswith("S")
            kernels._LIBS[kernels._SINGLE if single else kernels._CG_A] = \
                load(name)
            for row, (base, sets) in cases.items():
                if single != base.startswith("cg_kernel_single"):
                    continue
                fn = functools.partial(kernels.WRAPPERS[base], factors=fac)
                got = fn(*sets[0])
                ref = getattr(kernels, base + "_plain")(*sets[0])
                ap = 2 if single else 1
                rel = ((got[ap] - ref[ap]).abs().max()
                       / ref[ap].abs().max()).item()
                if rel > 1e-5:
                    raise AssertionError(f"{name} {row}: Ap' {rel:.1e}")
                times.setdefault(f"{name} {row}", []).append(
                    gpu_ms(fn, sets))
    for key, v in times.items():
        print(f"{key}: " + " ".join(f"{t:.4f}" for t in v), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
