#!/usr/bin/env python3
"""Time design variants of the port's curved-mesh kernels (the general
apply and its kernel A) on one card, built from this tree's sources.

    python3 scripts/torch_general_variants.py

Each variant is a copy of ``csrc/sem_curved.cuh``,
``csrc/general_apply_dss.cu`` and ``csrc/cg_kernel_a_general.cu`` with one
change, compiled into ``spectralelementmethod_torch/_build/variants`` with
the port's ``nvcc`` flags:

* ``H``: the sources as they are (the factors staged by cp.async, the
  column line hands over g1 ur; 3 resident blocks per SM in the apply's
  launch bounds, 4 in kernel A's);
* ``H3``, ``H4``: 3 or 4 blocks in both kernels' launch bounds (4 are as
  many as the 52 KB of shared memory per block allow);
* ``S3``, ``S4``: the factors staged through registers (a load and a
  shared store per value) instead of cp.async, 3 or 4 blocks;
* ``G3``, ``G2``: the factors loaded into registers before the first
  barrier and kept there (3 M values per thread) instead of staged, 3 or 2
  blocks.

Prints the compiler's register and spill report of each variant at n = 81,
then the device time of the six curved rows of ``chip_smoke.py`` phase 2
(CUDA events, inputs rotated past the L2) on the polar half-annulus of
E = 99,856 elements at p = 8, f32, k = 4 for the batched rows, twice, and
the card's name and power limit.  Each variant's Ap' is held to 1e-5 of
max against the plain version, and each kernel A's Ap' to the same
variant's apply of its own stored p', bit for bit.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K = 4


def sync_staging(hdr: str) -> str:
    """sem_curved.cuh staging the factors through registers."""
    a = hdr.index("  const unsigned d = static_cast<unsigned>(")
    b = hdr.index("}", a)
    return hdr[:a] + "  *dst = valid ? __ldg(src) : 0.f;\n" + hdr[b:]


def _replace(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"the sources no longer have {old!r}")
        text = text.replace(old, new)
    return text


def registers(hdr: str, app: str, cga: str) -> tuple[str, str, str]:
    """sem_curved.cuh and the two kernels with the factors in registers."""
    arr = "const float (&{})[AffSmem<N>::M]"
    hdr = _replace(hdr, (
        ("                                            float (&y)"
         "[AffSmem<N>::M]) {",
         "                                            float (&y)"
         "[AffSmem<N>::M], " + ", ".join(arr.format(g) for g in
                                          ("rg0", "rg1", "rg2")) + ") {"),
        ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n', ""),
        ("    sm.r[a * M + w][lane] = cs.g[1][a * M + w][lane] * ur[a];",
         "    sm.r[a * M + w][lane] = rg1[a] * ur[a];"),
        ("    g2us[a] = __fmul_rn(sm.s[w * M + a][lane], us[a]);",
         "    g2us[a] = __fmul_rn(rg2[a], us[a]);"),
        ("    fr[a] = fmaf(cs.g[0][a * M + w][lane], ur[a],\n"
         "                 cs.g[1][a * M + w][lane] * sm.s",
         "    fr[a] = fmaf(rg0[a], ur[a],\n                 rg1[a] * sm.s")))
    load = """  float rg0[M], rg1[M], rg2[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int qc = a * M + w, qr = w * M + a;
    rg0[a] = valid ? gT[(size_t)qc * E + e] : 0.f;
    rg1[a] = valid ? gT[(size_t)(N + qc) * E + e] : 0.f;
    rg2[a] = valid ? gT[(size_t)(2 * N + qr) * E + e] : 0.f;
  }
"""
    stage = "  gen_stage_factors<N>(cs, gT, E, e, valid);\n"
    app = _replace(app, ((stage, load), (
        "gen_product<N>(cs, t, x, S, y);",
        "gen_product<N>(cs, t, x, S, y, rg0, rg1, rg2);")))
    cga = _replace(cga, ((stage, load), (
        "gen_product<N>(cs, t, xv, S, y);",
        "gen_product<N>(cs, t, xv, S, y, rg0, rg1, rg2);")))
    return hdr, app, cga


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import ANNULUS, card_line, gpu_ms
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import annulus_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels

    work = kernels.BUILD_DIR / "variants"
    work.mkdir(parents=True, exist_ok=True)
    for f in kernels.CSRC.iterdir():
        (work / f.name).write_text(f.read_text())
    hdr = (work / "sem_curved.cuh").read_text()
    app = (work / kernels._GEN_APPLY).read_text()
    cga = (work / kernels._GEN_CG_A).read_text()
    (work / "sem_curved_s.cuh").write_text(sync_staging(hdr))
    g_hdr, g_app, g_cga = registers(hdr, app, cga)
    (work / "sem_curved_g.cuh").write_text(g_hdr)
    bounds = ("kGenApplyMinBlocks = 3", "kGenCgAMinBlocks = 4")

    def variant(blocks: int, header: str = "sem_curved.cuh", texts=None):
        inc = f'#include "{header}"'
        return tuple(
            t.replace(b, f"{b[:-1]}{blocks}").replace(
                '#include "sem_curved.cuh"', inc)
            for t, b in zip(texts or (app, cga), bounds))

    if any(b not in t for t, b in zip((app, cga), bounds)):
        raise RuntimeError("the launch bounds are no longer as expected")
    variants = {"H": (app, cga), "H3": variant(3), "H4": variant(4),
                "S3": variant(3, "sem_curved_s.cuh"),
                "S4": variant(4, "sem_curved_s.cuh"),
                "G3": variant(3, "sem_curved_g.cuh", (g_app, g_cga)),
                "G2": variant(2, "sem_curved_g.cuh", (g_app, g_cga))}
    if len(set(variants.values())) != len(variants):
        raise RuntimeError("two variants are the same")
    procs = {}
    for name, texts in variants.items():
        for tag, text in zip(("apply", "cga"), texts):
            (work / f"{name}_{tag}.cu").write_text(text)
            procs[name, tag] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                 str(work / f"lib{name}_{tag}.so"),
                 str(work / f"{name}_{tag}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, tag), proc in procs.items():
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

    def load(path):
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in kernels._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.sem_error_string.argtypes = [ctypes.c_int]
        lib.sem_error_string.restype = ctypes.c_char_p
        return lib

    dev = resolve_device()
    disc = Discretization(annulus_mesh(8, **ANNULUS), gll_basis_2d(8))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("sphere", 1.0)
    prob.set_dirichlet("shell", 0.0)
    ctx = prob._local_setup(dev)
    A = ctx["A"]
    op = (A.gT, A.Dh, A.hier, A.plan)
    n, E = disc.n_loc, disc.E
    g = torch.Generator(device=dev).manual_seed(0)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    inv = {tag: prob._fused_cg_operands(
        ctx["ex"], ctx["free_np"], None if tag == "f32" else dt[tag],
        dev)[0] for tag in dt}

    def rnd(k=1, dtype=torch.float32):
        return torch.randn((k * n, E), generator=g, device=dev).to(dtype)

    scal = {1: (torch.tensor(0.7, device=dev), torch.tensor(0.4, device=dev)),
            K: (torch.tensor([0.7, 0.4, 1.1, 0.0], device=dev),
                torch.tensor([0.4, 0.0, 0.9, 0.3], device=dev))}
    cases = {"general_apply_dss": ("general_apply_dss", 1, [
                 (rnd(), *op) for _ in range(3)]),
             "general_apply_dss_batched": ("general_apply_dss_batched", K, [
                 (rnd(K), *op) for _ in range(2)])}
    for base, k in (("cg_kernel_a_general", 1),
                    ("cg_kernel_a_general_batched", K)):
        for tag in dt:
            cases[f"{base}[{tag}]"] = (base, k, [
                (rnd(k), rnd(k, dt[tag]), inv[tag], rnd(k), *scal[k], *op)
                for _ in range(2)])
    times = {}
    for _ in range(2):
        for name in variants:
            kernels._LIBS[kernels._GEN_APPLY] = load(
                work / f"lib{name}_apply.so")
            kernels._LIBS[kernels._GEN_CG_A] = load(
                work / f"lib{name}_cga.so")
            for row, (base, k, sets) in cases.items():
                fn = functools.partial(kernels.WRAPPERS[base],
                                       factors=A.factors)
                got = fn(*sets[0])
                ref = getattr(kernels, base + "_plain")(*sets[0])
                ap = 0 if base.startswith("general") else 1
                got_ap = got if ap == 0 else got[1]
                ref_ap = ref if ap == 0 else ref[1]
                rel = ((got_ap - ref_ap).abs().max()
                       / ref_ap.abs().max()).item()
                if rel > 1e-5:
                    raise AssertionError(f"{name} {row}: Ap' {rel:.1e}")
                if ap:
                    own = kernels.WRAPPERS[
                        "general_apply_dss" + ("_batched" if k > 1 else "")](
                        got[0].float().contiguous(), *op, factors=A.factors)
                    if not torch.equal(own, got[1]):
                        raise AssertionError(f"{name} {row}: Ap' is not the "
                                             "apply of its own p'")
                times.setdefault(f"{name} {row}", []).append(
                    gpu_ms(fn, sets))
    for key, v in times.items():
        print(f"{key}: " + " ".join(f"{t:.4f}" for t in v), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
