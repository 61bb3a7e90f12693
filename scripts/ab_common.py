"""What the ``scripts/torch_ab_*.py`` comparisons share.

Each of those scripts supplies ``run_tree(root, ...)``, which measures one
source tree in the process that calls it and returns a JSON-able dict, and
calls :func:`main`:

    python3 scripts/torch_ab_X.py TREE_A TREE_B [--steady 512,1536]

runs the trees in the order A, B, B, A, each in its own process (the same
script with ``--one TREE``, from the tree's root), so that a drift of the
card over the call shows as a difference between the two runs of one tree;
prints each run's JSON line (or its exit code and the end of its errors),
then the card's name and power limit; and writes each run's full log to
``chiprun_out/ab_<tag>_<i>.log``.  :func:`profile` and :func:`ptxas_report`
are the measurements the scripts share.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PREFIX = "AB_JSON "


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(script: str, doc: str, tag: str, run_tree, *, steady=None,
         timeout: int = 1200) -> int:
    """The command line of an A/B script (``script`` its ``__file__``,
    ``doc`` its docstring).  ``steady``: the default of a ``--steady
    N1,N2`` option whose pair of iteration counts is passed to
    ``run_tree`` after the root, or None for a script without it."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    if steady is not None:
        ap.add_argument("--steady", default=steady)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    opts = [] if steady is None else ["--steady", args.steady]
    extra = (() if steady is None
             else (tuple(int(v) for v in args.steady.split(",")),))
    if args.one:
        res = run_tree(Path(args.one).resolve(), *extra)
        print(PREFIX + json.dumps(res), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    a, b = (Path(t).resolve() for t in args.trees)
    out_dir = Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    rc = 0
    for i, tree in enumerate((a, b, b, a)):
        proc = subprocess.run([sys.executable, str(Path(script).resolve()),
                               "--one", str(tree), *opts], cwd=tree,
                              capture_output=True, text=True,
                              timeout=timeout)
        (out_dir / f"ab_{tag}_{i}.log").write_text(proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(PREFIX)]
        print(lines[-1][len(PREFIX):] if proc.returncode == 0 and lines
              else f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}",
              flush=True)
        rc = rc or proc.returncode
    print(card_line(), flush=True)
    return rc


def profile(call, per: int | None = None) -> dict:
    """One ``call()`` under the profiler: device ms and device launches
    per unit of ``per`` (None: the issued iterations of the solve that
    ``call`` returns), the device's busy share of the host's wall time, and
    the six kernels that took the most device time, per unit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = res.cg.issued if per is None else per
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    return dict(issued=per, device_ms_per_iter=1e3 * busy / per,
                launches_per_iter=sum(e.count for e in ev) / per,
                busy_share=busy / wall,
                top_kernels_ms_per_iter={
                    e.key[:60]: e.self_device_time_total / 1e3 / per
                    for e in sorted(ev, key=lambda e:
                                    -e.self_device_time_total)[:6]})


def ptxas_report(logs: dict, keep) -> dict:
    """Registers, shared memory and spills, from the compiler logs ``logs``
    (source -> text) of every kernel whose entry line ``keep(line)``
    accepts: ``"source kernel"`` -> one line."""
    out = {}
    for src, text in logs.items():
        lines = text.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and keep(ln):
                info = [r.strip().replace("ptxas info    : ", "")
                        for r in lines[i + 1:i + 5]
                        if "stack frame" in r or "registers" in r]
                out[f"{src} {ln.split(chr(39))[1][:60]}"] = " | ".join(info)
    return out


#: the line of ``chip_smoke.py`` that opens its phase 3
PHASE3 = "    # -- 3. the main path"


def through_phase2(root: Path, tail) -> dict:
    """The tree's own ``chip_smoke.py`` up to its phase 3 (the build, and
    phase 2, which holds every kernel against its plain version and times
    it), then ``tail(L)`` on the locals ``L`` of its ``main`` there; the
    dict ``tail`` returns, with the tree's root."""
    src = (root / "chip_smoke.py").read_text()
    if PHASE3 not in src:
        raise RuntimeError(f"{root}/chip_smoke.py has no phase 3 marker")
    src = src[:src.index(PHASE3)] + "    return _ab_tail(locals())\n"
    ns = {"__name__": "chip_smoke_ab", "__file__": str(root / "chip_smoke.py"),
          "_ab_tail": tail}
    sys.path.insert(0, str(root))
    exec(compile(src, str(root / "chip_smoke.py"), "exec"), ns)
    res = ns["main"]()
    if not isinstance(res, dict):
        raise RuntimeError(f"phase 2 of {root} returned {res!r}")
    res["tree"] = str(root)
    return res
