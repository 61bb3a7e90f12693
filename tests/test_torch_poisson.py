"""The PyTorch port's 2D Poisson ``solve_local`` against the JAX package's,
on the CPU (plain versions of the kernels), plus import hygiene.

* float64 plain PCG: the same iterations and the solution to 1e-10 (the
  bar of ``tests/test_poisson.py``);
* float32 fused-iteration PCG against the reference's interpret-mode fused
  kernels: iterations within 2, solution within 1e-5 relative;
* a manufactured linear solution (``tests/test_cg_fused.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forcing(x, y):
    return np.sin(np.pi * x) * np.cos(np.pi * y)


def _pair(dtype, nx=16, ny=8, p=3, neumann=True):
    """The same Dirichlet (+ Neumann) problem in both packages."""
    out = []
    for P, D, rect, basis in ((JaxPoisson, JaxDisc, jax_rect, jax_basis),
                              (Poisson, Discretization, rectangle_mesh,
                               gll_basis_2d)):
        prob = P(D(rect(nx, ny, p), basis(p)), forcing=_forcing, dtype=dtype)
        prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
        if neumann:
            prob.set_neumann("nbc", 0.3)
        out.append(prob)
    return out


def test_solve_local_float64_matches_jax():
    ref, port = _pair(np.float64)
    s_ref = ref.solve_local(tol=1e-8)
    s = port.solve_local(tol=1e-8, device="cpu")
    assert bool(s.cg.converged)
    assert int(s.cg.iterations) == int(s_ref.cg.iterations)
    assert s.cg.issued == s_ref.cg.issued
    assert np.abs(s.u - s_ref.u).max() < 1e-10


def test_solve_local_fused_float32_matches_jax():
    ref, port = _pair(np.float32)
    s_ref = ref.solve_local(tol=1e-6, cg_kernel="fused-interpret")
    s = port.solve_local(tol=1e-6, cg_kernel="fused", device="cpu")
    assert bool(s.cg.converged)
    assert abs(int(s.cg.iterations) - int(s_ref.cg.iterations)) <= 2
    rel = np.abs(s.u - s_ref.u).max() / np.abs(s_ref.u).max()
    assert rel < 1e-5
    assert s.u.dtype == np.float32


def test_solve_local_modes_agree():
    """Plain, fused and fused with bf16 directions reach the same
    solution (the reference's problem and bounds, tests/test_cg_fused.py:
    1e-4 / 1e-3 relative, at most 15 extra iterations with bf16)."""
    _, port = _pair(np.float32, neumann=False)
    plain = port.solve_local(tol=1e-5, cg_kernel="plain", device="cpu")
    fused = port.solve_local(tol=1e-5, cg_kernel="fused", device="cpu")
    bf16 = port.solve_local(tol=1e-5, cg_kernel="fused", device="cpu",
                            p_dtype=torch.bfloat16)
    scale = np.abs(plain.u).max()
    assert all(bool(s.cg.converged) for s in (plain, fused, bf16))
    assert np.abs(fused.u - plain.u).max() / scale < 1e-4
    assert np.abs(bf16.u - plain.u).max() / scale < 1e-3
    assert int(bf16.cg.iterations) <= int(plain.cg.iterations) + 15
    # the CPU runs the plain versions only
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_manufactured_solution():
    """Laplace with u = 0.1 (x + y): exact for any p.  "ebc" (west,
    south) carries the Dirichlet data, "nbc" (north, east) the matching
    Neumann flux 0.1."""
    disc = Discretization(rectangle_mesh(16, 8, 3), gll_basis_2d(3))
    prob = Poisson(disc, forcing=0.0, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
    prob.set_neumann("nbc", 0.1)
    sol = prob.solve_local(tol=1e-7, cg_kernel="fused", device="cpu")
    x, y = prob.x_nodes
    assert np.abs(sol.u - 0.1 * (x + y)).max() < 1e-4
    assert prob.l2_error(sol.u, lambda x, y: 0.1 * (x + y)) < 1e-4


def test_entry_point_needs_a_device():
    """Without CUDA and without device=, the solve raises rather than run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port = _pair(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.solve_local(tol=1e-6)


def test_import_pulls_in_no_jax():
    """Every module of the port imports without JAX, h5py or anything of
    the JAX package; ``plot2d`` without matplotlib (blocked here, as the
    card's machine has none)."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] == 'matplotlib':\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import spectralelementmethod_torch as m\n"
            "import spectralelementmethod_torch.interop\n"
            "import spectralelementmethod_torch.models.poisson\n"
            "import spectralelementmethod_torch.models.helmholtz\n"
            "import spectralelementmethod_torch.parallel\n"
            "import spectralelementmethod_torch.models.squirmer\n"
            "import spectralelementmethod_torch.models.advection_diffusion\n"
            "import spectralelementmethod_torch.solver.gmres\n"
            "import spectralelementmethod_torch.solver.condensation\n"
            "import spectralelementmethod_torch.core.pointlocate\n"
            "import spectralelementmethod_torch.utils.checkpoint\n"
            "import spectralelementmethod_torch.mesh.gmsh\n"
            "import spectralelementmethod_torch.native\n"
            "import spectralelementmethod_torch.ops.sp_array\n"
            "import spectralelementmethod_torch.plot2d\n"
            "import spectralelementmethod_torch.utils.checks\n"
            "import spectralelementmethod_torch.utils.perf\n"
            "import spectralelementmethod_torch.utils.timing\n"
            "assert 'matplotlib' not in sys.modules\n"
            "bad = [k for k in sys.modules if k in ('jax', 'h5py') or "
            "k.startswith('jax.') or k.startswith('spectralelementmethod_tpu')]"
            "\nprint(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
