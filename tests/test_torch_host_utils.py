"""The port's host surface against the JAX package's, on the CPU: the
Kronecker arrays (``ops/sp_array.py``), the checks, timing and perf utils,
``sumfac.element_apply_flops`` and ``sumfac.laplacian_apply_fused``,
``plot2d`` (triangulations and every draw function, with Agg), the
``examples/torch_*.py`` drivers at tiny sizes with ``--device cpu``, and
``LaplacianEN``'s device default.
"""

import importlib.util
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from spectralelementmethod_tpu import plot2d as jplot2d  # noqa: E402
from spectralelementmethod_tpu.basis import (  # noqa: E402
    gll_basis_2d as j_basis_2d)
from spectralelementmethod_tpu.core.discretization import (  # noqa: E402
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import annulus_mesh as j_annulus  # noqa
from spectralelementmethod_tpu.mesh import rectangle_mesh as j_rect  # noqa
from spectralelementmethod_tpu.ops import sumfac as jsumfac  # noqa: E402
from spectralelementmethod_tpu.ops.sp_array import (  # noqa: E402
    KroneckerArray as JKron)
from spectralelementmethod_tpu.utils import checks as jchecks  # noqa: E402
from spectralelementmethod_tpu.utils import perf as jperf  # noqa: E402

from spectralelementmethod_torch import plot2d  # noqa: E402
from spectralelementmethod_torch.basis import gll_basis_2d  # noqa: E402
from spectralelementmethod_torch.core.discretization import (  # noqa: E402
    Discretization)
from spectralelementmethod_torch.mesh import (  # noqa: E402
    annulus_mesh, rectangle_mesh)
from spectralelementmethod_torch.ops import sumfac  # noqa: E402
from spectralelementmethod_torch.ops.sp_array import (  # noqa: E402
    KroneckerArray)
from spectralelementmethod_torch.utils import checks, perf  # noqa: E402
from spectralelementmethod_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANNULUS = dict(n_theta=5, n_r=6)


@pytest.fixture(scope="module")
def discs():
    """The port's and the reference's discretization of one curved annulus
    at p = 4 (the reference's checks test mesh)."""
    return (Discretization(annulus_mesh(4, **ANNULUS), gll_basis_2d(4)),
            JaxDisc(j_annulus(4, **ANNULUS), j_basis_2d(4)))


# -- ops/sp_array.py ---------------------------------------------------------

def _kron_cases(K):
    rng = np.random.RandomState(0)
    X = rng.randn(4, 5, 6)
    v = rng.randn(4, 6)
    return {
        "diag": K((3, 3), np.array([1.0, 2.0, 3.0]), [0, 0]).to_array(),
        "rank4-mass": K((2, 3, 2, 3), np.arange(6.0).reshape(2, 3),
                        [0, 1, 0, 1]).to_array(),
        "dot-dense": K((4, 5, 4, 5, 4, 6), X, [0, 1, 0, 1, 0, 2])
        .dot_dense(v, [4, 5]).to_array(),
        "dense": K((4, 5, 4, 5, 4, 6), X, [0, 1, 0, 1, 0, 2]).to_array(),
    }


@pytest.mark.parametrize("case", ["diag", "rank4-mass", "dot-dense",
                                  "dense"])
def test_kronecker_array_matches_the_reference(case):
    np.testing.assert_array_equal(_kron_cases(KroneckerArray)[case],
                                  _kron_cases(JKron)[case])


def test_kronecker_array_checks_shapes():
    with pytest.raises(AssertionError):
        KroneckerArray((3, 4), np.zeros((3, 3)), [0, 1])
    ka = KroneckerArray((4, 5, 4, 5, 4, 6), np.ones((4, 5, 6)),
                        [0, 1, 0, 1, 0, 2])
    dense = np.einsum("pqrstu,tu->pqrs", ka.to_array(), np.ones((4, 6)))
    np.testing.assert_allclose(
        ka.dot_dense(np.ones((4, 6)), [4, 5]).to_array(), dense, atol=1e-12)


# -- utils/checks.py ---------------------------------------------------------

def test_checked_and_assert_finite_catch_nan():
    """The reference's case (``tests/test_utils.py``): a checked log passes
    on positive inputs and raises on log(-1)."""
    def f(x):
        return checks.assert_finite(torch.log(x), "logx")

    g = checks.checked(f)
    ok, bad = [1.0, 2.0], [-1.0, 2.0]
    np.testing.assert_array_equal(g(torch.tensor(ok, dtype=torch.float64)),
                                  np.log(ok))
    with pytest.raises(FloatingPointError, match="logx"):
        g(torch.tensor(bad))
    # ``checked`` alone catches un-annotated non-finite outputs too
    h = checks.checked(lambda x: (x, {"y": 1.0 / x}))
    h(torch.ones(3))
    with pytest.raises(FloatingPointError):
        h(torch.zeros(3))
    assert checks.assert_finite(torch.arange(3)) is not None   # integers


def test_nan_debug_mode_checks_every_op_and_restores():
    x = torch.tensor([-1.0, 2.0])
    torch.log(x)                                   # no check outside
    with checks.nan_debug_mode():
        torch.exp(x)
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
    torch.log(x)


def test_validate_discretization_matches_the_reference(discs):
    disc, jdisc = discs
    rep = checks.validate_discretization(disc, device="cpu")
    jrep = jchecks.validate_discretization(jdisc)
    assert sorted(rep) == sorted(jrep)
    for key, val in jrep.items():
        assert rep[key] == pytest.approx(val, rel=1e-12, abs=1e-12), key


# -- utils/timing.py and utils/perf.py ---------------------------------------

def test_time_step_on_a_cpu_step():
    A = torch.randn(96, 96, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64) / 96
    x0 = torch.ones(96, 64, dtype=torch.float64)
    res = timing.time_step(lambda x, M: M @ x, x0, reps=8, tries=2,
                           consts=(A,))
    assert sorted(res) == ["reliable", "reps", "t_2n", "t_apply", "t_n"]
    assert res["reps"] >= 8 and 0 < res["t_n"] and 0 < res["t_2n"]
    if res["reliable"]:
        assert res["t_apply"] > 0
    assert timing.sync((x0, {"a": x0[0]})) == 2.0
    assert timing.sync(3) == 0.0


def test_timer_and_timed():
    t = perf.Timer("x")
    for _ in range(2):
        with t:
            pass
    assert t.count == 2 and t.total >= 0 and "x:" in str(t)
    result, dt = perf.timed(lambda a: a + 1, torch.ones(2), reps=3)
    assert torch.equal(result, torch.full((2,), 2.0)) and dt >= 0


def test_roofline_matches_the_reference():
    args = (10**9, 10**8, 1e-2, 67.0, 3350.0)
    r, jr = perf.Roofline(*args), jperf.Roofline(*args)
    for attr in ("gflops", "gbps", "intensity", "bound", "roofline_gflops",
                 "efficiency"):
        assert getattr(r, attr) == getattr(jr, attr), attr
    assert str(r) == str(jr)
    r = perf.roofline(10**9, 10**8, 1e-2, device="NVIDIA H100 80GB HBM3")
    assert (r.peak_tflops, r.hbm_gbps) == (67.0, 3350.0)
    assert r.bound == "memory"
    with pytest.raises(ValueError, match="no published peak"):
        perf.device_peaks("cpu")
    with pytest.raises(ValueError, match="no published peak"):
        perf.device_peaks("TPU v5 lite")
    # the PCIe and NVL parts have other peaks than the SXM card's
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        with pytest.raises(ValueError, match="no published peak"):
            perf.device_peaks(other)


def test_trace_writes_a_chrome_trace(tmp_path):
    with perf.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


# -- ops/sumfac.py -----------------------------------------------------------

def test_element_apply_flops_matches_the_reference():
    for p in range(1, 13):
        for p0, p1 in ((p + 1, p + 1), (p + 1, p + 2)):
            assert (sumfac.element_apply_flops(99_856, p0, p1)
                    == jsumfac.element_apply_flops(99_856, p0, p1))


def test_laplacian_apply_fused_matches_the_reference(discs):
    """float64 on the curved annulus: the port's fused apply against the
    reference's and against the port's per-axis ``laplacian_apply``."""
    disc, jdisc = discs
    G = disc.laplacian_factors()
    D0, D1 = (disc.basis.subbases[d].D1 for d in range(2))
    Dhat = sumfac.make_stacked_derivative(D0, D1)
    Gf = G.reshape(disc.E, 3, -1)
    u = np.random.RandomState(0).standard_normal(disc.n_nodes)
    t = torch.as_tensor
    gix = t(disc.gather_nodes)
    got = sumfac.laplacian_apply_fused(t(u), gix, t(Gf), t(Dhat),
                                       disc.n_nodes)
    ref = jsumfac.laplacian_apply_fused(
        jnp.asarray(u), jnp.asarray(jdisc.gather_nodes), jnp.asarray(Gf),
        jnp.asarray(Dhat), disc.n_nodes)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12 * scale)
    per_axis = sumfac.laplacian_apply(t(u), gix, t(G), t(D0), t(D1),
                                      disc.n_nodes)
    np.testing.assert_allclose(got.numpy(), per_axis.numpy(), rtol=0,
                               atol=1e-12 * scale)


def test_laplacian_en_resolves_its_device(discs):
    """Without ``device`` the operator goes to the card, as every entry
    point does: where there is none it raises."""
    disc, _ = discs
    G = disc.laplacian_factors().reshape(disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(disc.basis.subbases[0].D1,
                                          disc.basis.subbases[1].D1)
    hier = np.arange(Dhat.shape[1])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sumfac.LaplacianEN(G, Dhat, hier, lambda v: v)
    op = sumfac.LaplacianEN(G, Dhat, hier, lambda v: v, device="cpu")
    assert op.Dh.device.type == "cpu"


# -- plot2d ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rectangle", "annulus"])
def test_triangulations_match_the_reference(kind):
    make = {"rectangle": lambda m: m(3, 2, 4),
            "annulus": lambda m: m(3, n_theta=4, n_r=3, r_outer=5.0)}[kind]
    mesh, jmesh = ((make(rectangle_mesh), make(j_rect)) if kind ==
                   "rectangle" else (make(annulus_mesh), make(j_annulus)))
    tri, jtri = plot2d.triangulate(mesh), jplot2d.triangulate(jmesh)
    np.testing.assert_array_equal(tri.triangles, jtri.triangles)
    np.testing.assert_array_equal(tri.x, jtri.x)
    np.testing.assert_array_equal(tri.y, jtri.y)


def test_contours_take_tensors_and_write_files(discs, tmp_path):
    disc, jdisc = discs
    xg = disc.global_gll_coords()
    u = np.sin(xg[0] / 10) * xg[1]
    tri, vals = plot2d.triangulate_data(disc, torch.as_tensor(u))
    _, jvals = jplot2d.triangulate_data(jdisc, u)
    np.testing.assert_allclose(vals, jvals, rtol=0, atol=1e-12)
    assert plot2d.tricontourf(disc, torch.as_tensor(u), levels=10)
    plot2d.tricontour(disc, u, levels=5)
    plot2d.surface(disc, torch.as_tensor(u))
    plt.savefig(tmp_path / "plot.png")
    plt.close("all")
    assert (tmp_path / "plot.png").stat().st_size > 0


def test_draw_functions_write_files(tmp_path):
    mesh = annulus_mesh(order=3, n_theta=4, n_r=3, r_outer=5.0)
    ax = plot2d.draw_cells(mesh, draw_nums=True, draw_param_axes=True)
    plot2d.draw_nodes(mesh, ax=ax, show_indices=True)
    plot2d.draw_cell_nodes(mesh.get_cell(0), local_indices=True,
                           global_indices=True, ax=ax)
    plot2d.draw_cell_nodes(mesh.get_cell(1), global_indices=True,
                           hierarchical_order=True, ax=ax)
    plot2d.draw_cell(mesh.get_cell(2), draw_param_axes=True, ax=ax)
    (line,) = ax.plot([0, 1, 2], [0, 1, 0])
    plot2d.add_arrow_to_line(line, reverse=True)
    plt.savefig(tmp_path / "mesh.png")
    plt.close("all")
    assert (tmp_path / "mesh.png").stat().st_size > 0
    with pytest.raises(plot2d.PlottingError):
        plot2d.draw_cells(rectangle_mesh(1, 1, 1).__class__(3))


# -- examples/torch_*.py -----------------------------------------------------

def _example(name):
    path = os.path.join(REPO, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_poisson(tmp_path):
    from spectralelementmethod_torch.mesh.gmsh import save_msh

    save_msh(rectangle_mesh(3, 3, 3), str(tmp_path / "sq.msh"))
    out = _example("poisson").main([
        "--mesh", str(tmp_path / "sq.msh"), "--order", "3", "--local",
        "--batch", "1", "--plot", str(tmp_path / "u.png"),
        "--device", "cpu"])
    made = _example("poisson").main(["--nx", "3", "--order", "3",
                                     "--device", "cpu"])
    np.testing.assert_allclose(out["u"], made["u"], rtol=0, atol=1e-10)
    assert out["batch_du"] < 1e-10 and (tmp_path / "u.png").exists()


def test_example_poisson3d(tmp_path):
    out = _example("poisson3d").main([
        "--cells", "2", "--order", "3", "--msh", str(tmp_path / "b.msh"),
        "--precond", "fdm", "--device", "cpu"])
    assert np.isfinite(out["u"]).all() and out["err"] < 0.1


def test_example_poisson3d_mixed_bc():
    out = _example("poisson3d_mixed_bc").main(["--cells", "2", "--order",
                                               "2", "--device", "cpu"])
    assert out["err"] < 1e-9 and abs(out["flux_total"] - 12.0) < 1e-9


def test_example_hp_convergence():
    errs = _example("hp_convergence").main(["--orders", "2", "4",
                                            "--cells", "2", "--device",
                                            "cpu"])
    assert errs[2, 4] < errs[2, 2] / 10


@pytest.mark.parametrize("f32", [False, True])
def test_example_multi_rhs(f32):
    argv = ["--cells", "3", "--order", "3", "--k", "2", "--device", "cpu"]
    out = _example("multi_rhs").main(argv + (["--f32"] if f32 else []))
    assert len(out["iterations"]) == 2 and max(out["errors"]) < 1e-2


def test_example_squirmer_axisym(tmp_path):
    from spectralelementmethod_torch.mesh.gmsh import save_msh

    mesh = annulus_mesh(order=3, n_theta=5, n_r=8, r_outer=100.0,
                        progression=1.35)
    save_msh(mesh, str(tmp_path / "donut.msh"))
    speed = _example("squirmer_axisym").main([
        "--mesh", str(tmp_path / "donut.msh"), "--order", "3",
        "--device", "cpu"])
    made = _example("squirmer_axisym").main([
        "--order", "3", "--n-theta", "5", "--n-r", "8", "--device", "cpu"])
    assert np.isfinite(speed) and speed == made
