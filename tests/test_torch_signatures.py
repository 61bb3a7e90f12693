"""The port's public entry points take the reference's parameters in the
reference's order, so a positional call binds the same parameter in both
packages.  ``device`` may follow as the last parameter; every parameter the
port has not taken up yet exists and raises ``NotImplementedError`` naming
its ROADMAP item when asked for more than the default.  Every default
matches the reference's but the two named in ``DEFAULTS``."""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectralelementmethod_torch.ops.exchange as t_ex
import spectralelementmethod_torch.ops.sumfac as t_sumfac
import spectralelementmethod_torch.parallel as t_par
import spectralelementmethod_torch.solver.fdm as t_fdm
import spectralelementmethod_torch.solver.pmg as t_pmg
import spectralelementmethod_tpu.ops.exchange as j_ex
import spectralelementmethod_tpu.ops.sumfac as j_sumfac
import spectralelementmethod_tpu.solver.fdm as j_fdm
import spectralelementmethod_tpu.solver.pmg as j_pmg
import spectralelementmethod_tpu.parallel.halo as j_halo
import spectralelementmethod_tpu.parallel.partition as j_part
import spectralelementmethod_tpu.parallel.sharding as j_sh
from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.helmholtz import Helmholtz
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.solver.cg import (cg, cg_host, cg_refined,
                                                   cg_refined_static)
from spectralelementmethod_tpu.models.helmholtz import Helmholtz as JHelm
from spectralelementmethod_tpu.models.poisson import Poisson as JPoisson
from spectralelementmethod_tpu.solver.cg import cg as j_cg
from spectralelementmethod_tpu.solver.cg import cg_host as j_cg_host
from spectralelementmethod_tpu.solver.cg import cg_refined as j_cg_refined
from spectralelementmethod_tpu.solver.cg import (
    cg_refined_static as j_cg_refined_static)

torch.set_num_threads(2)

# the modules of the squirmer / advection-diffusion slice, by their path in
# both packages: every public function and class of the reference's module
# exists in the port's, with the reference's signature
SLICE_MODULES = ("solver.gmres", "solver.condensation", "solver.rootfind",
                 "utils.logging", "utils.checkpoint", "core.pointlocate",
                 "models.advection_diffusion", "models.squirmer")
# the host surface: Gmsh I/O, the native meshkit, the Kronecker arrays, the
# checks, timing and perf utils, and plot2d
HOST_MODULES = ("mesh.gmsh", "native", "ops.sp_array", "utils.checks",
                "utils.timing", "utils.perf", "plot2d.contours",
                "plot2d.mesh")


def _module_pair(path):
    return (importlib.import_module(f"spectralelementmethod_torch.{path}"),
            importlib.import_module(f"spectralelementmethod_tpu.{path}"))


def _public(mod):
    """The public functions and classes defined in ``mod`` (the NamedTuple
    result types included), by name."""
    return {name: obj for name, obj in vars(mod).items()
            if not name.startswith("_")
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == mod.__name__}


def _slice_pairs():
    pairs = {}
    for path in SLICE_MODULES + HOST_MODULES:
        port, ref = _module_pair(path)
        for name, robj in _public(ref).items():
            pobj = getattr(port, name)
            if inspect.isfunction(robj):
                pairs[f"{path}.{name}"] = (pobj, robj)
                continue
            if issubclass(robj, tuple):          # NamedTuple results
                continue
            for meth, rfn in vars(robj).items():
                if (inspect.isfunction(rfn) and (not meth.startswith("_")
                                                 or meth == "__init__")):
                    pairs[f"{path}.{name}.{meth}"] = (getattr(pobj, meth),
                                                      rfn)
    return pairs


PAIRS = {
    "Poisson.solve_local": (Poisson.solve_local, JPoisson.solve_local),
    "Poisson.solve_local_batch": (Poisson.solve_local_batch,
                                  JPoisson.solve_local_batch),
    "Helmholtz.solve": (Helmholtz.solve, JHelm.solve),
    "Helmholtz.solve_local": (Helmholtz.solve_local, JHelm.solve_local),
    "Helmholtz.solve_local_batch": (Helmholtz.solve_local_batch,
                                    JHelm.solve_local_batch),
    "Poisson.solve": (Poisson.solve, JPoisson.solve),
    "Poisson.apply_operator": (Poisson.apply_operator,
                               JPoisson.apply_operator),
    "cg": (cg, j_cg),
    "cg_host": (cg_host, j_cg_host),
    "cg_refined": (cg_refined, j_cg_refined),
    "cg_refined_static": (cg_refined_static, j_cg_refined_static),
}
# the allowed default differences: (entry, parameter) -> (port, reference)
DEFAULTS = {
    # planned divergence (ADVICE): only the certified call site opts in
    ("cg_refined", "stall_cut"): (None, 4.0),
    # the same inner precision, in each package's own dtype object
    ("cg_refined_static", "dtype"): (torch.float32, jnp.float32),
}
PAIRS.update({f"fdm.{name}": (getattr(t_fdm, name), getattr(j_fdm, name))
              for name in ("gll_fdm_eig", "make_fdm_preconditioner",
                           "make_fdm_preconditioner_3d")})
PAIRS.update({f"parallel.{name}": (getattr(t_par, name), getattr(mod, name))
              for mod, names in (
                  (j_sh, ("device_mesh", "pad_elements", "pad_element_arrays",
                          "sharded_local_poisson_problem",
                          "sharded_local_poisson_problem_3d",
                          "hybrid_device_mesh", "shard_element_arrays",
                          "replicated", "make_sharded_poisson_operator",
                          "sharded_poisson_problem")),
                  (j_halo, ("global_roll", "make_halo_dss_T",
                            "stack_class_masks",
                            "make_sharded_fused_operator",
                            "make_sharded_local_operator")),
                  (j_part, ("cut_faces", "morton_order", "panel_order",
                            "rcm_order", "reorder_elements")))
              for name in names})
# the 3D path (ROADMAP Queue 1 item 9): every public 3D function
PAIRS.update({f"sumfac.{name}": (getattr(t_sumfac, name),
                                 getattr(j_sumfac, name))
              for name in ("grad_3d", "grad_transpose_3d",
                           "laplacian_apply_local_3d",
                           "laplacian_apply_local_3d_affine",
                           "laplacian_apply_local_3d_separable",
                           "assembled_1d_stiffness", "laplacian_apply_3d",
                           "laplacian_diag_local_host_3d", "grad_3d_T",
                           "grad_transpose_3d_T",
                           "laplacian_apply_local_3d_affine_T",
                           "laplacian_apply_local_3d_T",
                           "laplacian_apply_local_3d_separable_T")})
PAIRS.update({
    "pmg.make_pmg_preconditioner": (t_pmg.make_pmg_preconditioner,
                                    j_pmg.make_pmg_preconditioner),
    "pmg.make_pmg_preconditioner_3d": (t_pmg.make_pmg_preconditioner_3d,
                                       j_pmg.make_pmg_preconditioner_3d),
    "pmg.GridFDM3D.try_build": (t_pmg.GridFDM3D.try_build,
                                j_pmg.GridFDM3D.try_build),
    "exchange.PairScatterExchange": (t_ex.PairScatterExchange,
                                     j_ex.PairScatterExchange),
    "exchange.BoxRollExchange3D": (t_ex.BoxRollExchange3D,
                                   j_ex.BoxRollExchange3D),
})
PAIRS.update({f"sumfac.{name}": (getattr(t_sumfac, name),
                                 getattr(j_sumfac, name))
              for name in ("element_apply_flops", "laplacian_apply_fused")})
PAIRS.update(_slice_pairs())


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_reference(name):
    port, ref = (_params(f) for f in PAIRS[name])
    if port and port[-1][0] == "device" and (not ref
                                             or ref[-1][0] != "device"):
        assert port[-1][2] is None, "device defaults to the card"
        port = port[:-1]
    assert [p[0] for p in port] == [p[0] for p in ref]
    assert [p[1] for p in port] == [p[1] for p in ref]
    # the defaults agree (the axis name is the same string in both), but
    # the named differences, which hold as stated
    for (pname, _, d_port), (_, _, d_ref) in zip(port, ref):
        if (name, pname) in DEFAULTS:
            assert (d_port, d_ref) == DEFAULTS[name, pname]
        else:
            assert d_port == d_ref, pname


@pytest.mark.parametrize("path", SLICE_MODULES + HOST_MODULES)
def test_slice_modules_export_the_reference_names(path):
    """Every public function and class of the reference's module is in the
    port's, and the result types have the reference's fields."""
    port, ref = _module_pair(path)
    missing = sorted(set(_public(ref)) - set(_public(port)))
    assert not missing, missing
    for name, robj in _public(ref).items():
        if inspect.isclass(robj) and issubclass(robj, tuple):
            assert getattr(port, name)._fields == robj._fields, name


def test_slice_package_exports():
    """``models`` and ``core`` export the reference's names; ``solver`` the
    reference's names of the squirmer and advection-diffusion modules (its
    CG names stay unexported: ``solver.cg`` is the module)."""
    for path in ("models", "core"):
        port, ref = _module_pair(path)
        assert sorted(port.__all__) == sorted(ref.__all__), path
    port, ref = _module_pair("solver")
    slice_names = {name for path in SLICE_MODULES if path.startswith("solver")
                   for name in _public(_module_pair(path)[1])}
    assert set(port.__all__) == set(ref.__all__) & slice_names
    from spectralelementmethod_torch.solver import cg as cg_module
    assert inspect.ismodule(cg_module)


def test_host_package_exports():
    """``plot2d`` exports the reference's names, ``ops`` the Kronecker
    array, and ``utils`` the reference's modules (and its own)."""
    port, ref = _module_pair("plot2d")
    assert sorted(port.__all__) == sorted(ref.__all__)
    port, ref = _module_pair("ops")
    assert port.KroneckerArray is importlib.import_module(
        "spectralelementmethod_torch.ops.sp_array").KroneckerArray
    port, ref = _module_pair("utils")
    assert set(ref.__all__) <= set(port.__all__)


def test_the_named_default_differences_exist():
    for (name, pname), want in DEFAULTS.items():
        port, ref = (inspect.signature(f).parameters[pname].default
                     for f in PAIRS[name])
        assert (port, ref) == want


def _poisson():
    prob = Poisson(Discretization(rectangle_mesh(4, 4, 2), gll_basis_2d(2)))
    prob.set_dirichlet("ebc", 0.0)
    return prob


# item None: ported since (pmg, item 3; certify, item 2; host_loop,
# compute_dtype and the en layout, item 15; fdm, item 8); the case checks
# that the option solves
UNPORTED = [
    ("solve_local", dict(host_loop=True), None),
    ("solve_local", dict(precond="pmg"), None),
    ("solve_local", dict(precond="fdm"), None),
    ("solve_local", dict(compute_dtype=np.float32), None),
    ("solve_local", dict(vector_layout="en"), None),
    ("solve_local", dict(certify=True), None),
    ("solve_local_batch", dict(precond="pmg"), None),
    ("solve_local_batch", dict(compute_dtype=np.float32), None),
    ("solve_local_batch", dict(vector_layout="en"), None),
]
# a compute_dtype of float32 rounds the float64 model's products to
# float32: the solution agrees to that precision (the others to 1e-8)
ROUNDED = 1e-6


@pytest.mark.parametrize("method,kw,item", UNPORTED,
                         ids=[f"{m}-{next(iter(k))}-{k[next(iter(k))]}"
                              for m, k, _ in UNPORTED])
def test_unported_parameters_raise(method, kw, item):
    prob = _poisson()
    args = ([np.ones((2, prob.disc.n_nodes))]
            if method == "solve_local_batch" else [])
    if item is None:
        sol = getattr(prob, method)(*args, tol=1e-10, device="cpu", **kw)
        assert np.all(sol.cg.converged.numpy())
        ref = getattr(prob, method)(*args, tol=1e-10, device="cpu")
        tol = ROUNDED if "compute_dtype" in kw else 1e-8
        np.testing.assert_allclose(sol.u, ref.u, rtol=0,
                                   atol=tol * np.abs(ref.u).max())
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        getattr(prob, method)(*args, device="cpu", **kw)


def test_positional_call_binds_the_reference_parameter():
    """The third positional argument is host_loop in both packages (it
    used to bind structure in the port): with certify on a float32 model
    it raises, as host_loop does."""
    prob = Poisson(Discretization(rectangle_mesh(4, 4, 2), gll_basis_2d(2)),
                   dtype=np.float32)
    prob.set_dirichlet("ebc", 0.0)
    with pytest.raises(ValueError, match="host_loop"):
        prob.solve_local(1e-8, 100, True, certify=True, device="cpu")
