"""The port's Gmsh reader and writers against the JAX package's, on the CPU.

* the port's ``save_msh`` (binary and ASCII 2.2) and ``save_msh41`` write
  the reference's bytes, in 2D (a rectangle, a curved annulus) and 3D
  (``box_mesh`` at p = 2 and 3);
* the port's ``load_msh`` on the reference's files, on the reference's
  gmsh-layout fixtures (``tests/test_gmsh.py``: byte-assembled 2.2 and 4.1
  files, binary and ASCII) and on malformed files gives the reference's
  mesh (nodes, lexicographic cells, regions, boundary faces, adjacency) or
  its error;
* the spiral <-> lexicographic permutations of quads, lines and hexes;
* float64 Poisson solves on loaded meshes (``rectangle_mesh(3, 3, 4)``,
  ``box_mesh(2, 2, 2, 3)``) against the JAX package's: the same iterations,
  the solution within 1e-10.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import spectralelementmethod_tpu.mesh as jmesh
from spectralelementmethod_tpu.basis import gll_basis_2d as j_basis_2d
from spectralelementmethod_tpu.basis import gll_basis_3d as j_basis_3d
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import gmsh as jgmsh
from spectralelementmethod_tpu.models.poisson import Poisson as JPoisson

import spectralelementmethod_torch.mesh as tmesh
from spectralelementmethod_torch.basis import gll_basis_2d, gll_basis_3d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import gmsh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.utils import stages

torch.set_num_threads(2)

MESHES = {
    "rect": lambda m: m.rectangle_mesh(3, 2, 4),
    "annulus": lambda m: m.annulus_mesh(
        3, n_theta=6, n_r=3, r_inner=1.0, r_outer=2.0, progression=1.0,
        node_placement="polar"),
    "box-p2": lambda m: m.box_mesh(3, 2, 2, 2, x0=(0, 0, 0), x1=(3, 2, 2)),
    "box-p3": lambda m: m.box_mesh(2, 2, 2, 3),
}
FORMATS = ("binary22", "ascii22", "41")
NDIM = {"rect": 2, "annulus": 2, "box-p2": 3, "box-p3": 3}


def _save(mod, mesh, path, fmt):
    if fmt == "41":
        mod.save_msh41(mesh, path)
    else:
        mod.save_msh(mesh, path, binary=fmt == "binary22")


def _ref_fixture_writers():
    """The byte-assembled gmsh fixtures of the reference's tests."""
    path = os.path.join(os.path.dirname(__file__), "test_gmsh.py")
    spec = importlib.util.spec_from_file_location("_ref_test_gmsh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"22-binary": (mod._write_gmsh22_fixture, 2),
            "41-binary": (mod._write_gmsh41_fixture, 2),
            "22-ascii": (mod._write_gmsh22_ascii_fixture, 2),
            "41-ascii": (mod._write_gmsh41_ascii_fixture, 2)}


FIXTURES = _ref_fixture_writers()


def _state(m):
    """Everything a loaded mesh carries, as plain values."""
    chunks = [(tuple(m.get_geometry(c.geometry_id).shape), c.node_maps,
               c.region_ids) for c in m._chunks]
    return dict(
        nodes=m.nodes, chunks=chunks, regions=m.region_names,
        boundaries=m.boundary_names,
        faces={b: m.boundary_faces(b) for b in m.boundary_names},
        adj=(m._adj_cell, m._adj_face))


def _assert_same_mesh(port, ref):
    a, b = _state(port), _state(ref)
    np.testing.assert_array_equal(a["nodes"], b["nodes"])
    assert len(a["chunks"]) == len(b["chunks"])
    for (sa, na, ra), (sb, nb, rb) in zip(a["chunks"], b["chunks"]):
        assert sa == sb
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(ra, rb)
    assert a["regions"] == b["regions"]
    assert a["boundaries"] == b["boundaries"]
    for name in a["boundaries"]:
        np.testing.assert_array_equal(a["faces"][name], b["faces"][name])
    for x, y in zip(a["adj"], b["adj"]):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """The reference's files of every mesh and format, by (mesh, format)."""
    d = tmp_path_factory.mktemp("ref_msh")
    out = {}
    for kind, make in MESHES.items():
        mesh = make(jmesh)
        for fmt in FORMATS:
            out[kind, fmt] = str(d / f"{kind}-{fmt}.msh")
            _save(jgmsh, mesh, out[kind, fmt], fmt)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_writers_write_the_reference_bytes(kind, fmt, ref_files, tmp_path):
    path = str(tmp_path / "port.msh")
    _save(gmsh, MESHES[kind](tmesh), path, fmt)
    with open(path, "rb") as f, open(ref_files[kind, fmt], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_reader_matches_the_reference(kind, fmt, ref_files):
    """The port's reader on the reference's file gives the reference's
    mesh, which is the generated one (cells and faces included; ASCII
    writes coordinates to 16 significant digits, binary bit for bit)."""
    path = ref_files[kind, fmt]
    loaded = gmsh.load_msh(path, ndim=NDIM[kind])
    _assert_same_mesh(loaded, jgmsh.load_msh(path, ndim=NDIM[kind]))
    made = MESHES[kind](tmesh)
    np.testing.assert_allclose(loaded.nodes, made.nodes, rtol=0,
                               atol=0 if fmt != "ascii22" else 1e-15)
    for c1, c2 in zip(made.cells, loaded.cells):
        np.testing.assert_array_equal(c1.node_ind_lexicographic,
                                      c2.node_ind_lexicographic)
        assert c1.region_name == c2.region_name
    for name in made.boundary_names:
        np.testing.assert_array_equal(made.boundary_faces(name),
                                      loaded.boundary_faces(name))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_gmsh_layout_fixtures_load_as_the_reference(name, tmp_path):
    """Files the writers never emit (gmsh's own block and tag layouts) load
    as the reference loads them; the port's writer then writes the
    reference's bytes for the loaded mesh (several chunks and tags)."""
    write, ndim = FIXTURES[name]
    path = str(tmp_path / "fixture.msh")
    write(path)
    port, ref = gmsh.load_msh(path, ndim), jgmsh.load_msh(path, ndim)
    _assert_same_mesh(port, ref)
    for fmt in FORMATS:
        a, b = str(tmp_path / "a.msh"), str(tmp_path / "b.msh")
        _save(gmsh, port, a, fmt)
        _save(jgmsh, ref, b, fmt)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), fmt


def _malformed(tmp_path, case, ref_files):
    p = tmp_path / f"{case}.msh"
    if case == "garbage":
        p.write_bytes(b"not a mesh file\n")
    elif case == "header-only-ascii":
        p.write_bytes(b"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    elif case == "version-3":
        p.write_bytes(b"$MeshFormat\n3.0 0 8\n$EndMeshFormat\n")
    else:
        fmt = {"truncated-binary22": "binary22", "truncated-41": "41"}[case]
        with open(ref_files["rect", fmt], "rb") as f:
            raw = f.read()
        p.write_bytes(raw[: len(raw) // 2])
    return str(p)


@pytest.mark.parametrize("case", ["garbage", "header-only-ascii",
                                  "version-3", "truncated-binary22",
                                  "truncated-41"])
def test_malformed_files_raise_as_the_reference(case, tmp_path, ref_files):
    path = _malformed(tmp_path, case, ref_files)
    with pytest.raises(Exception) as ref_exc:
        jgmsh.load_msh(path, 2)
    with pytest.raises(Exception) as port_exc:
        gmsh.load_msh(path, 2)
    assert type(port_exc.value).__name__ == type(ref_exc.value).__name__
    assert str(port_exc.value) == str(ref_exc.value)
    if type(ref_exc.value) is jgmsh.FileFormatError:
        assert type(port_exc.value) is gmsh.FileFormatError


@pytest.mark.parametrize("shape", [(2,), (5,), (2, 2), (3, 3), (4, 6),
                                   (9, 9), (12, 12), (2, 2, 2), (3, 3, 3),
                                   (5, 5, 5), (9, 9, 9)])
def test_permutations_match_the_reference(shape):
    np.testing.assert_array_equal(gmsh.spiral_to_lex_permutation(shape),
                                  jgmsh.spiral_to_lex_permutation(shape))
    np.testing.assert_array_equal(gmsh.lex_to_spiral_permutation(shape),
                                  jgmsh.lex_to_spiral_permutation(shape))


def test_load_msh_counts_its_stage(ref_files):
    before = stages.snapshot().get("mesh/import", 0.0)
    gmsh.load_msh(ref_files["rect", "binary22"], 2)
    assert stages.snapshot()["mesh/import"] > before


SOLVES = {
    "rect": (lambda m: m.rectangle_mesh(3, 3, 4), 2, 4,
             lambda x, y: 0.2 * ((x + 1) + (y + 1))),
    "box": (lambda m: m.box_mesh(2, 2, 2, 3), 3, 3,
            lambda x, y, z: 0.1 * x + 0.2 * y - 0.05 * z),
}


@pytest.mark.parametrize("kind", sorted(SOLVES))
def test_float64_solve_on_a_loaded_mesh_matches_jax(kind, tmp_path):
    """Each package's own writer and reader, then Jacobi PCG on global
    vectors (``Poisson.solve``, float64) on both: the same iterations, the
    solutions within 1e-10 of each other and of the generated mesh's."""
    make, ndim, p, bc = SOLVES[kind]
    tb, jb = ((gll_basis_2d, j_basis_2d) if ndim == 2
              else (gll_basis_3d, j_basis_3d))
    path_t, path_j = str(tmp_path / "t.msh"), str(tmp_path / "j.msh")
    gmsh.save_msh(make(tmesh), path_t)
    jgmsh.save_msh(make(jmesh), path_j)
    port = Poisson(Discretization(gmsh.load_msh(path_t, ndim), tb(p)))
    ref = JPoisson(JaxDisc(jgmsh.load_msh(path_j, ndim), jb(p)))
    made = Poisson(Discretization(make(tmesh), tb(p)))
    for prob in (port, ref, made):
        prob.set_dirichlet("ebc", bc)
    sol = port.solve(tol=1e-12, host_loop=True, device="cpu")
    rsol = ref.solve(tol=1e-12, host_loop=True)
    msol = made.solve(tol=1e-12, host_loop=True, device="cpu")
    assert int(sol.cg.iterations) == int(rsol.cg.iterations)
    assert int(sol.cg.iterations) == int(msol.cg.iterations)
    np.testing.assert_allclose(sol.u, np.asarray(rsol.u), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(sol.u, msol.u)
