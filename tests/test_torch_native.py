"""The port's native (C++) meshkit against the JAX package's build, on the
CPU: ``match_keys``, ``lookup_keys`` and ``locate_points`` (with
``max_candidates`` and points outside the mesh), the port's
``core.pointlocate.locate_points`` on both paths, and
``Mesh.find_neighbors``'s adjacency against the native hash's.  The library is
built by ``g++`` at first use; the tests need the toolchain (the JAX
package's own native tests skip without it), and a build that fails is
logged.
"""

import fcntl
import os
import sysconfig
import time

import numpy as np
import pytest
import torch

from spectralelementmethod_tpu import native as jnative
from spectralelementmethod_tpu.basis import gll_basis_2d as j_basis_2d
from spectralelementmethod_tpu.core import pointlocate as jploc
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import annulus_mesh as j_annulus

from spectralelementmethod_torch import native
from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core import pointlocate as ploc
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import (annulus_mesh, box_mesh,
                                              rectangle_mesh)

torch.set_num_threads(2)

ANNULUS = dict(n_theta=6, n_r=8)


@pytest.fixture(scope="module", autouse=True)
def reference_library(tmp_path_factory):
    """The reference's native library, loaded in this worker.

    The reference compiles ``meshkit.cpp`` into one temporary name that
    every process shares and remembers a failed build for the life of the
    process, so on a tree with no library two xdist workers building at
    once can spoil each other's build and leave one of them without it.
    When the first load fails, wait (under a lock the workers share) for a
    finished library to be in place, forget the failure and load again."""
    if jnative._load() is not None:
        return
    lock = tmp_path_factory.getbasetemp().parent / "reference-meshkit.lock"
    out = os.path.join(os.path.dirname(jnative.__file__), "_meshkit"
                       + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        deadline = time.monotonic() + 120.0
        while True:
            if os.path.exists(out) or time.monotonic() > deadline:
                jnative._TRIED = False
                if jnative._load() is not None or \
                        time.monotonic() > deadline:
                    return
            time.sleep(0.5)


@pytest.fixture(scope="module")
def discs():
    """The port's and the reference's discretization of one curved annulus
    (the reference's native test mesh)."""
    return (Discretization(annulus_mesh(4, **ANNULUS), gll_basis_2d(4)),
            JaxDisc(j_annulus(4, **ANNULUS), j_basis_2d(4)))


def _points(n, seed=1):
    """Seeded points of the annulus (r in [1, 100], theta in [0, pi]) and
    beyond it (r up to 130, and the left half plane)."""
    rng = np.random.RandomState(seed)
    r = np.exp(rng.uniform(np.log(1.05), np.log(130.0), n))
    th = rng.uniform(0.05, np.pi - 0.05, n)
    pts = np.stack([r * np.sin(th), r * np.cos(th)], axis=1)
    pts[::9, 0] *= -1.0                        # outside: x < 0
    return pts


def test_both_builds_are_available():
    assert native.available() and jnative.available()
    assert native.library_path().parent.name == "_build"


def test_match_keys_pairs_and_singletons():
    keys = np.array([5, 9, 5, 7, 9, 11], dtype=np.int64)
    assert native.match_keys(keys).tolist() == [2, 4, 0, -1, 1, -1]


def test_match_keys_triple_raises_as_the_reference():
    keys = np.array([3, 3, 3], dtype=np.int64)
    with pytest.raises(ValueError) as ref:
        jnative.match_keys(keys)
    with pytest.raises(ValueError) as port:
        native.match_keys(keys)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_and_lookup_keys_match_the_reference(seed):
    rng = np.random.RandomState(seed)
    uniq = np.unique(rng.randint(0, 50_000, size=4_000).astype(np.int64))
    keys = np.concatenate([uniq, uniq[: uniq.size // 2]])
    rng.shuffle(keys)
    np.testing.assert_array_equal(native.match_keys(keys),
                                  jnative.match_keys(keys))
    query = rng.randint(-10, 50_010, size=3_000).astype(np.int64)
    np.testing.assert_array_equal(native.lookup_keys(uniq, query),
                                  jnative.lookup_keys(uniq, query))


@pytest.mark.parametrize("max_candidates", [1, 4, 16])
def test_locate_points_matches_the_reference(discs, max_candidates):
    """The port's locator (through ``core.pointlocate``) against the
    reference's native build: the elements (-1 outside) and xi."""
    disc, jdisc = discs
    pts = _points(400)
    e, xi = ploc.locate_points(disc, pts, max_candidates=max_candidates)
    je, jxi = jploc.locate_points(jdisc, pts, max_candidates=max_candidates)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_allclose(xi[e >= 0], jxi[je >= 0], rtol=0, atol=1e-12)
    assert (e < 0).any() and (e >= 0).any()


def test_native_locator_agrees_with_the_numpy_scan(discs, monkeypatch):
    """The bin-grid locator and the per-point scan (the fallback without a
    toolchain) find the same elements, -1 outside, xi within 1e-10."""
    disc, _ = discs
    pts = _points(60, seed=3)
    e, xi = ploc.locate_points(disc, pts)
    monkeypatch.setattr(native, "available", lambda: False)
    se, sxi = ploc.locate_points(disc, pts)
    np.testing.assert_array_equal(e, se)
    np.testing.assert_allclose(xi, sxi, rtol=0, atol=1e-10)


def test_locate_points_with_extrapolation_matches_the_reference(discs):
    disc, jdisc = discs
    r = np.array([100.0 + 1e-6, 1.0 - 1e-7, 50.0])
    th = np.array([0.3, 1.2, 2.0])
    pts = np.stack([r * np.sin(th), r * np.cos(th)], axis=1)
    e, xi = ploc.locate_points(disc, pts, extrapolate_tol=1e-3)
    je, jxi = jploc.locate_points(jdisc, pts, extrapolate_tol=1e-3)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_allclose(xi, jxi, rtol=0, atol=1e-12)


@pytest.mark.parametrize("make", [
    lambda: rectangle_mesh(5, 4, 3),
    lambda: annulus_mesh(3, n_theta=7, n_r=5),
    lambda: box_mesh(3, 2, 2, 2),
], ids=["rectangle", "annulus", "box"])
def test_find_neighbors_with_and_without_native(make):
    """``Mesh.find_neighbors`` sorts the face keys (the native hash did not
    beat the sort at 100k cells, so it is not wired there); its adjacency
    equals the native hash's pairing of the same keys."""
    mesh = make()
    mesh.find_neighbors()
    keys, cells, faces = mesh._face_keys()
    if keys.ndim == 2:                        # one int64 key per face
        keys = np.unique(keys, axis=0, return_inverse=True)[1].ravel()
    partner = native.match_keys(keys.astype(np.int64))
    adj_cell = np.full_like(mesh._adj_cell, -1)
    adj_face = np.full_like(mesh._adj_face, -1)
    m = partner >= 0
    adj_cell[cells[m], faces[m]] = cells[partner[m]]
    adj_face[cells[m], faces[m]] = faces[partner[m]]
    np.testing.assert_array_equal(adj_cell, mesh._adj_cell)
    np.testing.assert_array_equal(adj_face, mesh._adj_face)
    assert (adj_cell >= 0).any()


def test_a_failed_build_is_logged(tmp_path, monkeypatch, capfd):
    bad = tmp_path / "meshkit.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert native._build_lib() is None
    err = capfd.readouterr().err
    assert "meshkit build failed" in err and "g++" in err
    assert not list((tmp_path / "_build").glob("*.so"))
