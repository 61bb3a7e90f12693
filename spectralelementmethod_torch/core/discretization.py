"""Element-batched discretization: DOF management + precomputed geometry.

TPU-first replacement of the reference's ``DOFManager``/``FiniteElement``
object graph (``sem/discrete.py:44-280, 531-705``):

* DOF numbering is a **pure function of the immutable mesh** — global DOF
  ``dof = node * dofs_per_node + component`` with mesh node indices taken
  as-is (the reference instead mutates the mesh node order per DOFManager,
  see its FIXME at ``sem/discrete.py:119-122``).  No RCM: iterative solves
  and batched dense element work are ordering-independent.
* All per-element quantities are struct-of-arrays with a leading element
  axis ``E``, precomputed once at setup: gather maps, mapping coefficients,
  Jacobians, ``detJ x W`` — the "compute flags" machinery of the reference
  (``sem/discrete.py:126-140``) disappears because everything is computed
  eagerly in one vectorized pass.
* Direct stiffness summation (global assembly) is a device-side
  scatter-add over the gather map — the TPU equivalent of the reference's
  COO duplicate-summing assembly (``sem/discrete.py:478-500``).
"""

from __future__ import annotations

import numpy as np

from ..basis.tensor import TensorProductQS
from ..mesh.mesh import Mesh
from ..utils.stages import stage
from . import mapping as mp


class Discretization:
    """Batched discretization of a (single-geometry) mesh.

    Parameters
    ----------
    mesh : Mesh
        Host mesh.  All cells must share one geometry (uniform p); this is
        the common case and the one the device path batches over.
    basis : TensorProductQS
        Nodal tensor-product basis with a quadrature rule on its nodes.
        The basis node count per axis must match the cell geometry shape.
    dofs_per_node : int
        Interleaved DOFs per mesh node (reference ``sem/discrete.py:81``).
    mapping_basis : optional
        Basis for the isoparametric mapping (defaults to ``basis``).
    """

    def __init__(
        self,
        mesh: Mesh,
        basis: TensorProductQS,
        dofs_per_node: int = 1,
        mapping_basis=None,
    ):
        self.mesh = mesh
        self.basis = basis
        self.map_basis = mapping_basis if mapping_basis is not None else basis
        self.dpn = int(dofs_per_node)

        blocks = mesh.cell_blocks()
        if len(blocks) != 1:
            raise NotImplementedError(
                "Discretization currently requires a single cell geometry "
                f"(got {len(blocks)} blocks)"
            )
        geometry, cell_nums, node_maps = blocks[0]
        if tuple(geometry.shape) != tuple(basis.coeff_shape):
            raise ValueError(
                f"basis coeff shape {basis.coeff_shape} != cell geometry "
                f"shape {geometry.shape}"
            )
        self.geometry = geometry
        self.shape = tuple(geometry.shape)
        self.n_loc = geometry.n_nodes
        self.E = len(cell_nums)

        #: (E, n_loc) global node index of each local (lexicographic) node
        self.gather_nodes = np.ascontiguousarray(
            node_maps.reshape(self.E, -1), dtype=np.int32
        )

        # ---- batched geometry precompute (host, float64) ----
        # fused GEMM pipeline (equispaced parametric cell nodes -> GLL
        # mapping coefficients -> Jacobians); see mp.batched_geometry_2d
        geom_fn = (mp.batched_geometry_2d if mesh.ndim == 2
                   else mp.batched_geometry_3d)
        with stage("disc/geometry"):
            self.x_coeffs, self.J, self.detJ, self.invJ = (
                geom_fn(self.map_basis, mesh.nodes, node_maps)
            )
            if not np.all(self.detJ > 0):
                bad = np.argwhere(~(self.detJ > 0))
                raise ValueError(
                    f"non-positive Jacobian determinant in cell(s) "
                    f"{np.unique(bad[:, 0])[:10]} (mapping is "
                    f"tangled or mis-oriented)"
                )
        #: (*shape,) quadrature weight grid
        self.W = basis.weight_grid()
        #: (E, *shape) detJ times quadrature weights
        self.detJxW = self.detJ * self.W

        self._face_geoms: dict[str, mp.FaceGeometry] = {}

    # -- sizes ---------------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self.mesh.n_nodes

    @property
    def ndof(self) -> int:
        return self.mesh.n_nodes * self.dpn

    @property
    def ndim(self) -> int:
        return self.basis.ndim

    # -- DSS / gather-scatter (host versions; jit versions in ops) ------------

    def gather(self, u_node: np.ndarray) -> np.ndarray:
        """(..., n_nodes) global nodal field -> (..., E, *shape) local."""
        out = np.asarray(u_node)[..., self.gather_nodes]
        return out.reshape(out.shape[:-1] + self.shape)

    def scatter_add(self, vals: np.ndarray) -> np.ndarray:
        """(E, *shape) local contributions -> (n_nodes,) summed global.

        Direct stiffness summation; parity with COO duplicate-summation
        semantics (``sem/discrete.py:40-41``).
        """
        out = np.zeros(self.n_nodes, dtype=np.asarray(vals).dtype)
        np.add.at(out, self.gather_nodes.ravel(), np.asarray(vals).ravel())
        return out

    def node_multiplicity(self) -> np.ndarray:
        """(n_nodes,) number of elements touching each node."""
        return self.scatter_add(np.ones((self.E, *self.shape)))

    def global_gll_coords(self) -> np.ndarray:
        """(ndim, n_nodes) physical coordinates of the *GLL* nodes.

        Mesh nodes are equispaced within cells (Gmsh convention); the DOFs
        live at the GLL points.  Shared nodes get consistent values from
        every adjacent element (conforming mesh), so a plain overwrite
        scatter is well-defined.
        """
        out = np.zeros((self.mesh.ndim, self.n_nodes))
        flat = self.gather_nodes.ravel()
        for d in range(self.mesh.ndim):
            out[d, flat] = self.x_coeffs[:, d].ravel()
        return out

    def values_at_nodes(self, coeffs: np.ndarray) -> np.ndarray:
        """Resample a global GLL-nodal field onto the equispaced mesh nodes.

        Parity: reference ``DOFManager.values_at_nodes``
        (``sem/discrete.py:235-258``) — used for plotting, where node
        positions are the mesh's equispaced cell nodes.  Shared nodes get
        consistent values from every adjacent element (the face restriction
        of the tensor-product interpolant depends only on face data).
        """
        ue = self.gather(coeffs)                      # (..., E, *shape)
        vals = self.basis.interpolate_on_grid_eq(ue)
        out = np.zeros_like(np.asarray(coeffs))
        out[..., self.gather_nodes.reshape(-1)] = np.asarray(vals).reshape(
            vals.shape[: -1 - self.ndim] + (-1,)
        )
        return out

    def integrate(self, u_node: np.ndarray) -> float:
        """Integrate a global nodal field over the mesh: sum_e u_e . detJxW."""
        return float(np.sum(self.gather(u_node) * self.detJxW))

    # -- DOF helpers -----------------------------------------------------------

    def dof_index(self, node_ind: np.ndarray, component: int = 0) -> np.ndarray:
        """Global DOF index of (node, component) with interleaved layout."""
        return np.asarray(node_ind) * self.dpn + component

    # -- boundary face geometry -------------------------------------------------

    def face_geometry_groups(self, boundary_name: str) -> list:
        """Oriented face-geometry batches for a named boundary (cached).

        One :class:`..core.mapping.FaceGeometry` per face-length group: on
        anisotropic cells a boundary can mix faces of different node
        counts, which cannot share one (k, m) batch.  Isotropic
        boundaries yield a single group.  Works for 2D (CCW 1D faces)
        and 3D (outward right-handed quadrilateral faces).
        """
        if boundary_name not in self._face_geoms:
            pairs = self.mesh.boundary_faces(boundary_name)
            # group faces by their oriented face-grid shape: on
            # anisotropic cells different face ids can share a node
            # COUNT yet carry different in-plane axis lengths (hence
            # different quadrature-weight vectors), so the shape tuple —
            # not the count — is the batching key
            fkeys = [mp.subface_index_array(f, self.shape).shape
                     for f in range(2 * self.ndim)]
            groups = []
            seen = []
            for f in (pairs[:, 1] if pairs.size else []):
                if fkeys[f] not in seen:
                    seen.append(fkeys[f])
            for key in seen:
                sel = np.asarray([fkeys[f] == key for f in pairs[:, 1]])
                groups.append(mp.face_geometry(
                    self.map_basis, self.x_coeffs, self.J,
                    pairs[sel, 0], pairs[sel, 1],
                ))
            self._face_geoms[boundary_name] = groups
        return self._face_geoms[boundary_name]

    def face_geometry(self, boundary_name: str) -> mp.FaceGeometry:
        """Single-batch face geometry (uniform face length boundaries)."""
        groups = self.face_geometry_groups(boundary_name)
        if len(groups) != 1:
            raise NotImplementedError(
                f"boundary {boundary_name!r} mixes face node counts "
                f"(anisotropic cells); use face_geometry_groups")
        return groups[0]

    def _face_nodes_of(self, fg: mp.FaceGeometry) -> np.ndarray:
        return np.take_along_axis(
            self.gather_nodes[fg.cells], fg.local_ind, axis=1
        )

    def face_global_nodes(self, boundary_name: str) -> np.ndarray:
        """(k, m) global node indices along each face of a boundary."""
        return self._face_nodes_of(self.face_geometry(boundary_name))

    def boundary_node_set(self, *boundary_names: str) -> np.ndarray:
        """Sorted unique global node indices on the named boundaries."""
        if self.mesh.ndim == 3:
            # 3D: plain unoriented face node sets (FaceGeometry — normals,
            # surface measures — is 2D-parent only, like the reference)
            loc = np.arange(self.n_loc).reshape(self.shape)
            idx = []
            for name in boundary_names:
                pairs = self.mesh.boundary_faces(name)
                for f in np.unique(pairs[:, 1]) if pairs.size else []:
                    ax, end = divmod(int(f), 2)
                    sl = [slice(None)] * 3
                    sl[ax] = -1 if end else 0
                    li = loc[tuple(sl)].ravel()
                    cells = pairs[pairs[:, 1] == f, 0]
                    idx.append(self.gather_nodes[cells][:, li].ravel())
            return (np.unique(np.concatenate(idx)) if idx
                    else np.zeros(0, np.int64))
        idx = [self._face_nodes_of(fg).ravel()
               for n in boundary_names
               for fg in self.face_geometry_groups(n)]
        return np.unique(np.concatenate(idx)) if idx else np.zeros(0, np.int64)

    # -- geometric factors for common operators ---------------------------------

    def laplacian_factors(self, coefficient: np.ndarray | None = None) -> np.ndarray:
        """Packed symmetric geometric factors for the scalar Laplacian.

        G[e, :, m, n] = (c * detJ * W * invJ invJ^T)[(0,0), (0,1), (1,1)]
        — exactly the contraction kernel of the reference's assembled
        ``Lse`` operator (``examples/poisson.py:180-193``) in matrix-free
        form.  ``coefficient``: optional (E, *shape) variable coefficient.

        """
        gi = self.invJ  # (E, d, d, *shape): invJ[a, i] = dxi_a/dx_i
        scale = self.detJxW
        if coefficient is not None:
            scale = scale * coefficient
        d = self.mesh.ndim
        if d == 2:
            g00 = scale * (gi[:, 0, 0] ** 2 + gi[:, 0, 1] ** 2)
            g01 = scale * (gi[:, 0, 0] * gi[:, 1, 0]
                           + gi[:, 0, 1] * gi[:, 1, 1])
            g11 = scale * (gi[:, 1, 0] ** 2 + gi[:, 1, 1] ** 2)
            return np.stack([g00, g01, g11], axis=1)
        # 3D: upper triangle of invJ invJ^T, packed
        # [G00, G01, G02, G11, G12, G22]
        comps = []
        for a in range(3):
            for b in range(a, 3):
                comps.append(scale * (gi[:, a, 0] * gi[:, b, 0]
                                      + gi[:, a, 1] * gi[:, b, 1]
                                      + gi[:, a, 2] * gi[:, b, 2]))
        return np.stack(comps, axis=1)
