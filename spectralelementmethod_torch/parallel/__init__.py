"""Element-axis sharding and partitioning (PyTorch port).

The JAX package's ``parallel``: element orders for shard locality
(:mod:`.partition`), the halo-exchange operators (:mod:`.halo`), the device
meshes and the element-sharded Poisson setups (:mod:`.sharding`: the
replicated-vector operator, the L-vector path with Jacobi or p-multigrid,
the 3D box path), with the shards as element blocks on one device.
"""

from .halo import (ELEM_AXIS, block_roll, global_roll, make_halo_dss_3d,
                   make_halo_dss_T,
                   make_sharded_fused_operator, make_sharded_local_operator,
                   stack_class_masks)
from .partition import (cut_faces, morton_order, panel_order, rcm_order,
                        reorder_elements)
from .sharding import (DeviceMesh, device_mesh, hybrid_device_mesh,
                       make_sharded_poisson_operator, pad_element_arrays,
                       pad_elements, replicated, shard_element_arrays,
                       sharded_local_poisson_problem,
                       sharded_local_poisson_problem_3d,
                       sharded_poisson_problem)

__all__ = [
    "ELEM_AXIS",
    "DeviceMesh",
    "block_roll",
    "cut_faces",
    "device_mesh",
    "global_roll",
    "hybrid_device_mesh",
    "make_halo_dss_3d",
    "make_halo_dss_T",
    "make_sharded_fused_operator",
    "make_sharded_local_operator",
    "make_sharded_poisson_operator",
    "morton_order",
    "pad_element_arrays",
    "pad_elements",
    "panel_order",
    "rcm_order",
    "reorder_elements",
    "replicated",
    "shard_element_arrays",
    "sharded_local_poisson_problem",
    "sharded_local_poisson_problem_3d",
    "sharded_poisson_problem",
    "stack_class_masks",
]
