"""Element-axis sharding and partitioning (PyTorch port).

The ported part of the JAX package's ``parallel``: element orders for
shard locality (:mod:`.partition`), the halo-exchange operators
(:mod:`.halo`) and the element-sharded L-vector Poisson setup
(:mod:`.sharding`), with the shards as column blocks on one device.
"""

from .halo import (ELEM_AXIS, block_roll, global_roll, make_halo_dss_3d,
                   make_halo_dss_T,
                   make_sharded_fused_operator, make_sharded_local_operator,
                   stack_class_masks)
from .partition import (cut_faces, morton_order, panel_order, rcm_order,
                        reorder_elements)
from .sharding import (DeviceMesh, device_mesh, pad_element_arrays,
                       pad_elements, sharded_local_poisson_problem,
                       sharded_local_poisson_problem_3d)

__all__ = [
    "ELEM_AXIS",
    "DeviceMesh",
    "block_roll",
    "cut_faces",
    "device_mesh",
    "global_roll",
    "make_halo_dss_3d",
    "make_halo_dss_T",
    "make_sharded_fused_operator",
    "make_sharded_local_operator",
    "morton_order",
    "pad_element_arrays",
    "pad_elements",
    "panel_order",
    "rcm_order",
    "reorder_elements",
    "sharded_local_poisson_problem",
    "sharded_local_poisson_problem_3d",
    "stack_class_masks",
]
