"""Data parallelism over ``torch.distributed`` (counterpart of
facegen/parallel/mesh.py, gspmd.py and multihost.py): the local-batch 1-D
data mesh and the 2-D data x model mesh with global-batch semantics."""

from facegen_torch.parallel.gspmd import (  # noqa: F401
    Mesh2D,
    ShardedParams,
    ensure_mesh2d,
    hybrid_mesh,
    leaf_spec,
    make_mesh2d,
    mesh2d_from_shape,
)
from facegen_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    global_mesh,
    make_mesh,
    replicate,
    resolve_mesh_shape,
    shard_pool,
    training_mesh,
)
from facegen_torch.parallel.multihost import (  # noqa: F401
    is_multiprocess,
    maybe_initialize,
    warmup_collectives,
)
