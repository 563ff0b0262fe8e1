"""Data parallelism over ``torch.distributed`` (counterpart of
facegen/parallel/mesh.py and multihost.py)."""

from facegen_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
    replicate,
    resolve_mesh_shape,
    shard_pool,
)
from facegen_torch.parallel.multihost import (  # noqa: F401
    is_multiprocess,
    maybe_initialize,
    warmup_collectives,
)
