"""Distributed execution over ``torch.distributed`` process groups
(counterpart of ``rustrobotics_tpu/parallel``).

Meshes of ranks (``make_mesh``, ``make_mesh_2d``), edge-sharded
Gauss-Newton / Levenberg-Marquardt with all-reduced normal equations and
PCG, the sharded particle filter, and map-block optimization (nodes and
edges partitioned by an RCM layout, halo-exchange PCG, Schwarz
preconditioning, Schur elimination, replica rows for multi-start). On one H100 the group is NCCL at
world size 1; gloo groups on the CPU run any world size.
"""

from rustrobotics_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
)
from rustrobotics_tpu_torch.parallel.pgo_sharded import (  # noqa: F401
    distributed_gn_step,
    distributed_global_error,
    distributed_optimize,
    pad_edges_for_sharding,
)
from rustrobotics_tpu_torch.parallel.pf_sharded import (  # noqa: F401
    sharded_pf_step,
)
from rustrobotics_tpu_torch.parallel.block_layout import (  # noqa: F401
    build_block_layout,
)
from rustrobotics_tpu_torch.parallel.pgo_blocks import (  # noqa: F401
    block_optimize,
    block_optimize_multistart,
    comm_budget,
    make_block_optimize,
    make_block_step,
)
