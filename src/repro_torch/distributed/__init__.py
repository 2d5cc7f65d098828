"""Scale-out of the port: logical-axis sharding rules and the mesh
(:mod:`.sharding`), and the device-sharded circuit solver
(:mod:`.solver_shard`)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    RULE_SETS,
    Mesh,
    ShardingCtx,
    logical_spec,
)
from repro_torch.distributed.solver_shard import (  # noqa: F401
    ShardedSolveResult,
    measured_nf_sharded,
    solve_crossbar_sharded,
    tile_mesh,
    tile_sharding_ctx,
)
