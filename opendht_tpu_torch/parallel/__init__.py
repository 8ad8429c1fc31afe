"""Scale-out: sharded node tables on a device mesh and their exact top-k
merge, placed by the declarative partition-rule layer (partition.py) —
the port of the JAX package's ``parallel`` package."""

from .partition import (  # noqa: F401
    P,
    PartitionSpec,
    ShardedTensor,
    match_partition_rules,
    make_shard_and_gather_fns,
    shard_put,
    constrain,
    shard_table_state,
    TableState,
    TABLE_AXIS_RULES,
    DP_AXIS_RULES,
)
from .sharded import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_to_multiple,
    sharded_xor_topk,
    sharded_sort_table,
    sharded_expand_table,
    sharded_window_launch,
    sharded_window_lookup,
    sharded_lookup,
    sharded_maintenance_sweep,
    sharded_sketch_update,
    sharded_cache_probe,
    sharded_listener_match,
    dp_simulate_lookups,
    tp_simulate_lookups,
    build_tp_lookup,
)
