"""Multi-card training and inference of the port: process groups and the
``('data', 'model')`` mesh with the device-topology stamp (``mesh``), the
partition rules (``partition``), the storage of a partitioned train state
(``sharded``), the height split of inference (``spatial``) and the
host→device input placement (``device_prefetch``)."""
from .mesh import (
    barrier,
    initialize_distributed,
    make_mesh,
    mesh_topology,
    reshard_replicated,
    shard_batch,
    shutdown_distributed,
    topology_mismatch,
)
from .partition import (
    NAMED_RULESETS,
    PartitionRule,
    UnmatchedLeafError,
    get_ruleset,
    imhn_fsdp_rules,
    imhn_partition_rules,
    match_partition_rules,
    refine_spec,
    reshard_tree,
    rules_fingerprint,
    sharding_summary,
    train_state_shardings,
)
from .prefetch import device_prefetch

__all__ = [
    "NAMED_RULESETS",
    "PartitionRule",
    "UnmatchedLeafError",
    "barrier",
    "device_prefetch",
    "get_ruleset",
    "imhn_fsdp_rules",
    "imhn_partition_rules",
    "initialize_distributed",
    "make_mesh",
    "match_partition_rules",
    "mesh_topology",
    "refine_spec",
    "reshard_replicated",
    "reshard_tree",
    "rules_fingerprint",
    "shard_batch",
    "sharding_summary",
    "shutdown_distributed",
    "topology_mismatch",
    "train_state_shardings",
]
