"""The multi-device path, single-controller: one host program drives the
cells of a ``launch.mesh.Mesh`` (cards, or cells sharing one card).

- collectives.py : one-phase (flat) and two-phase (topology-aware)
                   reduce-scatter over per-cell tensors — paper §4.2 — and
                   the LM's FSDP all-gather (``all_gather_over``);
- reduce.py      : the same two-phase scheme as a host-scheduled staged
                   reduction (ring within fast domains, tree across them) —
                   combines the streaming drivers' per-data-shard partials;
- su_als.py      : SU-ALS (paper Alg. 3) over the cells: one half-step on
                   resident column shards, run by ``core.als.als_train_binned
                   (..., mesh=)`` and by the reference's interface, which the
                   dry-run and the out-of-core waves use;
- sharding.py    : the LM's logical-axis policies and ``Sharded``, a tensor
                   laid out as one block a cell (parameters and train
                   states);
- flash_decode.py: decode attention over a sequence- or kv-sharded cache,
                   per-cell partial softmax combined over the cells;
- cache_update.py: local writes into a sharded KV cache.
"""
from repro_torch.distributed.collectives import (
    all_gather,
    all_reduce,
    collective_bytes_reduce,
    hierarchical_reduce_scatter,
    reduce_scatter_flat,
)
from repro_torch.distributed.reduce import (
    DeviceTopology,
    allreduce_oracle,
    linear_topology,
    reduce_traffic,
    topology_reduce,
)
from repro_torch.distributed.su_als import (
    make_su_als_fns,
    make_wave_herm_fn,
    make_wave_update_fn,
    shard_ratings,
    shard_rows,
)

__all__ = [
    "DeviceTopology",
    "all_gather",
    "all_reduce",
    "allreduce_oracle",
    "collective_bytes_reduce",
    "hierarchical_reduce_scatter",
    "linear_topology",
    "make_su_als_fns",
    "make_wave_herm_fn",
    "make_wave_update_fn",
    "reduce_scatter_flat",
    "reduce_traffic",
    "shard_ratings",
    "shard_rows",
    "topology_reduce",
]
