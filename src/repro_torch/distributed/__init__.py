"""The multi-device path, single-controller: one host program drives the
cells of a ``launch.mesh.Mesh`` (cards, or cells sharing one card).

- collectives.py : one-phase (flat) and two-phase (topology-aware)
                   reduce-scatter over per-cell tensors — paper §4.2;
- reduce.py      : the same two-phase scheme as a host-scheduled staged
                   reduction (ring within fast domains, tree across them) —
                   combines the streaming drivers' per-data-shard partials;
- su_als.py      : SU-ALS (paper Alg. 3) over the cells, and the per-wave
                   mesh entry points the out-of-core drivers dispatch through.

The reference's LM modules (``sharding``, ``flash_decode``,
``cache_update``) belong to the LM substrate and are not ported.
"""
from repro_torch.distributed.collectives import (
    all_gather,
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
    su_als_update,
)

__all__ = [
    "DeviceTopology",
    "all_gather",
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
    "su_als_update",
    "topology_reduce",
]
