"""Out-of-core wave scheduling (paper §4.3/§4.4): factorize an R whose
ratings and Hermitians do not fit on the card at once — the port's
counterpart of the reference's ``repro/outofcore``, on one device or on
the cells of a ``launch.mesh.Mesh`` (``mesh=``, p > 1 theta shards).

- ``store``    — ``RatingStore`` (R and the q-partitioned R^T on the host,
  uniform or degree-binned), ``FactorStore``, ``TileStore``;
- ``schedule`` — the planner's (q, waves) as explicit wave work, the
  resident-bytes model and the per-wave streaming predictions;
- ``runtime``  — the modelled-device meter, telemetry, per-wave checkpoints;
- ``driver``   — ``run_streaming_als``: solve-X and accumulate-Theta waves,
  preloaded through ``data.prefetch.Prefetcher`` on a side CUDA stream,
  with the plan-vs-actual ledger;
- ``sgd_driver`` — ``run_streaming_sgd``: SGD tile waves through the same
  prefetcher, one planned kernel launch per same-K group of a wave.  The
  streaming hybrid is ``sgd.hybrid.run_streaming_hybrid``.
"""
from repro_torch.outofcore.driver import run_streaming_als
from repro_torch.outofcore.runtime import (MemoryMeter, SimulatedFailure,
                                           StreamTelemetry, WaveCheckpointer)
from repro_torch.outofcore.schedule import (IterationSchedule, SgdEpochSchedule,
                                            TileWave, Wave, WaveItem,
                                            build_schedule, build_sgd_schedule,
                                            required_capacity_bytes,
                                            sgd_required_capacity_bytes)
from repro_torch.outofcore.sgd_driver import run_streaming_sgd
from repro_torch.outofcore.store import (FactorStore, RatingStore, TileStore,
                                         binned_nbytes)

__all__ = [
    "FactorStore", "IterationSchedule", "MemoryMeter", "RatingStore",
    "SgdEpochSchedule", "SimulatedFailure", "StreamTelemetry", "TileStore",
    "TileWave", "Wave", "WaveCheckpointer", "WaveItem", "binned_nbytes",
    "build_schedule", "build_sgd_schedule", "required_capacity_bytes",
    "run_streaming_als", "run_streaming_sgd", "sgd_required_capacity_bytes",
]
