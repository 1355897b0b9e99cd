"""cuMF ALS — the paper's own workload as a dry-run config (the reference's
``configs/cumf_als.py``).

Shapes are the paper's Table 5 data sets.  A dry-run cell lays out one
SU-ALS update-X wave (fused Hermitian -> parallel reduction -> batch
solve) at the per-cell shapes the partition plan implies (eq. 8).
"""
import dataclasses

from repro_torch.sparse.synth import DATASETS, SynthSpec


@dataclasses.dataclass(frozen=True)
class AlsShape:
    name: str
    spec: SynthSpec
    rows_per_wave: int     # q-batch rows solved per wave (global)
    k_pad: int             # padded nnz/row within a column shard


# K_pad: mean nnz/row x skew headroom, rounded to 128 (see sparse/synth.py).
ALS_SHAPES = {
    "netflix":    AlsShape("netflix", DATASETS["netflix"], 1 << 19, 512),
    "hugewiki":   AlsShape("hugewiki", DATASETS["hugewiki"], 1 << 21, 128),
    "facebook_f100": AlsShape("facebook_f100", DATASETS["cumf_max"], 1 << 22, 256),
}
