"""SGD solver subsystem (CuMF_SGD, arxiv 1610.05838) — peer of core/als.py.

- ``blocking``  — g x g (user-block, item-block) matrix blocking of the
  rating COO plus the conflict-free diagonal block-set schedule;
- ``train``     — the batch-Hogwild epoch driver (lr schedules, RMSE
  tracking, checkpointing);
- ``hybrid``    — ALS-warm-start -> SGD-refine (Tan et al. 1808.03843),
  in core (``hybrid_train``) and streamed out of core
  (``run_streaming_hybrid``).

The per-tile sweep is ``repro_torch.kernels.sgd_update`` (CUDA kernel,
plain version in ``repro_torch.kernels.ref``).
"""
from repro_torch.sgd.blocking import (BlockGrid, block_coo, block_ell,
                                      diagonal_sets, ell_to_coo)
from repro_torch.sgd.hybrid import (hybrid_train, run_streaming_hybrid,
                                   sgd_state_from_als)
from repro_torch.sgd.train import (SgdConfig, SgdState, epoch_set_order,
                                   sgd_epoch, sgd_init, sgd_state_from_numpy,
                                   sgd_train)

__all__ = [
    "BlockGrid", "block_coo", "block_ell", "diagonal_sets", "ell_to_coo",
    "SgdConfig", "SgdState", "epoch_set_order", "sgd_epoch", "sgd_init",
    "sgd_state_from_numpy", "sgd_train", "hybrid_train", "run_streaming_hybrid",
    "sgd_state_from_als",
]
