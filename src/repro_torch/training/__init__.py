"""Training substrate: the learning-rate schedule and the AdamW and
Adafactor optimizers (the reference's ``training/optimizer.py``)."""
from repro_torch.training.optimizer import (AdafactorState, AdamState, OptConfig,
                                            clip_by_global_norm, global_norm,
                                            lr_schedule, make_optimizer)

__all__ = ["AdafactorState", "AdamState", "OptConfig", "clip_by_global_norm",
           "global_norm", "lr_schedule", "make_optimizer"]
