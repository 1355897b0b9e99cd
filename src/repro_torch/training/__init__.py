"""Training substrate: the learning-rate schedule (the only part of the
reference's ``training/optimizer.py`` the SGD solver needs so far)."""
from repro_torch.training.optimizer import lr_schedule

__all__ = ["lr_schedule"]
