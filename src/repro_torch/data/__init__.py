"""Host->device data movement: the out-of-core prefetcher."""
from repro_torch.data.prefetch import Prefetcher

__all__ = ["Prefetcher"]
