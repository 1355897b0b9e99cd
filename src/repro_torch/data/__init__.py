"""Host->device data movement (the out-of-core prefetcher) and the LM token
pipeline."""
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.tokens import TokenDataset, synthetic_lm_batches

__all__ = ["Prefetcher", "TokenDataset", "synthetic_lm_batches"]
