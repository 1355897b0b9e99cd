"""Serving: batched prefill/decode engine with continuous batching slots."""

from repro_torch.serving.engine import ServeEngine, Request

__all__ = ["ServeEngine", "Request"]
