"""Serving: the continuous-batching engine over the paged KV cache."""
from .engine import Request, ServingEngine, generate_paged  # noqa: F401
