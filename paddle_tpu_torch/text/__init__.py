"""Text models, the paged KV cache, the generation helpers and the
Viterbi decoder."""
from .viterbi import ViterbiDecoder, viterbi_decode  # noqa: F401
