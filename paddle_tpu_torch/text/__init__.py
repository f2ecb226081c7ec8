"""Text models, the paged KV cache and the generation helpers."""
