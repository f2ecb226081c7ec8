"""Text models of the port."""
from .convert import llama_from_numpy  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    llama_tiny_config)
