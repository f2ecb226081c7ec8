"""Text models of the port."""
from .convert import (llama_from_numpy, llama_to_numpy,  # noqa: F401
                      serving_params_from_numpy)
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    llama_tiny_config)
