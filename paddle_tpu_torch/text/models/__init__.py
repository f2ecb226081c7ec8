"""Text models of the port."""
from .bert import (BertConfig, BertForSequenceClassification,  # noqa: F401
                   BertModel)
from .convert import (bert_from_numpy, bert_to_numpy,  # noqa: F401
                      gpt_from_numpy, gpt_to_numpy, llama_from_numpy,
                      llama_to_numpy, serving_params_from_numpy)
from .gpt import GPTConfig, GPTForCausalLM  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    llama_tiny_config)
