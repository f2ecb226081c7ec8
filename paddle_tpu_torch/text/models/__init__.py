"""Text models of the port: LLaMA, GPT and BERT as `nn.Layer`s with the
reference's state dicts."""
from .bert import (BertConfig, BertForSequenceClassification,  # noqa: F401
                   BertModel)
from .convert import (bert_from_numpy, bert_to_numpy,  # noqa: F401
                      gpt_from_numpy, gpt_to_numpy, llama_from_numpy,
                      llama_to_numpy, serving_params_from_numpy,
                      state_dict_shapes)
from .gpt import GPTConfig, GPTForCausalLM  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    llama_7b_config, llama_tiny_config)
