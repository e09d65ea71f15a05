from .bert import (  # noqa: F401
    BertConfig,
    BertForPretraining,
    BertModel,
    ErnieConfig,
    ErnieForPretraining,
    ErnieModel,
)
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
