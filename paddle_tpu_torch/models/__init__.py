from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
