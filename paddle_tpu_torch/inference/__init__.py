from .llm_server import (  # noqa: F401
    DeadlineExceededError, LLMEngine, ServerOverloadedError)
