from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
