from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401
