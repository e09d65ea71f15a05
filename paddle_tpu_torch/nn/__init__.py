from torch.nn import Sequential  # noqa: F401

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss, Dropout,  # noqa: F401
                    Embedding, LayerNorm, Linear, MaxPool2D, ReLU, RMSNorm)
