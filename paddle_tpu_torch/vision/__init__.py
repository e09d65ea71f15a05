"""Vision (counterpart of paddle_tpu/vision): the ResNet family so far.

Not ported yet (ROADMAP.md Queue 1 item 4, vision): LeNet, ViT and the
other model families, ``vision/ops.py``, ``transforms``, ``datasets`` and
``ocr.py``.
"""
from . import models  # noqa: F401
