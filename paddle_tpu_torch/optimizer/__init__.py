"""paddle.optimizer parity surface: SGD, Momentum, Adam and AdamW.

The reference's other optimizers (Adagrad, Adadelta, Adamax, RMSProp, Lamb,
Lars) and its ``lr`` schedulers are not ported yet: asking for one raises
NotImplementedError naming ROADMAP.md Queue 1 item 6.
"""
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401

_NOT_PORTED = ("Adagrad", "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars", "lr")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.optimizer.{name} is not ported yet (ROADMAP.md Queue 1 "
            "item 6: the rest of the surface); SGD, Momentum, Adam and AdamW are")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
