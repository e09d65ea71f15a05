"""paddle.jit parity surface: the training step (``TrainStep``)."""
from .train_step import TrainStep  # noqa: F401
