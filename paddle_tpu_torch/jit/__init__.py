"""paddle.jit parity surface: the training step (``TrainStep``) and the
programs layer (``graphs``: one captured CUDA graph per shape key, the
counterpart of ``jax.jit``; ``disable_graphs()`` of ``jax.disable_jit()``)."""
from .graphs import Program, Programs, check_syncs, disable_graphs  # noqa: F401
from .train_step import TrainStep  # noqa: F401
