from .random import get_generator, seed  # noqa: F401
