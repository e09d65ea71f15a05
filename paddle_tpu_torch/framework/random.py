"""Seeded random state (counterpart of paddle_tpu/framework/random.py).

The reference keeps one stateful JAX key that is split on every draw.  The
port keeps one explicit ``torch.Generator`` per device instead: ``seed(s)``
reseeds them all, and ``get_generator(device)`` hands out the generator that
a sampler on that device draws from.  The two frameworks produce different
numbers from the same seed; tests make their inputs with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

_seed = int(np.random.randint(0, 2**31 - 1))
_generators: dict[str, torch.Generator] = {}


def _key(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.current_device() if dev.index is None else dev.index}"
    return "cpu"


def seed(s: int):
    """paddle.seed parity: reseed every per-device generator (made lazily)."""
    global _seed
    _seed = int(s)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return _seed


def get_generator(device=None) -> torch.Generator:
    """The seeded generator of ``device`` (default cuda, see resolve_device)."""
    dev = resolve_device(device)
    key = _key(dev)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen
