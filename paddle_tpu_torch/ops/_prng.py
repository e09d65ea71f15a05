"""Dropout bits (counterpart of paddle_tpu/ops/_prng.py).

The reference's dropout kernels (fused LN, encoder attention) seed the
TPU's hardware generator per grid block and regenerate the same mask in the
backward from the same seed.  The port's kernels draw from one Philox4x32-10
written by hand (``csrc/philox.cuh``); this module is its torch twin, which
the plain versions use on the CPU and which the chip test holds the kernels
against on the card.  The two must give the same bits for the same seed and
element, so the mapping from an element to its (counter, word) is written
down once here and once in ``philox.cuh``:

* the key is the call's seed pair, an int32 [2] tensor (``draw_seed``);
* fused LN, element (row, col) of the [n, h] matrix: counter (col >> 2,
  row, 0, 0), word col & 3;
* encoder attention, element (bh, i, j) of the [B * H, S, S]
  probabilities: counter (oct(i), oct(j), bh, 0), oct(x) = (x >> 4) * 8 +
  (x & 7), word 2 * ((i >> 3) & 1) + ((j >> 3) & 1).

Keep iff the element's word < ``thresh_u32(rate)``, as in the reference.
The reference's bits are the TPU's and do not match these
(paddle_tpu/ops/_prng.py:38-41): masks agree between forward and backward
and between kernel and plain version, never across platforms.
"""
from __future__ import annotations

import torch

from ..framework.random import get_generator

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF

__all__ = ["thresh_u32", "draw_seed", "philox4x32", "fused_ln_bits",
           "encoder_bits", "keep_mask", "launch_args"]


def thresh_u32(rate):
    """uint32 keep-threshold: P(bits < thresh) = 1 - rate (the reference's)."""
    return min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)


def draw_seed(device=None):
    """A fresh int32 [2] seed pair from ``device``'s seeded generator
    (framework/random.py), made on that device: no host sync.  The kernels
    read it by pointer; an autograd Function saves it for its backward."""
    dev = torch.device(device) if device is not None else None
    gen = get_generator(dev)
    return torch.randint(0, 2**32, (2,), generator=gen, device=gen.device,
                         dtype=torch.int64).to(torch.int32)


def launch_args(seed, rate, scale, device):
    """(seed pointer, keep threshold, scale) for a dropout kernel's launch:
    a null pointer at rate 0, where no mask is drawn; else the pointer of
    ``seed``, an int32 [2] contiguous tensor on ``device``, which the
    caller keeps alive until the launch."""
    if rate <= 0.0:
        return 0, 0xFFFFFFFF, 1.0
    if not (seed is not None and seed.device == device and seed.dtype == torch.int32
            and seed.numel() == 2 and seed.is_contiguous()):
        raise ValueError("a dropout kernel at rate > 0 needs an int32 [2] contiguous seed on "
                         f"{device}, got {None if seed is None else (seed.dtype, seed.shape)}")
    return seed.data_ptr(), thresh_u32(rate), scale


def _mulhilo(a, b):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit values.  a * b can reach 2^64, past int64,
    so b is split into 16-bit halves and every partial stays below 2^49."""
    t1 = a * (b & 0xFFFF)
    t2 = a * (b >> 16)
    low = ((t2 & 0xFFFF) << 16) + t1
    return (t2 >> 16) + (low >> 32), low & _U32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) of 32-bit values, broadcast
    together: the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def _key(seed):
    s = seed.to(torch.int64) & _U32
    return s[0], s[1]


def fused_ln_bits(seed, n, h):
    """The words of the [n, h] fused-LN matrix (int64 [n, h], 32-bit values)."""
    dev = seed.device
    k0, k1 = _key(seed)
    grp = torch.arange(h // 4, device=dev, dtype=torch.int64)[None, :]
    row = torch.arange(n, device=dev, dtype=torch.int64)[:, None]
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    words = philox4x32(grp, row, zero, zero, k0, k1)
    return torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(n, h)


def _oct(x):
    return (x >> 4) * 8 + (x & 7)


def encoder_bits(seed, bh, s):
    """The words of the [bh, s, s] encoder probabilities (int64, 32-bit
    values); s a multiple of 16."""
    dev = seed.device
    k0, k1 = _key(seed)
    half = torch.arange(s // 2, device=dev, dtype=torch.int64)
    heads = torch.arange(bh, device=dev, dtype=torch.int64)[:, None, None]
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    words = philox4x32(half[None, :, None], half[None, None, :], heads, zero, k0, k1)
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)  # [bh, s/2, s/2, 4]
    x = torch.arange(s, device=dev, dtype=torch.int64)
    hi = (x >> 3) & 1
    return words[:, _oct(x)[:, None], _oct(x)[None, :], 2 * hi[:, None] + hi[None, :]]


def keep_mask(bits, rate):
    """Bernoulli(1 - rate) keep mask from the words."""
    return bits < thresh_u32(rate)
