"""The port's dropout bits (paddle_tpu_torch/ops/_prng.py), the torch twin of
csrc/philox.cuh, on the CPU.

- Philox4x32-10 gives Random123's published known answers, exactly.
- ``thresh_u32`` equals the reference's for several rates, exactly.
- A mask's keep fraction lies within 5 binomial standard deviations of
  1 - rate, and fresh seeds give fresh masks.
- Each element's bits depend on (seed, coordinates) alone: a slice of the
  matrix computed on its own, or the elements gathered in another order,
  give the same words, exactly.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.ops import _prng as jprng
from paddle_tpu_torch.ops import _prng

KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
SIGMAS = 5.0


def _t(x):
    return torch.tensor(x, dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    got = _prng.philox4x32(*map(_t, ctr), *map(_t, key))
    assert [int(w) for w in got] == list(want)


def test_philox_matches_python_integers():
    """The 16-bit split of the multiplies against Python's exact integers,
    on random counters and keys."""
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 2**32, (64, 6), dtype=np.uint64).astype(np.int64)
    got = torch.stack(_prng.philox4x32(*torch.from_numpy(rows).unbind(1)), 1)
    for row, words in zip(rows.tolist(), got.tolist()):
        c, k = list(row[:4]), list(row[4:])
        for _ in range(10):
            p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1],
                 p0 & 0xFFFFFFFF]
            k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
        assert words == c


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.25, 0.5, 0.9, 1.0 - 2**-33])
def test_thresh_u32_matches_reference(rate):
    assert _prng.thresh_u32(rate) == int(jprng.thresh_u32(rate))


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("kind", ["fused_ln", "encoder"])
def test_keep_fraction_and_fresh_seeds(kind, rate):
    s1 = torch.tensor([12345, -678], dtype=torch.int32)
    s2 = torch.tensor([12345, -677], dtype=torch.int32)
    if kind == "fused_ln":
        bits = [_prng.fused_ln_bits(s, 256, 512) for s in (s1, s2)]
    else:
        bits = [_prng.encoder_bits(s, 8, 128) for s in (s1, s2)]
    keep = [_prng.keep_mask(b, rate) for b in bits]
    n = keep[0].numel()
    for k in keep:
        frac = k.float().mean().item()
        assert abs(frac - (1 - rate)) <= SIGMAS * math.sqrt(rate * (1 - rate) / n)
    agree = (keep[0] == keep[1]).float().mean().item()  # independent masks
    p_agree = rate ** 2 + (1 - rate) ** 2
    assert abs(agree - p_agree) <= SIGMAS * math.sqrt(p_agree * (1 - p_agree) / n)
    assert bits[0].min() >= 0 and bits[0].max() < 2**32


def test_bits_depend_on_coordinates_alone():
    seed = torch.tensor([7, 2024], dtype=torch.int32)
    full = _prng.fused_ln_bits(seed, 64, 256)
    k0, k1 = 7, 2024
    rng = np.random.RandomState(1)
    rows, cols = rng.randint(0, 64, 50), rng.randint(0, 256, 50)
    # each element on its own, from the documented (counter, word) mapping
    words = _prng.philox4x32(_t(cols >> 2), _t(rows), _t(0), _t(0), _t(k0), _t(k1))
    stacked = torch.stack(words, -1)
    got = stacked[torch.arange(50), _t(cols & 3)]
    assert torch.equal(got, full[rows, cols])

    enc = _prng.encoder_bits(seed, 3, 64)
    bh, i, j = rng.randint(0, 3, 80), rng.randint(0, 64, 80), rng.randint(0, 64, 80)
    octs = lambda x: (x >> 4) * 8 + (x & 7)  # noqa: E731
    words = torch.stack(_prng.philox4x32(_t(octs(i)), _t(octs(j)), _t(bh), _t(0), _t(k0),
                                         _t(k1)), -1)
    got = words[torch.arange(80), _t(2 * ((i >> 3) & 1) + ((j >> 3) & 1))]
    assert torch.equal(got, enc[bh, i, j])
    # a bigger matrix holds the smaller one's elements at the same places
    assert torch.equal(_prng.encoder_bits(seed, 5, 128)[:3, :64, :64], enc)
    assert torch.equal(_prng.fused_ln_bits(seed, 80, 512)[:64, :256], full)
    # the transposed walk of the dK/dV kernel reads the same words
    assert torch.equal(enc.transpose(1, 2)[bh, j, i], enc[bh, i, j])


def test_draw_seed_follows_the_global_seed():
    from paddle_tpu_torch import seed

    seed(11)
    a = _prng.draw_seed("cpu")
    b = _prng.draw_seed("cpu")
    seed(11)
    assert torch.equal(_prng.draw_seed("cpu"), a)
    assert a.dtype == torch.int32 and a.shape == (2,) and not torch.equal(a, b)
