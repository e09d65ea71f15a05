"""Port parity: paddle_tpu_torch's static decode attention and static cache
helpers against the JAX reference on the CPU, in f32.

The port's plain ``decode_attention`` (the version CPU tensors take, and
the oracle of the Hopper kernel in chip_smoke.py) is held against the
reference's Pallas kernel ``_decode_pallas`` in interpret mode and against
its plain version ``_decode_dense``, on the same numpy-seeded inputs.

Tolerances, as the reference's own tests (tests/test_decode_attention.py)
and slice 1's paged tests: 2e-5 in f32 (the same math summed in another
order); 4e-4 against the Pallas kernel with int8 caches, because it rounds
the dequantized keys and the probabilities to bf16 before its products
where the plain versions do not.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.ops import _admit
from paddle_tpu_torch.ops import decode_attention as tda

F32_TOL = 2e-5
INT8_KERNEL_TOL = 4e-4
SCALE = 1 / 128 ** 0.5


def _mk(B=4, H=8, Hkv=4, L=256, D=128, offsets=(0, 37, 200, 255), seed=0,
        poison=True):
    """numpy q [B, 1, H, D] and head-major k/v [B, Hkv, L, D]; rows past
    each slot's valid length (offset + 1) are poisoned, so that any read of
    them blows the output up."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, 1, H, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, Hkv, L, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, Hkv, L, D) * 0.3).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    if poison:
        for b, o in enumerate(off):
            k[b, :, o + 1:] = 1e4
            v[b, :, o + 1:] = 1e4
    return q, k, v, off


def _port(q, k, v, off, ks=None, vs=None):
    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    off_t = off if isinstance(off, int) else t(off)
    return tda.decode_attention(t(q), t(k), t(v), off_t, t(ks), t(vs)).numpy()


def _ref_kernel(q, k, v, off, ks=None, vs=None):
    return np.asarray(jda._decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        ks, vs, scale=SCALE, bk=128, interpret=True))


def _ref_dense(q, k, v, off, ks=None, vs=None):
    return np.asarray(jda._decode_dense(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(off), ks, vs,
                                        SCALE))


CASES = {
    # per-slot offsets: a slot at 0 (one key) and one at L - 1 (all keys)
    "per_slot_rep2": dict(),
    "per_slot_rep4": dict(H=8, Hkv=2),
    "per_slot_rep1": dict(H=4, Hkv=4, offsets=(255, 0, 128, 127)),
    # one scalar offset for every slot (the generate() loop)
    "scalar_rep2": dict(offsets=(130,) * 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_kernel_and_dense(case):
    kw = CASES[case]
    q, k, v, off = _mk(**kw)
    got = _port(q, k, v, int(off[0]) if case.startswith("scalar") else off)
    assert np.isfinite(got).all()
    assert np.abs(got).max() < 10  # a read past the valid length would be ~1e4
    np.testing.assert_allclose(got, _ref_dense(q, k, v, off), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, _ref_kernel(q, k, v, off), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("rep", [1, 2])
def test_plain_int8_cache_with_scales(rep):
    # the Pallas kernel rounds p * v_scale to bf16, a 2^-9 relative step
    # that only averages out over many keys: no slot here sees fewer than 38
    q, k, v, off = _mk(H=4, Hkv=4 // rep, offsets=(37, 100, 200, 255), poison=False)
    kq, ks = jkv._quantize_kv(jnp.asarray(k))
    vq, vs = jkv._quantize_kv(jnp.asarray(v))
    kq, vq = np.asarray(kq), np.asarray(vq)
    got = _port(q, kq, vq, off, ks, vs)
    np.testing.assert_allclose(got, _ref_dense(q, kq, vq, off, ks, vs),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, _ref_kernel(q, kq, vq, off, ks, vs),
                               rtol=INT8_KERNEL_TOL, atol=INT8_KERNEL_TOL)


@pytest.mark.parametrize("offset", [7, np.array([3, 0, 9], np.int32)],
                         ids=["scalar", "per_slot"])
@pytest.mark.parametrize("S", [1, 3])
def test_static_cache_updates_match_reference(offset, S):
    """update_plain_cache and update_quant_cache write the same rows as the
    reference's functional scatter, in place."""
    rng = np.random.RandomState(4)
    B, H, L, D = 3, 2, 16, 128
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    bufs = [rng.randn(B, H, L, D).astype(np.float32) for _ in range(2)]
    scales = [rng.rand(B, H, L).astype(np.float32) for _ in range(2)]
    qbufs = [np.zeros((B, H, L, D), np.int8) for _ in range(2)]
    off_j = jnp.asarray(offset)
    off_t = offset if isinstance(offset, int) else torch.from_numpy(offset)
    jc, _, _ = jkv.update_plain_cache(
        tuple(jnp.asarray(b) for b in bufs) + (off_j,), jnp.asarray(k), jnp.asarray(v), off_j)
    tc = tuple(torch.from_numpy(b.copy()) for b in bufs) + (off_t,)
    new, kb, vb = tkv.update_plain_cache(tc, torch.from_numpy(k), torch.from_numpy(v), off_t)
    assert kb is tc[0] and vb is tc[1]  # in place
    for a, b in zip(jc[:2], new[:2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a._value if hasattr(a, "_value") else a))
    np.testing.assert_array_equal(np.asarray(new[2]), np.asarray(off_j) + S)
    jq = jkv.update_quant_cache(
        (jnp.asarray(qbufs[0]), jnp.asarray(qbufs[1]), off_j, jnp.asarray(scales[0]),
         jnp.asarray(scales[1])), jnp.asarray(k), jnp.asarray(v), off_j, jnp.float32)[0]
    tq = tkv.update_quant_cache(
        (torch.from_numpy(qbufs[0].copy()), torch.from_numpy(qbufs[1].copy()), off_t,
         torch.from_numpy(scales[0].copy()), torch.from_numpy(scales[1].copy())),
        torch.from_numpy(k), torch.from_numpy(v), off_t)[0]
    for i in (0, 1, 3, 4):
        a = np.asarray(jq[i]._value if hasattr(jq[i], "_value") else jq[i])
        np.testing.assert_array_equal(tq[i].numpy(), a)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors only; it never runs the
    plain version, and a refused call does not count as a launch."""
    q, k, v, off = _mk(B=1, offsets=(5,))
    before = tda.decode_attention_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tda.decode_attention_kernel(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
            torch.from_numpy(v).bfloat16(), torch.tensor([6], dtype=torch.int32))
    assert tda.decode_attention_kernel.launches == before


# --------------------------------------------------- head dims 64 and 256

def _mk_dims(D, S, quant, B=3, H=8, Hkv=2, L=256, offsets=(0, 100, 250), seed=5):
    """numpy inputs at head dim D (GQA rep 4), S query positions, the cache
    int8 with the reference's own quantizer when ``quant``."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, H, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, Hkv, L, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, Hkv, L, D) * 0.3).astype(np.float32)
    off = np.minimum(np.asarray(offsets, np.int32), L - S)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = jkv._quantize_kv(jnp.asarray(k)), jkv._quantize_kv(jnp.asarray(v))
        k, v, ks, vs = (np.asarray(a) for a in (k, v, ks, vs))
    return q, k, v, off, ks, vs


@pytest.mark.parametrize("cache", ["plain", "int8"])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("D", [64, 256])
def test_plain_head_dims_match_reference(D, S, cache):
    """The plain version at the head dims the kernels now take besides 128,
    against the reference's own dispatch: its dense path at D = 64 (and at
    S > 1), its Pallas kernel in interpret mode at D = 256, S = 1."""
    quant = cache == "int8"
    # the Pallas kernel rounds p * v_scale to bf16, a 2^-9 relative step
    # that only averages out over many keys: int8 slots see 38 or more
    q, k, v, off, ks, vs = _mk_dims(D, S, quant,
                                    offsets=(37, 100, 250) if quant else (0, 100, 250))
    scale = 1 / D ** 0.5
    got = _port(q, k, v, off, ks, vs)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        scale=scale, interpret=True))
    kernel_path = D % 128 == 0 and S == 1
    tol = INT8_KERNEL_TOL if quant and kernel_path else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_head_dim_admission_names_queue_2_item_9():
    """The kernels take head dims 64, 128 and 256; any other raises and
    names the ROADMAP item that tracks it.  Checked on the shape alone,
    before any device (the wrappers' admission comes before their device
    check)."""
    for regime in ("decode", "paged"):
        for D in tda.KV_HEAD_DIMS:
            assert _admit.admit(regime, torch.bfloat16, torch.bfloat16, D).D == D
        for D in (32, 96):
            with pytest.raises(ValueError, match="Queue 2, item 9"):
                _admit.admit(regime, torch.bfloat16, torch.bfloat16, D)
    q, k = torch.zeros(1, 1, 2, 96), torch.zeros(1, 2, 64, 96)
    with pytest.raises(ValueError, match="Queue 2, item 9"):
        tda.decode_attention_kernel(q, k, k, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("split_keys", [64, 192])
def test_split_merge_model_matches_reference_kernel(split_keys):
    """The plain model of the decode regime's split-K merge over the static
    cache, against the reference's static Pallas kernel in interpret mode:
    splits of 64 and 192 keys, a slot at length 1 (one key; every later
    split has no visible key) and one at the cache's end."""
    q, k, v, off = _mk(offsets=(0, 37, 200, 255), poison=False)
    t = torch.from_numpy
    got = tda._split_merge_dense(t(q), t(k), t(v), t(off), None, None, SCALE,
                                 split_keys).numpy()
    np.testing.assert_allclose(got, _ref_kernel(q, k, v, off), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("cap", [128, 1152, 2048, 2000])
@pytest.mark.parametrize("B,Hkv", [(1, 8), (8, 32), (4, 32), (8, 8)])
def test_split_plan_covers_capacity_in_whole_tiles(B, Hkv, cap):
    """The decode regime's split plan depends on the shape and capacity
    alone (never on lengths): whole 64-key tiles a split, every key of the
    capacity covered, no split empty of capacity, and the grid about twice
    the 132 SMs' two resident blocks wherever the capacity allows."""
    splits, split_keys = tda._split_plan(B, Hkv, cap, 132)
    assert split_keys % tda.KEY_TILE == 0 and split_keys > 0
    assert splits * split_keys >= cap > (splits - 1) * split_keys
    assert splits <= tda.MAX_SPLITS
    tiles = -(-cap // tda.KEY_TILE)
    if splits < tiles:  # the grid reached its target before running out of tiles
        assert B * Hkv * splits >= tda.BLOCKS_PER_SM * 132 * 0.5
