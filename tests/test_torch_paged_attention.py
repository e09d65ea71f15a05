"""Port parity: paddle_tpu_torch's paged attention and paged cache helpers
against the JAX reference on the CPU, in f32.

The port's plain ``paged_decode_attention`` (the version CPU tensors take,
and the oracle of the Hopper kernel) is held against the reference's Pallas
kernel ``_paged_pallas`` run in interpret mode, and against the reference's
own plain version ``_paged_dense``, on the same numpy-seeded inputs.

Tolerances: f32 against ``_paged_dense`` (the same math, summed in another
order) within 2e-5, as the reference's own kernel-vs-dense tests; against
``_paged_pallas`` 2e-5 as well for bf16-free pools.  With int8 pools the
Pallas kernel rounds the probabilities and the dequantized keys to bf16
before its products while the plain versions do not, so that comparison
uses the reference's own int8 tolerance of 4e-4
(tests/test_decode_attention.py).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.ops import decode_attention as tda

F32_TOL = 2e-5
INT8_KERNEL_TOL = 4e-4


def _mk(B=3, S=1, H=8, Hkv=4, D=128, ps=128, M=4, offsets=(37, 300, 410),
        seed=0, poison_trash=True):
    """numpy q [B, S, H, D], pools [P, Hkv, ps, D], shuffled page tables that
    cover each slot's offset + S tokens; unused entries point at the trash
    page 0, poisoned so that any read of it blows the output up."""
    rng = np.random.RandomState(seed)
    P = 1 + B * M
    q = (rng.randn(B, S, H, D) * 0.3).astype(np.float32)
    kp = (rng.randn(P, Hkv, ps, D) * 0.3).astype(np.float32)
    vp = (rng.randn(P, Hkv, ps, D) * 0.3).astype(np.float32)
    free = list(range(1, P))
    rng.shuffle(free)
    pt = np.zeros((B, M), np.int32)
    for b in range(B):
        for j in range(min(M, -(-(int(offsets[b]) + S) // ps))):
            pt[b, j] = free.pop()
    if poison_trash:
        kp[0] = 1e4
        vp[0] = 1e4
    return q, kp, vp, pt, np.asarray(offsets, np.int32)


def _port(q, kp, vp, off, pt, ks=None, vs=None, scale=None):
    def t(a):
        return torch.from_numpy(np.array(a))  # a writable copy

    out = tda.paged_decode_attention(
        t(q), t(kp), t(vp), t(off), t(pt),
        None if ks is None else t(ks), None if vs is None else t(vs), scale)
    return out.numpy()


def _ref_kernel(q, kp, vp, off, pt, ks=None, vs=None, scale=1 / 128 ** 0.5):
    S = q.shape[1]
    return np.asarray(jda._paged_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(off + S), jnp.asarray(pt), ks, vs, scale=scale,
        interpret=True))


def _ref_dense(q, kp, vp, off, pt, ks=None, vs=None, scale=1 / 128 ** 0.5):
    return np.asarray(jda._paged_dense(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(off),
        jnp.asarray(pt), ks, vs, scale))


CASES = {
    # ragged lengths, GQA rep = 2, decode S = 1
    "ragged_rep2": dict(),
    # rep = 1 (LLaMA-2-7B's MHA)
    "rep1": dict(H=4, Hkv=4, offsets=(129, 64, 400)),
    # rep = 4, lengths on page boundaries
    "rep4_page_edges": dict(H=8, Hkv=2, offsets=(127, 255, 0)),
    # an S > 1 prefill chunk at non-zero per-slot offsets
    "chunk_s16": dict(S=16, offsets=(10, 200, 300)),
    # a chunk that starts exactly on a page boundary, rep = 1
    "chunk_s8_rep1": dict(S=8, H=2, Hkv=2, offsets=(128, 5, 250)),
    # a chunk whose (padded) rows run past the table's M pages: keys past
    # M * ps are never visited
    "chunk_past_table": dict(S=16, M=2, offsets=(250, 10, 100)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_kernel_and_dense(case):
    q, kp, vp, pt, off = _mk(**CASES[case])
    got = _port(q, kp, vp, off, pt)
    assert np.isfinite(got).all()
    assert np.abs(got).max() < 10  # a trash-page read would be ~1e4
    np.testing.assert_allclose(got, _ref_dense(q, kp, vp, off, pt),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, _ref_kernel(q, kp, vp, off, pt),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S", [1, 16])
def test_plain_int8_pools_with_scales(S):
    q, kp, vp, pt, off = _mk(S=S, offsets=(37, 200, 300), poison_trash=False)
    kq, ks = jkv._quantize_kv(jnp.asarray(kp))
    vq, vs = jkv._quantize_kv(jnp.asarray(vp))
    kq, vq = np.asarray(kq), np.asarray(vq)
    got = _port(q, kq, vq, off, pt, ks, vs)
    np.testing.assert_allclose(got, _ref_dense(q, kq, vq, off, pt, ks, vs),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, _ref_kernel(q, kq, vq, off, pt, ks, vs),
                               rtol=INT8_KERNEL_TOL, atol=INT8_KERNEL_TOL)


def test_gather_pages_matches_reference():
    _, kp, _, pt, _ = _mk()
    scales = np.random.RandomState(1).rand(*kp.shape[:3]).astype(np.float32)
    for pool in (kp, scales):
        got = tda.gather_pages(torch.from_numpy(pool), torch.from_numpy(pt))
        want = np.asarray(jda.gather_pages(jnp.asarray(pool), jnp.asarray(pt)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_kv_matches_reference():
    x = (np.random.RandomState(2).randn(2, 3, 17, 128) * 0.7).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    q_t, s_t = tkv._quantize_kv(torch.from_numpy(x))
    q_j, s_j = jkv._quantize_kv(jnp.asarray(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-7, atol=0)


def test_token_pages_rows_route_past_coverage_to_trash():
    pt = np.array([[3, 5], [7, 0]], np.int32)  # slot 1 owns one page
    pos = np.array([250, 120], np.int32)       # slot 0 runs past 2 * 128
    page_t, row_t = tkv._token_pages_rows(torch.from_numpy(pos),
                                          torch.from_numpy(pt), 10, 128, 2)
    page_j, row_j = jkv._token_pages_rows(jnp.asarray(pos), jnp.asarray(pt),
                                          10, 128, 2)
    np.testing.assert_array_equal(page_t.numpy(), np.asarray(page_j))
    np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
    assert (page_t.numpy()[0, 6:] == tkv.TRASH_PAGE).all()


@pytest.mark.parametrize("pos", [np.array([250, 120], np.int32), 200])
def test_paged_scatter_matches_reference(pos):
    """In-place scatter (port) == functional scatter (reference), including
    the rows that overflow the table into the trash page."""
    rng = np.random.RandomState(3)
    pt = np.array([[3, 5], [7, 0]], np.int32)
    pool = rng.randn(8, 2, 128, 128).astype(np.float32)
    spool = rng.rand(8, 2, 128).astype(np.float32)
    hm = rng.randn(2, 2, 10, 128).astype(np.float32)
    sc = rng.rand(2, 2, 10).astype(np.float32)
    want = np.asarray(jkv._paged_scatter(jnp.asarray(pool), jnp.asarray(hm),
                                         jnp.asarray(pos), jnp.asarray(pt)))
    want_s = np.asarray(jkv._paged_scatter_scale(
        jnp.asarray(spool), jnp.asarray(sc), jnp.asarray(pos), jnp.asarray(pt)))
    pool_t, spool_t = torch.from_numpy(pool.copy()), torch.from_numpy(spool.copy())
    pos_t = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    out = tkv._paged_scatter(pool_t, torch.from_numpy(hm), pos_t, torch.from_numpy(pt))
    tkv._paged_scatter_scale(spool_t, torch.from_numpy(sc), pos_t, torch.from_numpy(pt))
    assert out is pool_t  # in place
    # the trash page takes colliding garbage writes in either order, so the
    # comparison is exact on every live page
    np.testing.assert_array_equal(pool_t.numpy()[1:], want[1:])
    np.testing.assert_array_equal(spool_t.numpy()[1:], want_s[1:])


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors only; it never runs the
    plain version, and a refused call does not count as a launch."""
    q, kp, vp, pt, off = _mk(B=1, offsets=(5,), M=1)
    before = tda.paged_attention_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tda.paged_attention_kernel(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), torch.tensor([6], dtype=torch.int32),
            torch.from_numpy(pt))
    assert tda.paged_attention_kernel.launches == before


# --------------------------------------------------- head dims 64 and 256

@pytest.mark.parametrize("cache", ["plain", "int8"])
@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("D", [64, 256])
def test_plain_head_dims_match_reference(D, S, cache):
    """The plain version at the head dims the kernels now take besides 128
    (GQA rep 4), against the reference's own dispatch: its dense gather at
    D = 64, its ragged Pallas kernel in interpret mode at D = 256."""
    quant = cache == "int8"
    q, kp, vp, pt, off = _mk(S=S, D=D, H=8, Hkv=2, offsets=(37, 300, 410),
                             poison_trash=not quant)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = jkv._quantize_kv(jnp.asarray(kp)), jkv._quantize_kv(jnp.asarray(vp))
        kp, vp = np.asarray(kp), np.asarray(vp)
    scale = 1 / D ** 0.5
    got = _port(q, kp, vp, off, pt, ks, vs, scale)
    assert np.abs(got).max() < 10  # a trash-page read would be ~1e4
    want = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(off), jnp.asarray(pt),
        ks, vs, scale=scale, interpret=True))
    tol = INT8_KERNEL_TOL if quant and D % 128 == 0 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


SPLIT_CASES = {
    # splits of 64 and 192 keys cut inside the 128-key pages; slot 2 has
    # lengths 0 (offset -1) and emits zeros; slot 0 (38 keys) has no
    # visible key in any split past the first
    "split64": dict(split_keys=64),
    "split192": dict(split_keys=192),
    "split192_gqa_rep4": dict(split_keys=192, H=8, Hkv=2),
    "split64_int8": dict(split_keys=64, quant=True),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_merge_model_matches_reference_kernel(case):
    """The plain model of the decode regime's split-K merge (per-split
    (m, l, acc), merged in split order) on the gathered pages, against the
    reference's paged Pallas kernel in interpret mode: the merge rule the
    kernel follows, checked without a card."""
    kw = dict(SPLIT_CASES[case])
    split_keys, quant = kw.pop("split_keys"), kw.pop("quant", False)
    q, kp, vp, pt, off = _mk(B=4, offsets=(37, 300, -1, 511), poison_trash=False, **kw)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = jkv._quantize_kv(jnp.asarray(kp)), jkv._quantize_kv(jnp.asarray(vp))
        kp, vp = np.asarray(kp), np.asarray(vp)
    t = torch.from_numpy
    tpt = t(pt)
    got = tda._split_merge_dense(
        t(q), tda.gather_pages(t(kp), tpt), tda.gather_pages(t(vp), tpt), t(off),
        None if ks is None else tda.gather_pages(t(np.asarray(ks)), tpt),
        None if vs is None else tda.gather_pages(t(np.asarray(vs)), tpt),
        1 / 128 ** 0.5, split_keys).numpy()
    assert np.isfinite(got).all() and (got[2] == 0).all()
    tol = INT8_KERNEL_TOL if quant else F32_TOL
    np.testing.assert_allclose(got, _ref_kernel(q, kp, vp, off, pt, ks, vs), rtol=tol, atol=tol)
