"""Port parity: the prefix cache and the paged engine that serves with it,
against the JAX reference on the CPU, in f32, with the same weights.

- The radix index alone: the same sequence of ``insert`` / ``match`` /
  ``evict_one`` / ``evict_page`` calls gives the same results, the same LRU
  order and the same keys in both ``PrefixCache``s; ``prefix_key`` digests
  are byte-equal on random prompts, with and without ``blocks=``.
- The engine, prefix cache on (its default on the paged layout): greedy
  tokens equal the reference engine's, and the ``prefix_cache`` stats
  (hit and prompt tokens, copy-on-write forks, evictions) equal its, in
  the scenarios of the reference's own suite (tests/test_llm_server.py):
  on/off parity with partial-tail hits and forks on plain and int8 pools,
  a hit that skips chunks, eviction then re-prefill, pages shared
  mid-flight, a shared-prefix batch that only fits with sharing, an
  impossible total need shed, cache-aware admission.  After every tick of
  the port's engine each page's refcount equals its holders (slot tables
  plus the cache).  The reference's Pallas kernels run in interpret mode.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine, ServerOverloadedError
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

DIMS = dict(num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256)
PAGED = dict(max_batch_slots=2, max_seq_len=128, kv_layout="paged", page_size=32,
             prefill_chunk=16)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**DIMS))
    jm.eval()
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(**DIMS), device="cpu"), ref)
    return jm, tm.eval()


def _oracle(jm, prompt, n):
    ids = paddle.to_tensor(np.asarray(prompt, np.int32)[None, :])
    return list(np.asarray(jm.generate(ids, max_new_tokens=n)._value)[0])


def assert_pool_balanced(eng):
    """Every page is free with refcount 0, or held, with a refcount equal to
    its slot holds plus one if a cache node holds it."""
    free = list(eng._free_pages)
    assert len(free) == len(set(free)), "a page twice in the free list"
    holds = {}
    for pages in eng._slot_pages:
        for p in pages:
            holds[p] = holds.get(p, 0) + 1
    cached = set(eng._prefix.pages()) if eng._prefix is not None else set()
    if eng._prefix is not None:
        assert len(cached) == len(eng._prefix.pages()), "two nodes hold one page"
    assert {p for p in range(eng.num_pages) if eng._page_cached[p]} == cached
    assert 0 not in free and int(eng._page_ref[0]) == 0  # the trash page
    for p in range(1, eng.num_pages):
        ref = int(eng._page_ref[p])
        assert ref == holds.get(p, 0) + (p in cached), f"page {p}: refcount {ref}"
        assert (p in free) == (ref == 0), f"page {p}: free list"


def _pump(eng, futs, check=True, limit=400):
    """Tick until every future is done, holding the pool's balance after
    each tick; returns the most slots active at once."""
    peak = 0
    for _ in range(limit):
        if all(f.done() for f in futs) and eng._prefilling is None:
            break
        eng.step()
        peak = max(peak, sum(r is not None for r in eng.slot_req))
        if check:
            assert_pool_balanced(eng)
    assert all(f.done() for f in futs), "the engine did not drain"
    return peak


def _shared(rng, shared_len, tails):
    head = rng.randint(0, 1024, shared_len).astype(np.int32)
    return [np.concatenate([head, rng.randint(0, 1024, t).astype(np.int32)]) for t in tails]


# ------------------------------------------------------------ the index


def _index_script(seed):
    """A random sequence of index operations over prompts that share
    heads and diverge inside tails, at page size 4."""
    rng = np.random.RandomState(seed)
    heads = [rng.randint(0, 50, rng.randint(3, 14)).astype(np.int32) for _ in range(4)]
    ops, page = [], 1
    for _ in range(60):
        h = heads[rng.randint(len(heads))]
        p = np.concatenate([h, rng.randint(0, 50, rng.randint(0, 7)).astype(np.int32)])
        kind = rng.choice(["insert", "match", "match", "evict_one", "evict_page"])
        if kind == "insert":
            n = -(-p.size // 4)
            ops.append(("insert", p, list(range(page, page + n))))
            page += n
        elif kind == "match":
            ops.append(("match", p, None))
        elif kind == "evict_one":
            ops.append(("evict_one", None, int(rng.randint(0, 3))))
        else:
            ops.append(("evict_page", None, int(rng.randint(1, page + 1))))
    return ops


def _run_index(mod, ops):
    pc = mod.PrefixCache(page_size=4)
    out = []
    for kind, p, arg in ops:
        if kind == "insert":
            out.append(pc.insert(p, arg))
        elif kind == "match":
            out.append(pc.match(p))
        elif kind == "evict_one":
            ev = pc.evict_one(lambda page: page % 3 != arg)
            out.append(None if ev is None else (ev[0], ev[2], ev[3],
                                                None if ev[1] is None else ev[1].tolist()))
        else:
            ev = pc.evict_page(arg)
            out.append(None if ev is None else (ev[0], ev[2], ev[3]))
        out.append(pc.freeable_count(lambda page: page % 2 == 0))
    lru = [(k, par, pg, n, None if t is None else t.tolist())
           for k, par, pg, n, t in pc.lru_entries()]
    return out, lru, sorted(pc.pages()), len(pc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_operations_match_reference(seed):
    ops = _index_script(seed)
    want = _run_index(jpc, ops)
    got = _run_index(tpc, ops)
    assert got == want
    assert len(got[1]) > 0  # the script left nodes to order


def test_index_node_info_and_readmit_match_reference():
    p = np.arange(11, dtype=np.int32)
    idx = {}
    for mod in (jpc, tpc):
        pc = mod.PrefixCache(page_size=4)
        pc.insert(p, [5, 6, 7])
        entries = pc.lru_entries()
        key, parent, page, ntok, tokens = entries[-1]  # the partial tail
        info = pc.node_info(key)
        ev = pc.evict_page(page)
        again = pc.readmit(key, parent, 9, ntok, tokens)
        twice = pc.readmit(key, parent, 9, ntok, tokens)
        idx[mod] = (info, ev[0], again, twice, pc.match(p), pc.node_info(key))
    assert idx[tpc] == idx[jpc]
    assert idx[tpc][4] == (10, [5, 6, 9])


@pytest.mark.parametrize("blocks", [None, 0, 1, 3])
def test_prefix_key_digests_byte_equal(blocks):
    rng = np.random.RandomState(3)
    for n in (1, 2, 7, 32, 33, 100, 257):
        prompt = rng.randint(0, 50000, n).astype(np.int32)
        for ps in (4, 16, 128):
            want = jpc.prefix_key(prompt, ps, blocks=blocks)
            assert tpc.prefix_key(prompt, ps, blocks=blocks) == want
            assert tpc.prefix_key(prompt.tolist(), ps, blocks=blocks,
                                  adapter_id="a") == jpc.prefix_key(prompt, ps, blocks=blocks,
                                                                    adapter_id="a")
    parent = tpc.chained_block_key(b"", prompt[:4].tobytes())
    assert parent == jpc.chained_block_key(b"", prompt[:4].tobytes())
    assert tpc.chained_block_key(parent, prompt[4:7].tobytes(), partial=True) == \
        jpc.chained_block_key(parent, prompt[4:7].tobytes(), partial=True)


# ---------------------------------------------------------------- engine


def _serve_both(pair, prompts, max_new, **kw):
    """The same requests through both engines; the port's pool is held in
    balance after every tick.  Returns (tokens, the port engine, the
    reference engine's stats)."""
    jm, tm = pair
    jeng = JEngine(jm, **{**PAGED, **kw})
    jfuts = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run_until_complete()
    eng = LLMEngine(tm, **{**PAGED, **kw})
    futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    _pump(eng, futs)
    got = [f.result() for f in futs]
    assert got == [f.result() for f in jfuts]
    return got, eng, jeng.stats()


def _same_prefix_stats(eng, jstats):
    got, want = eng.stats()["prefix_cache"], jstats["prefix_cache"]
    for k in ("hit_tokens", "prompt_tokens", "cow_copies", "evictions", "cached_pages",
              "nodes", "shared_pages"):
        assert got[k] == want[k], (k, got[k], want[k])
    return got


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_cache_on_off_parity_with_forks(pair, cache_dtype):
    """A shared prefix off the page grid (44 tokens: a partial tail), with
    tails that diverge inside the tail page: hits, partial-tail matches and
    copy-on-write forks all happen, and the tokens equal the reference's
    and the cache-off run's."""
    rng = np.random.RandomState(50)
    prompts = _shared(rng, 44, (4, 6, 3, 5))
    got, eng, jst = _serve_both(pair, prompts, 6, cache_dtype=cache_dtype)
    st = _same_prefix_stats(eng, jst)
    assert st["hit_tokens"] > 0 and st["cow_copies"] > 0
    assert eng.stats()["kv_pages_in_use"] == 0
    off, eng_off, _ = _serve_both(pair, prompts, 6, cache_dtype=cache_dtype,
                                  prefix_cache=False)
    assert off == got and eng_off.stats()["prefix_cache"] is None


def test_hit_skips_prefill_chunks(pair):
    """A prompt served twice prefills in one chunk the second time: 39 of
    its 40 tokens are cached (the last is recomputed for its logits)."""
    jm, tm = pair
    p = np.random.RandomState(53).randint(0, 1024, 40).astype(np.int32)
    kw = dict(PAGED, max_batch_slots=1, prefill_chunk=8)
    eng, jeng = LLMEngine(tm, **kw), JEngine(jm, **kw)
    first = eng.generate(p, max_new_tokens=4)
    assert eng.stats()["prefill_chunks"] == 5
    again = eng.generate(p, max_new_tokens=4)
    assert eng.stats()["prefill_chunks"] == 6
    assert first == again == jeng.generate(p, max_new_tokens=4) == jeng.generate(
        p, max_new_tokens=4) == _oracle(jm, p, 4)
    st = _same_prefix_stats(eng, jeng.stats())
    assert st["hit_tokens"] == 39 and st["prompt_tokens"] == 80
    assert_pool_balanced(eng)


def test_sharing_fits_a_batch_the_pool_cannot_hold_privately(pair):
    """Four requests on a 96-token page-aligned shared prefix run at once in
    8 allocatable pages with the cache; without it at most two fit."""
    jm, tm = pair
    prompts = _shared(np.random.RandomState(54), 96, (7, 7, 7, 7))
    peak = {}
    for on in (True, False):
        kw = dict(PAGED, max_batch_slots=4, prefill_chunk=32, num_pages=9, prefix_cache=on)
        eng = LLMEngine(tm, **kw)
        futs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        peak[on] = _pump(eng, futs)
        assert [f.result() for f in futs] == [_oracle(jm, p, 12) for p in prompts]
        if on:
            jeng = JEngine(jm, **kw)
            for p in prompts:
                jeng.submit(p, max_new_tokens=12)
            jeng.run_until_complete()
            st = _same_prefix_stats(eng, jeng.stats())
            assert st["shared_pages"] == 0 and st["hit_ratio"] > 0.65
    assert peak[True] == 4 and peak[False] <= 2


def test_eviction_then_reprefill(pair):
    """Three allocatable pages: the second prompt's admission evicts the
    first's cached pages; the first, served again, prefills anew."""
    jm, tm = pair
    rng = np.random.RandomState(55)
    pa, pb = (rng.randint(0, 1024, 40).astype(np.int32) for _ in range(2))
    kw = dict(PAGED, max_batch_slots=1, prefill_chunk=32, num_pages=4)
    eng, jeng = LLMEngine(tm, **kw), JEngine(jm, **kw)
    for p in (pa, pb, pa):
        assert eng.generate(p, max_new_tokens=4) == jeng.generate(p, max_new_tokens=4) \
            == _oracle(jm, p, 4)
        assert_pool_balanced(eng)
    st = _same_prefix_stats(eng, jeng.stats())
    assert st["evictions"] > 0 and eng.stats()["kv_pages_in_use"] == 0


def test_shared_pages_visible_midflight(pair):
    jm, tm = pair
    prompts = _shared(np.random.RandomState(56), 64, (5, 9))
    eng = LLMEngine(tm, **dict(PAGED, prefill_chunk=32))
    futs = [eng.submit(p, max_new_tokens=20) for p in prompts]
    for _ in range(6):
        eng.step()
        assert_pool_balanced(eng)
    st = eng.stats()["prefix_cache"]
    assert sum(r is not None for r in eng.slot_req) == 2
    assert st["shared_pages"] >= 2 and st["cached_pages"] >= 2
    _pump(eng, futs)
    assert [f.result() for f in futs] == [_oracle(jm, p, 20) for p in prompts]


def test_prefix_cache_rejected_on_dense_layout(pair):
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(pair[1], max_batch_slots=2, max_seq_len=128, prefix_cache=True)
    with pytest.raises(ValueError, match="cache_aware_admission"):
        LLMEngine(pair[1], max_batch_slots=2, max_seq_len=128, cache_aware_admission=True)
    with pytest.raises(ValueError, match="cache_aware_admission"):
        LLMEngine(pair[1], **PAGED, prefix_cache=False, cache_aware_admission=True)


def test_impossible_total_need_is_shed(pair):
    """A prompt that extends a cached prefix past the pool: its unique need
    fits, its total does not, so it is shed rather than left waiting."""
    jm, tm = pair
    rng = np.random.RandomState(53)
    kw = dict(PAGED, max_batch_slots=1, prefill_chunk=32, num_pages=4)
    eng, jeng = LLMEngine(tm, **kw), JEngine(jm, **kw)
    head = rng.randint(0, 1024, 40).astype(np.int32)
    assert eng.generate(head, max_new_tokens=4) == jeng.generate(head, max_new_tokens=4)
    assert eng.stats()["prefix_cache"]["cached_pages"] >= 1
    big = np.concatenate([head, rng.randint(0, 1024, 60).astype(np.int32)])
    for e in (eng, jeng):
        fut = e.submit(big, max_new_tokens=30)
        e.run_until_complete()
        with pytest.raises(Exception, match="kv pages"):
            fut.result(timeout=1)
    with pytest.raises(ServerOverloadedError):
        fut = eng.submit(big, max_new_tokens=30)
        eng.run_until_complete()
        fut.result()
    assert eng.stats()["kv_pages_in_use"] == 0 and eng.stats()["shed"] == 2
    assert_pool_balanced(eng)


def test_cache_aware_admission_reorders_as_reference(pair):
    """One slot busy, a cold request at the queue head and a cache-warm one
    behind it: the warm one admits first (one reorder), as in the
    reference, and every result equals the oracle's."""
    jm, tm = pair
    rng = np.random.RandomState(27)
    head = rng.randint(0, 1024, 32).astype(np.int32)
    warm0 = np.concatenate([head, rng.randint(0, 1024, 6).astype(np.int32)])
    cold = rng.randint(0, 1024, 28).astype(np.int32)
    warm1 = np.concatenate([head, rng.randint(0, 1024, 4).astype(np.int32)])
    blocker = rng.randint(0, 1024, 12).astype(np.int32)
    kw = dict(PAGED, max_batch_slots=1, prefill_chunk=32, cache_aware_admission=True)
    results, orders = {}, {}
    for name, cls, m in (("ref", JEngine, jm), ("port", LLMEngine, tm)):
        eng = cls(m, **kw)
        f0 = eng.submit(warm0, max_new_tokens=2)
        eng.run_until_complete()
        fbl = eng.submit(blocker, max_new_tokens=4)
        eng.step()
        fc = eng.submit(cold, max_new_tokens=3)
        fw = eng.submit(warm1, max_new_tokens=3)
        admitted = []  # prompt lengths in order of admission: cold 28, warm 36
        while not all(f.done() for f in (fbl, fc, fw)):
            eng.step()
            req = eng.slot_req[0]
            if req is not None and (not admitted or admitted[-1][0] is not req):
                admitted.append((req, req.prompt.size))
        results[name] = [f.result() for f in (f0, fbl, fc, fw)]
        orders[name] = [n for _, n in admitted]
        assert eng.stats()["admission_reorders"] == 1
        if name == "port":
            assert_pool_balanced(eng)
    assert results["port"] == results["ref"]
    assert results["port"] == [_oracle(jm, p, n) for p, n in
                               ((warm0, 2), (blocker, 4), (cold, 3), (warm1, 3))]
    assert orders["port"] == orders["ref"] == [12, 36, 28]  # warm before cold


def test_pool_balanced_under_finish_expiry_preempt(pair):
    """Finish, deadline expiry and pool pressure interleaved over a pool too
    small for everyone (the reference suite's conservation scenario): the
    balance holds after every tick and the pool drains to the cached pages
    alone; the survivors' tokens equal the oracle's."""
    jm, tm = pair
    rng = np.random.RandomState(40)
    t = [0.0]
    eng = LLMEngine(tm, max_batch_slots=3, max_seq_len=128, kv_layout="paged",
                    page_size=32, prefill_chunk=16, num_pages=6, clock=lambda: t[0])
    shared = rng.randint(0, 1024, 34).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 1024, 3).astype(np.int32)]),
               rng.randint(0, 1024, 20).astype(np.int32),
               np.concatenate([shared, rng.randint(0, 1024, 5).astype(np.int32)])]
    futs = [eng.submit(prompts[0], max_new_tokens=20),
            eng.submit(prompts[1], max_new_tokens=30, timeout=5.0),
            eng.submit(prompts[2], max_new_tokens=3)]
    for i in range(200):
        if all(f.done() for f in futs) and eng._prefilling is None:
            break
        eng.step()
        assert_pool_balanced(eng)
        if i == 8:
            t[0] = 10.0  # the deadline fires mid-decode
    assert all(f.done() for f in futs)
    with pytest.raises(Exception, match="deadline"):
        futs[1].result()
    assert futs[0].result() == _oracle(jm, prompts[0], 20)
    assert futs[2].result() == _oracle(jm, prompts[2], 3)
    st = eng.stats()
    assert st["kv_pages_in_use"] == 0
    assert int(eng._page_ref.sum()) == st["prefix_cache"]["cached_pages"]


def test_cow_copies_every_pool_of_a_page():
    """cow_copy_pages copies one page's rows in every layer's pools, the
    int8 scale pools included, and leaves the source and other pages."""
    import torch

    from paddle_tpu_torch.models.kv_cache import cow_copy_pages

    g = torch.Generator().manual_seed(0)
    caches = [(torch.randn(5, 2, 4, 8, generator=g).to(torch.int8),
               torch.randn(5, 2, 4, 8, generator=g).to(torch.int8),
               torch.rand(5, 2, 4, generator=g), torch.rand(5, 2, 4, generator=g))
              for _ in range(2)]
    before = [tuple(x.clone() for x in c) for c in caches]
    out = cow_copy_pages(caches, 3, 1)
    assert out is caches
    for c, b in zip(caches, before):
        for x, y in zip(c, b):
            assert torch.equal(x[1], y[3]) and torch.equal(x[3], y[3])
            assert torch.equal(x[[0, 2, 4]], y[[0, 2, 4]])


def test_steal_back_when_every_cached_page_is_pinned(pair):
    """Three allocatable pages: A (40 tokens: a full page and an 8-token
    tail) forks its cached tail page into the last free page as it decodes;
    B, the same prompt, maps both cached pages, and its prefill must write
    into the tail page only it and the cache hold, with no page free and
    every cached page pinned: it takes the page back (an eviction, not a
    copy), and again at its first decode write after its insert cached it
    anew.  Tokens, forks and evictions equal the reference engine's."""
    jm, tm = pair
    p = np.random.RandomState(57).randint(0, 1024, 40).astype(np.int32)
    kw = dict(PAGED, prefill_chunk=32, num_pages=4)
    out = {}
    for name, cls, m in (("ref", JEngine, jm), ("port", LLMEngine, tm)):
        eng = cls(m, **kw)
        fa = eng.submit(p, max_new_tokens=10)
        while eng.stats()["prefix_cache"]["cow_copies"] == 0:
            eng.step()
        fb = eng.submit(p, max_new_tokens=6)
        while not (fa.done() and fb.done()):
            eng.step()
            if name == "port":
                assert_pool_balanced(eng)
        out[name] = fa.result(), fb.result(), eng.stats()["prefix_cache"]
    assert out["port"][:2] == out["ref"][:2] == (_oracle(jm, p, 10), _oracle(jm, p, 6))
    got, want = out["port"][2], out["ref"][2]
    assert (got["cow_copies"], got["evictions"]) == (want["cow_copies"], want["evictions"])
    assert got["cow_copies"] == 1 and got["evictions"] == 2
