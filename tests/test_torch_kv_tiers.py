"""Port parity: the hierarchical kv tiers (inference/kv_host_cache.py, the
engine's demote / promote and models/kv_cache.py's batched gather and
scatter), against the JAX reference on the CPU, in f32, with the same
weights through the converter.

- The host pool alone, in the reference suite's scenarios
  (tests/test_kv_tiers.py): put / get / LRU and idempotence, partial tails
  across tiers, the disk spill's bit-exact round trip (bf16 as its raw
  words, int8 and f32), corrupt spills quarantined, torn spills invisible;
  a spill the reference wrote reads back in the port and the other way
  round.
- ``gather_pages_to_host`` / ``upload_host_pages`` against the reference's
  on the same pools (int8 layout with its scale pools).
- The engine: greedy tokens with the tiers on equal the tiers-off engine's
  and the reference engine's through a forced demote -> evict -> promote
  -> copy-on-write cycle (LLaMA, host tier; GPT int8 through the disk
  tier); promotion restarts prefill at the first uncached token; demotion
  never runs on the tick and its worker starts and stops with the pump;
  the tiers' errors; conservation across HBM, host and disk after every
  tick under churn; torn and corrupt spills and a promotion that dies fall
  back to re-prefill with the same tokens.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.inference import kv_host_cache as jkv
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import kv_cache as jkc
from paddle_tpu.testing.faults import FaultyFS, flip_bit
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import llm_server
from paddle_tpu_torch.inference.kv_host_cache import HostKVPool
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import kv_cache as tkc

ENGINE = dict(max_batch_slots=2, max_seq_len=128, kv_layout="paged", page_size=32,
              prefill_chunk=16)


def _weights(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def llama():
    paddle.seed(7)
    dims = dict(use_flash_attention=False, max_position_embeddings=256)
    jm = JLlama(JConfig.tiny(tensor_parallel=False, **dims))
    jm.eval()
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(**dims), device="cpu"),
                              _weights(jm))
    return jm, tm.eval()


def _blocks(seed, dtype=torch.float32):
    """Two layers of (k, v) host blocks, shaped like one gathered page."""
    g = torch.Generator().manual_seed(seed)
    return [tuple(torch.rand(2, 4, 3, generator=g).to(dtype) for _ in range(2))
            for _ in range(2)]


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for la, lb in zip(a, b) for x, y in zip(la, lb))


def _solo(tm, prompt, n):
    return tm.generate(torch.from_numpy(np.asarray(prompt, np.int64)[None]),
                       max_new_tokens=n)[0].tolist()


def _mk(rng, shared, vocab=1024):
    return lambda t: np.concatenate([shared, rng.randint(0, vocab, t).astype(np.int32)])


def _drain_to_tiers(eng):
    """Stage every cached page on the host, then evict the HBM copies: the
    next shared-prefix request can only hit by promotion."""
    while eng.demote_step(force=True):
        pass
    n = int(eng._page_cached.sum())
    if n:
        assert eng._evict_prefix(n)


def assert_tiers_balanced(eng):
    """The page pool's conservation, extended across the host and disk
    tiers: refcounts equal slot holds plus cache holds; the host tier within
    its capacity with its bytes counted; every disk entry a committed file;
    no partial-tail index entry pointing at a vanished entry."""
    holds = {}
    for pages in eng._slot_pages:
        for p in pages:
            holds[p] = holds.get(p, 0) + 1
    cached = set(eng._prefix.pages())
    assert len(cached) == len(eng._prefix.pages())
    assert {p for p in range(eng.num_pages) if eng._page_cached[p]} == cached
    free = list(eng._free_pages)
    assert len(free) == len(set(free)) and 0 not in free and int(eng._page_ref[0]) == 0
    for p in range(1, eng.num_pages):
        ref = int(eng._page_ref[p])
        assert ref == holds.get(p, 0) + (p in cached), f"page {p}: refcount {ref}"
        assert (p in free) == (ref == 0), f"page {p}: free list"
    pool = eng._host_kv
    st = pool.stats()
    assert st["host_entries"] == len(pool._host) <= pool.host_pages
    assert st["host_bytes"] == sum(pool._entry_bytes(e) for e in pool._host.values())
    assert st["disk_entries"] == len(pool._disk) <= pool.disk_pages
    assert all(os.path.exists(rec["path"]) for rec in pool._disk.values())
    for keys in pool._partials.values():
        assert keys and all(k in pool for k in keys)


# ------------------------------------------------------- the pool alone


def test_pool_put_get_lru_and_idempotence():
    pool = HostKVPool(host_pages=2)
    blocks = _blocks(0)
    assert pool.put(b"k1", b"root", 4, None, blocks)
    assert not pool.put(b"k1", b"root", 4, None, _blocks(9))  # idempotent
    assert b"k1" in pool and pool.tier_of(b"k1") == "host"
    e = pool.get(b"k1")
    assert e.ntok == 4 and e.tier == "host" and _equal(e.blocks, blocks)
    pool.put(b"k2", b"k1", 4, None, _blocks(1))
    pool.put(b"k3", b"k2", 4, None, _blocks(2))  # no disk: the LRU entry drops
    assert b"k1" not in pool and pool.dropped == 1 and len(pool) == 2
    assert pool.host_bytes == 2 * 2 * 2 * 24 * 4


def test_pool_partial_candidates_span_tiers(tmp_path):
    pool = HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=4)
    pool.put(b"t1", b"p", 3, np.array([5, 6, 7], np.int32), _blocks(3))
    pool.put(b"t2", b"p", 2, np.array([5, 9], np.int32), _blocks(4))  # t1 to disk
    assert pool.tier_of(b"t1") == "disk" and pool.tier_of(b"t2") == "host"
    got = {k: list(np.asarray(t)) for k, _, t in pool.partial_candidates(b"p")}
    assert got == {b"t1": [5, 6, 7], b"t2": [5, 9]}
    pool.discard(b"t1")
    assert b"t1" not in pool and not os.listdir(tmp_path)
    assert [k for k, _, _ in pool.partial_candidates(b"p")] == [b"t2"]


def test_pool_disk_spill_roundtrip_bitwise(tmp_path):
    """bf16 (as its raw 16-bit words), int8 and f32 blocks come back from
    the disk bit for bit, with their dtypes."""
    g = torch.Generator().manual_seed(7)
    blocks = [(torch.randn(2, 4, 3, generator=g).to(torch.bfloat16),
               torch.randint(-127, 128, (2, 4, 3), generator=g).to(torch.int8),
               torch.rand(2, 4, generator=g), torch.rand(2, 4, generator=g))]
    pool = HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=4)
    pool.put(b"a", b"r", 4, None, blocks)
    pool.put(b"b", b"r", 4, None, _blocks(5))  # pushes "a" to disk
    assert pool.tier_of(b"a") == "disk" and pool.demotions_to_disk == 1
    e = pool.get(b"a")
    assert e is not None and e.tier == "disk" and pool.disk_loads == 1
    assert _equal(e.blocks, blocks)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_format_is_the_references(tmp_path, writer):
    """A spill written by one package is read back bit for bit by the
    other: the same header, the same raw blob, bf16 included."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    k = rng.standard_normal((2, 4, 3)).astype(np.float32)
    q = rng.randint(-127, 128, (2, 4, 3)).astype(np.int8)
    s = rng.rand(2, 4).astype(np.float32)
    np_blocks = [(np.asarray(jnp.asarray(k, jnp.bfloat16)), q, s)]
    t_blocks = [(torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(q),
                 torch.from_numpy(s))]
    toks = np.array([4, 5], np.int32)
    if writer == "reference":
        src = jkv.HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=2)
        src.put(b"a", b"r", 2, toks, np_blocks)
        src.put(b"b", b"r", 4, None, [(np.zeros((1,), np.float32),)])
        dst = HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=2)
    else:
        src = HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=2)
        src.put(b"a", b"r", 2, toks, t_blocks)
        src.put(b"b", b"r", 4, None, [(torch.zeros(1),)])
        dst = jkv.HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=2)
    dst._disk[b"a"] = dict(src._disk[b"a"])  # the catalog record the pool keeps
    e = dst.get(b"a")
    assert e is not None and e.ntok == 2 and list(e.tokens) == [4, 5]

    def raw(x):  # a block's bits, bf16 as its 16-bit words
        name = str(x.dtype).replace("torch.", "")
        x = np.asarray(x.view(torch.int16) if name == "bfloat16" and isinstance(
            x, torch.Tensor) else x)
        return name, (x.view(np.int16) if name == "bfloat16" else x).tolist()

    assert [raw(x) for x in e.blocks[0]] == [raw(x) for x in t_blocks[0]]


def test_pool_corrupt_spill_quarantined_on_load(tmp_path):
    pool = HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=4)
    pool.put(b"a", b"r", 4, None, _blocks(6))
    pool.put(b"b", b"r", 4, None, _blocks(7))
    path = pool._disk[b"a"]["path"]
    flip_bit(path)
    assert pool.get(b"a") is None and pool.quarantined == 1
    assert b"a" not in pool
    assert os.path.exists(path + ".quarantined") and not os.path.exists(path)


def test_pool_torn_spill_is_invisible(tmp_path):
    pool = HostKVPool(host_pages=1, disk_dir=str(tmp_path), disk_pages=4)
    pool.put(b"a", b"r", 4, None, _blocks(8))
    with FaultyFS(match="*.kvblk*", faults={0: "torn"}) as fs:
        pool.put(b"b", b"r", 4, None, _blocks(9))  # the spill of "a" is torn
    assert fs.log and fs.log[0][1] == "torn"
    assert b"a" not in pool and pool.dropped == 1 and pool.get(b"a") is None
    assert not os.listdir(tmp_path)


def test_gather_and_upload_match_reference():
    """The batched gather of pages across every layer's pools (int8 layout:
    k, v and their scale pools) and the scatter back, against the
    reference's functions on the same pools."""
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    pools = [(rng.randint(-127, 128, (6, 2, 4, 8)).astype(np.int8),
              rng.randint(-127, 128, (6, 2, 4, 8)).astype(np.int8),
              rng.rand(6, 2, 4).astype(np.float32), rng.rand(6, 2, 4).astype(np.float32))
             for _ in range(2)]
    pages = np.array([4, 1, 5], np.int32)
    want = jkc.gather_pages_to_host([tuple(jnp.asarray(x) for x in c) for c in pools],
                                    jnp.asarray(pages))
    tpools = [tuple(torch.from_numpy(x.copy()) for x in c) for c in pools]
    got = tkc.gather_pages_to_host(tpools, torch.from_numpy(pages).long())
    for lw, lg in zip(want, got):
        for w, x in zip(lw, lg):
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))
    blocks = [tuple(x.flip(0) for x in lt) for lt in got]
    dst = np.array([2, 3, 1], np.int32)
    want = jkc.upload_host_pages([tuple(jnp.asarray(x) for x in c) for c in pools],
                                 jnp.asarray(dst),
                                 [tuple(jnp.asarray(b.numpy()) for b in lt) for lt in blocks])
    assert tkc.upload_host_pages(tpools, torch.from_numpy(dst).long(), blocks) is tpools
    for lw, lg in zip(want, tpools):
        for w, x in zip(lw, lg):
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))


# ------------------------------------------------------------ the engine


def _cycle(jm, tm, batches, n_new, **kw):
    """The batches through the reference engine (tiers off) and the port's
    with and without the tiers, the tiers-on engine demoting and evicting
    everything after the first batch.  Returns the tiers-on engine."""
    outs = {}
    for on in (True, False):
        eng = LLMEngine(tm, **ENGINE, **({**kw} if on else
                                         {k: v for k, v in kw.items() if k == "cache_dtype"}))
        got, cow0 = [], 0
        for i, batch in enumerate(batches):
            futs = [eng.submit(p, max_new_tokens=n_new) for p in batch]
            for _ in range(200):
                if all(f.done() for f in futs) and eng._prefilling is None:
                    break
                eng.step()
                if on:
                    assert_tiers_balanced(eng)
            got.append([f.result(timeout=1) for f in futs])
            if on and i == 0:
                _drain_to_tiers(eng)
                assert_tiers_balanced(eng)
                cow0 = eng.stats()["prefix_cache"]["cow_copies"]
        outs[on] = got
        if on:
            on_eng, cow = eng, eng.stats()["prefix_cache"]["cow_copies"] - cow0
    assert outs[True] == outs[False]
    jeng = JEngine(jm, **ENGINE, **{k: v for k, v in kw.items() if k == "cache_dtype"})
    want = []
    for batch in batches:
        futs = [jeng.submit(p, max_new_tokens=n_new) for p in batch]
        jeng.run_until_complete()
        want.append([f.result(timeout=1) for f in futs])
    assert outs[True] == want
    st = on_eng.stats()
    assert st["kv_pages_in_use"] == 0
    return on_eng, cow


def test_tier_cycle_parity_llama_host(llama):
    """Tokens with the host tier on equal the tiers-off engine's and the
    reference's through demote -> evict -> promote -> copy-on-write: the
    second batch's tails diverge inside the promoted partial-tail page, so
    its first decode write forks it after the promotion."""
    jm, tm = llama
    rng = np.random.RandomState(60)
    mk = _mk(rng, rng.randint(0, 1024, 44).astype(np.int32))  # off the page grid
    eng, cow = _cycle(jm, tm, [[mk(4), mk(6)], [mk(3), mk(5)]], 5, host_cache_pages=16)
    tiers = eng.stats()["prefix_cache"]["tiers"]
    assert tiers["demotions"] > 0 and tiers["promotions"] > 0
    assert tiers["host"]["hit_tokens"] > 0 and tiers["host"]["hit_ratio"] > 0
    assert cow > 0 and tiers["worker_error"] is None


def test_tier_cycle_disk_roundtrip_gpt_int8(tmp_path):
    """int8 kv and its f32 scales through the DISK tier (a 2-page host tier
    spills): promotion reads them back bit for bit, so the tokens equal the
    tiers-off engine's and the reference's."""
    paddle.seed(11)
    jm = JGPT(JGPTConfig.tiny(max_position_embeddings=128))
    jm.eval()
    tm = load_reference_state(GPTForCausalLM(GPTConfig.tiny(max_position_embeddings=128),
                                             device="cpu"), _weights(jm)).eval()
    rng = np.random.RandomState(61)
    mk = _mk(rng, rng.randint(0, 1024, 40).astype(np.int32))
    eng, _ = _cycle(jm, tm, [[mk(4), mk(6)], [mk(3), mk(7)]], 5, cache_dtype="int8",
                    host_cache_pages=2, disk_cache_dir=str(tmp_path / "kv"),
                    disk_cache_pages=16)
    tiers = eng.stats()["prefix_cache"]["tiers"]
    assert tiers["spilled_to_disk"] > 0 and tiers["disk"]["loads"] > 0
    assert tiers["disk"]["hit_tokens"] > 0


def test_promotion_restarts_prefill_at_first_uncached_token(llama):
    """After a demote / evict cycle the same prompt promotes its staged
    blocks and prefills ONE chunk instead of five, with the same tokens."""
    _, tm = llama
    p = np.random.RandomState(62).randint(0, 1024, 40).astype(np.int32)
    eng = LLMEngine(tm, **dict(ENGINE, max_batch_slots=1, prefill_chunk=8),
                    host_cache_pages=8)
    first = eng.generate(p, max_new_tokens=4)
    assert eng.stats()["prefill_chunks"] == 5  # ceil(40 / 8): cold
    _drain_to_tiers(eng)
    again = eng.generate(p, max_new_tokens=4)
    # 39 of 40 usable tokens promoted: one chunk recomputes the last
    assert eng.stats()["prefill_chunks"] == 6
    assert again == first == _solo(tm, p, 4)
    assert eng.stats()["prefix_cache"]["tiers"]["promotions"] == 2  # a page and a tail
    assert_tiers_balanced(eng)


def test_demotion_stays_off_the_tick_path(llama):
    """step() never demotes; the worker starts with the pump, polls
    unforced, and is joined by stop()."""
    _, tm = llama
    rng = np.random.RandomState(64)
    eng = LLMEngine(tm, **ENGINE, host_cache_pages=8)
    calls = []
    orig = eng.demote_step
    eng.demote_step = lambda force=False: (calls.append(force), orig(force))[1]
    eng.generate(rng.randint(0, 1024, 40).astype(np.int32), max_new_tokens=5)
    assert calls == []
    eng.start()
    try:
        assert eng._demote_thread is not None and eng._demote_thread.is_alive()
        eng.submit(rng.randint(0, 1024, 12).astype(np.int32), max_new_tokens=3).result(60)
    finally:
        eng.stop()
    assert eng._demote_thread is None
    assert all(force is False for force in calls)


def test_tiers_absent_not_zero_and_errors(llama):
    jm, tm = llama
    assert "tiers" not in LLMEngine(tm, **ENGINE).stats()["prefix_cache"]
    tiers = LLMEngine(tm, **ENGINE, host_cache_pages=4).stats()["prefix_cache"]["tiers"]
    assert tiers["host"]["capacity"] == 4 and tiers["disk"]["capacity"] == 0
    assert LLMEngine(tm, **ENGINE).demote_step(force=True) == 0  # no tiers: a no-op
    for kw in (dict(max_batch_slots=1, max_seq_len=128, host_cache_pages=4),
               dict(ENGINE, prefix_cache=False, host_cache_pages=4)):
        with pytest.raises(ValueError):
            JEngine(jm, **kw)
        with pytest.raises(ValueError):
            LLMEngine(tm, **kw)


def test_tier_conservation_under_churn(llama, tmp_path):
    """Demotion, promotion, finish, expiry and preemption over a pool too
    small for everyone, a 3-page host tier spilling to a 4-page disk tier:
    conservation holds after every tick and every staging pass, and the
    requests that finish give their solo tokens."""
    _, tm = llama
    rng = np.random.RandomState(65)
    t = [0.0]
    eng = LLMEngine(tm, **dict(ENGINE, max_batch_slots=3), num_pages=6, clock=lambda: t[0],
                    host_cache_pages=3, disk_cache_dir=str(tmp_path / "kv"),
                    disk_cache_pages=4)
    mk = _mk(rng, rng.randint(0, 1024, 34).astype(np.int32))
    reqs = [(mk(3), 20, None), (rng.randint(0, 1024, 20).astype(np.int32), 30, 5.0),
            (mk(5), 3, None)]
    futs = [eng.submit(p, max_new_tokens=n, timeout=to) for p, n, to in reqs]
    second = False
    for i in range(300):
        if all(f.done() for f in futs) and eng._prefilling is None:
            if second:
                break
            # a second wave after evicting the (staged) HBM copies: its
            # admission goes through promotion mid-churn
            eng._evict_prefix(int(eng._page_cached.sum()))
            reqs.append((mk(4), 4, None))
            futs.append(eng.submit(reqs[-1][0], max_new_tokens=4))
            second = True
        eng.step()
        assert_tiers_balanced(eng)
        if i % 3 == 0:
            eng.demote_step(force=True)
            assert_tiers_balanced(eng)
        if i == 8:
            t[0] = 10.0  # the deadline fires mid-decode
    assert len(futs) == 4 and all(f.done() for f in futs)
    st = eng.stats()
    assert st["kv_pages_in_use"] == 0 and st["expired"] == 1
    tiers = st["prefix_cache"]["tiers"]
    assert tiers["demotions"] > 0 and tiers["promotions"] > 0
    for (p, n, to), f in zip(reqs, futs):
        if to is None:
            assert f.result(timeout=1) == _solo(tm, p, n)


def test_torn_and_corrupt_spills_fall_back_to_reprefill(llama, tmp_path):
    """A torn spill vanishes whole and a corrupt committed one is
    quarantined on load: both read as misses, and the prompts re-prefill to
    the same tokens."""
    _, tm = llama
    rng = np.random.RandomState(66)
    disk = tmp_path / "kv"
    mk = _mk(rng, rng.randint(0, 1024, 40).astype(np.int32))
    eng = LLMEngine(tm, **ENGINE, host_cache_pages=1, disk_cache_dir=str(disk),
                    disk_cache_pages=8)
    p1, p2 = mk(4), mk(6)
    a1, a2 = eng.generate(p1, max_new_tokens=4), eng.generate(p2, max_new_tokens=4)
    with FaultyFS(match="*.kvblk*", faults={0: "torn"}) as fs:
        _drain_to_tiers(eng)  # 3 entries through a 1-page host tier: 2 spills
    assert fs.log and fs.log[0][1] == "torn"
    pool = eng._host_kv
    assert pool.dropped >= 1 and not list(disk.glob("*.tmp"))
    assert_tiers_balanced(eng)
    committed = sorted(disk.glob("*.kvblk"))
    assert len(committed) == 2 and pool.stats()["disk_entries"] == 2
    flip_bit(str(committed[0]))
    assert eng.generate(p1, max_new_tokens=4) == a1 == _solo(tm, p1, 4)
    assert eng.generate(p2, max_new_tokens=4) == a2 == _solo(tm, p2, 4)
    assert pool.quarantined >= 1 and list(disk.glob("*.quarantined"))
    assert_tiers_balanced(eng)
    assert eng.stats()["kv_pages_in_use"] == 0


def test_mid_promotion_death_restores_free_pages(llama, monkeypatch):
    """An upload that dies mid-promotion gives its popped pages back and
    raises; the staged entries stay intact, and the healed engine serves
    the prefix by promotion with the solo tokens."""
    _, tm = llama
    rng = np.random.RandomState(67)
    mk = _mk(rng, rng.randint(0, 1024, 40).astype(np.int32))
    eng = LLMEngine(tm, **ENGINE, host_cache_pages=8)
    eng.generate(mk(4), max_new_tokens=3)
    _drain_to_tiers(eng)
    free0 = sorted(eng._free_pages)

    def poisoned(caches, pages, blocks):
        raise RuntimeError("injected upload fault")

    monkeypatch.setattr(llm_server, "upload_host_pages", poisoned)
    eng.submit(mk(5), max_new_tokens=3)
    with pytest.raises(RuntimeError, match="injected upload fault"):
        eng.step()
    assert sorted(eng._free_pages) == free0, "promotion leaked pages"
    assert_tiers_balanced(eng)
    monkeypatch.undo()
    p3 = mk(6)
    assert eng.generate(p3, max_new_tokens=3) == _solo(tm, p3, 3)
    assert eng.stats()["prefix_cache"]["tiers"]["promotions"] > 0
    assert_tiers_balanced(eng)
