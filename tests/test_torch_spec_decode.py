"""Port parity: speculative decoding (models/spec_decode, ops/sampling
spec_accept, generate(spec_k=) and the engines' verify tick) against the
JAX reference on the CPU, in f32, with the same weights.

- ``NGramDrafter.propose`` equals the reference's on random and repetitive
  contexts; greedy ``spec_accept`` equals the reference's.  Sampled
  acceptance draws from a torch.Generator, so it is held by its semantics:
  the same generator state gives the same tokens, tokens are valid, top-k 1
  is greedy, near-one-hot targets accept right drafts and reject wrong ones.
- Greedy tokens of ``generate(spec_k=)`` and of the dense and paged engines
  at ``spec_k`` equal the reference's (and so spec_k=0's), on f32 static,
  int8 and paged caches, and the engines' ``spec`` stats equal its.
- A request preempted twice mid-verify finishes with the NON-speculative
  oracle's tokens: the reference engine gets its sixth token wrong there
  (ROADMAP.md Queue 3), so the oracle, not the reference engine, holds it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import spec_decode as jsd
from paddle_tpu.ops import sampling as jsampling
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import spec_decode as tsd
from paddle_tpu_torch.ops import sampling as tsampling

# the reference suite's model (tests/test_spec_decode.py): tiny, 8 heads of 32
CFG = dict(use_flash_attention=False, max_position_embeddings=256)
PAGED = dict(max_batch_slots=2, max_seq_len=128, kv_layout="paged", page_size=32,
             prefill_chunk=32)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(tensor_parallel=False, **CFG))
    jm.eval()
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu"), ref)
    return jm, tm.eval()


def _oracle(jm, prompt, n):
    ids = paddle.to_tensor(np.asarray(prompt, np.int32)[None, :])
    return list(np.asarray(jm.generate(ids, max_new_tokens=n)._value)[0])


class OracleDrafter:
    """Drafts the true greedy continuation: every draft is accepted."""

    name = "oracle"

    def __init__(self, full_seq):
        self.seq = np.asarray(full_seq, np.int32)

    def propose(self, context, k):
        i = len(np.asarray(context).reshape(-1))
        out = np.zeros(int(k), np.int32)
        tail = self.seq[i:i + int(k)]
        out[:tail.size] = tail
        return out


class BadDrafter:
    """Constant drafts: (almost) every one is rejected."""

    name = "bad"

    def propose(self, context, k):
        return np.zeros(int(k), np.int32)


# ---------------------------------------------------------------- drafters


def _contexts():
    rng = np.random.RandomState(0)
    base = rng.randint(0, 30, 12).astype(np.int32)
    return {
        "random": rng.randint(0, 1000, 40).astype(np.int32),
        "repetitive": np.concatenate([base, base, base[:7]]),
        "suffix_recurs": np.array([1, 2, 3, 4, 5, 1, 2, 3], np.int32),
        "short_tail": np.array([7, 8, 9, 7, 8], np.int32),
        "no_recurrence": np.array([1, 2, 3], np.int32),
        "one_token": np.array([5], np.int32),
        "small_vocab": rng.randint(0, 4, 60).astype(np.int32),
    }


@pytest.mark.parametrize("name", sorted(_contexts()))
def test_ngram_drafts_equal_reference(name):
    ctx = _contexts()[name]
    for mx, mn in ((3, 1), (2, 2), (5, 1)):
        for k in (1, 3, 4, 8):
            want = jsd.NGramDrafter(mx, mn).propose(ctx, k)
            got = tsd.NGramDrafter(mx, mn).propose(ctx, k)
            assert got.dtype == np.int32 and got.tolist() == want.tolist()


def test_get_drafter_resolution(pair):
    assert isinstance(tsd.get_drafter(None), tsd.NGramDrafter)
    assert isinstance(tsd.get_drafter("ngram"), tsd.NGramDrafter)
    own = BadDrafter()
    assert tsd.get_drafter(own) is own
    assert tsd.get_drafter(pair[1]).model is pair[1]
    with pytest.raises(ValueError):
        tsd.get_drafter(42)
    with pytest.raises(ValueError):
        tsd.NGramDrafter(max_ngram=0)


def test_draft_model_drafter_equals_reference(pair):
    """A draft model (here the target itself) rolls out the same greedy
    drafts in both packages, over the same bucketed window."""
    jm, tm = pair
    ctx = np.random.RandomState(1).randint(0, 1024, 21).astype(np.int32)
    for c in (ctx, ctx[:5]):
        want = jsd.DraftModelDrafter(jm).propose(c, 4)
        got = tsd.DraftModelDrafter(tm).propose(c, 4)
        assert got.tolist() == want.tolist()


# ------------------------------------------------------------- acceptance


def _ladder_logits(rng, B, K, V, scale=5.0):
    lad = rng.randint(0, V, (B, K + 1)).astype(np.int32)
    logits = rng.randn(B, K + 1, V).astype(np.float32)
    for b in range(B):
        for i in range(K + 1):
            logits[b, i, lad[b, i]] += scale
    return lad, logits


def _knobs_t(B, do_sample=False, temperature=1.0, top_k=0, top_p=1.0):
    return (torch.full((B,), do_sample), torch.full((B,), float(temperature)),
            torch.full((B,), int(top_k), dtype=torch.int32), torch.full((B,), float(top_p)))


def _knobs_j(B, do_sample=False, temperature=1.0, top_k=0, top_p=1.0):
    return (jnp.full((B,), do_sample, bool), jnp.full((B,), temperature, jnp.float32),
            jnp.full((B,), top_k, jnp.int32), jnp.full((B,), top_p, jnp.float32))


@pytest.mark.parametrize("K", [1, 4])
def test_greedy_spec_accept_equals_reference(K):
    rng = np.random.RandomState(K)
    B, V = 6, 32
    lad, logits = _ladder_logits(rng, B, K, V)
    drafts = lad[:, :K].copy()
    for b in range(1, B):  # row b diverges at draft b - 1 (row 0 all right)
        if b - 1 < K:
            drafts[b, b - 1] = (drafts[b, b - 1] + 1) % V
    want_o, want_n = jsampling.spec_accept(jnp.asarray(logits), jnp.asarray(drafts),
                                           jax.random.PRNGKey(0), *_knobs_j(B))
    got_o, got_n = tsampling.spec_accept(torch.from_numpy(logits), torch.from_numpy(drafts),
                                         torch.Generator().manual_seed(0), *_knobs_t(B))
    assert got_n.tolist() == np.asarray(want_n).tolist()
    assert got_o.tolist() == np.asarray(want_o).tolist()
    assert got_o.dtype == torch.int32 and got_n.dtype == torch.int32
    assert got_n[0] == K and (got_o[0].numpy() == lad[0]).all()


def test_sampled_spec_accept_semantics():
    rng = np.random.RandomState(4)
    B, K, V = 8, 4, 48
    lad, logits = _ladder_logits(rng, B, K, V, scale=2.0)
    drafts = lad[:, :K].copy()
    drafts[::2] = rng.randint(0, V, (B // 2, K))
    lt, dt = torch.from_numpy(logits), torch.from_numpy(drafts)
    knobs = _knobs_t(B, True, 0.9, 8, 0.95)
    a = tsampling.spec_accept(lt, dt, torch.Generator().manual_seed(3), *knobs)
    b = tsampling.spec_accept(lt, dt, torch.Generator().manual_seed(3), *knobs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])  # one stream, one answer
    allowed = np.isfinite(np.asarray(jsampling.mask_logits(
        jnp.asarray(logits.reshape(-1, V)), jnp.full((B * (K + 1),), 0.9, jnp.float32),
        jnp.full((B * (K + 1),), 8, jnp.int32), jnp.full((B * (K + 1),), 0.95, jnp.float32)))
    ).reshape(B, K + 1, V)
    out, n = a[0].numpy(), a[1].numpy()
    for r in range(B):
        assert 0 <= n[r] <= K
        assert out[r, :n[r]].tolist() == drafts[r, :n[r]].tolist()
        assert allowed[r, n[r], out[r, n[r]]]  # the correction / bonus
        if n[r] < K:
            assert out[r, n[r]] != drafts[r, n[r]]  # the residual excludes it
    # top-k 1 sampled rows are greedy, bit for bit
    g = tsampling.spec_accept(lt, dt, torch.Generator().manual_seed(5), *_knobs_t(B))
    k1 = tsampling.spec_accept(lt, dt, torch.Generator().manual_seed(5),
                               *_knobs_t(B, True, 0.7, 1))
    assert torch.equal(g[0][torch.arange(B), g[1].long()],
                       k1[0][torch.arange(B), k1[1].long()])
    assert torch.equal(g[1], k1[1])


def test_sampled_spec_accept_near_one_hot():
    """As the reference suite: right one-hot drafts are always accepted,
    wrong ones always rejected with the correction drawn off the peak."""
    B, K, V = 2, 2, 8
    peak = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    logits = np.full((B, K + 1, V), -50.0, np.float32)
    for b in range(B):
        for i in range(K + 1):
            logits[b, i, peak[b, i]] = 50.0
    drafts = peak[:, :K].copy()
    drafts[1] = (drafts[1] + 1) % V
    out, n = tsampling.spec_accept(torch.from_numpy(logits), torch.from_numpy(drafts),
                                   torch.Generator().manual_seed(5), *_knobs_t(B, True))
    assert n.tolist() == [K, 0]
    assert out[0].tolist() == peak[0].tolist() and out[1, 0] == peak[1, 0]


# ---------------------------------------------------------- generate(spec)


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged"), dict(cache_dtype="int8"),
                                dict(cache_dtype="int8", kv_layout="paged"),
                                dict(kv_layout="paged", share_prefix=True)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "static")
def test_generate_spec_greedy_equals_reference(pair, kw):
    jm, tm = pair
    rng = np.random.RandomState(10)
    base = rng.randint(0, 1024, (2, 9)).astype(np.int32)
    ids = np.concatenate([base, base[:, :5]], axis=1)  # repeats: some drafts land
    if kw.get("share_prefix"):
        ids = np.concatenate([np.repeat(ids[:1], 2, 0), rng.randint(0, 1024, (2, 40))], 1)
        ids = ids.astype(np.int32)
    kw = dict(kw, max_new_tokens=10, page_size=32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), spec_k=4, **kw)._value)
    got = tm.generate(torch.from_numpy(ids), spec_k=4, **kw)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    assert (got.numpy() == tm.generate(torch.from_numpy(ids), **kw).numpy()).all()


def test_generate_spec_eos_and_sampling(pair):
    jm, tm = pair
    ids = np.random.RandomState(11).randint(0, 1024, (2, 8)).astype(np.int32)
    ref = tm.generate(torch.from_numpy(ids), max_new_tokens=8).numpy()
    eos = int(ref[0, 2])
    kw = dict(max_new_tokens=8, eos_token_id=eos, pad_token_id=0)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), spec_k=3, **kw)._value)
    got = tm.generate(torch.from_numpy(ids), spec_k=3, **kw).numpy()
    assert (got == want).all() and (got[0, 3:] == 0).all()
    skw = dict(max_new_tokens=6, do_sample=True, temperature=0.9, top_k=8, top_p=0.95,
               spec_k=3)
    a = tm.generate(torch.from_numpy(ids), generator=torch.Generator().manual_seed(3), **skw)
    b = tm.generate(torch.from_numpy(ids), generator=torch.Generator().manual_seed(3), **skw)
    assert torch.equal(a, b) and a.shape == (2, 6) and bool(((a >= 0) & (a < 1024)).all())
    with pytest.raises(ValueError):
        tm.generate(torch.from_numpy(ids), max_new_tokens=4, spec_k=-1)


# ---------------------------------------------------------------- engines


def _serve(cls, model, prompts, max_new, **kw):
    eng = cls(model, **kw)
    futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_complete()
    return [f.result() for f in futs], eng.stats()


ENGINE_RUNS = {
    "paged": (PAGED, (6, 13, 21), 6),
    "paged_int8": (dict(PAGED, cache_dtype="int8"), (6, 13, 21), 6),
    # staggered admissions with the cache on: a verify forks a shared tail
    "paged_shared_prefix": (dict(PAGED, prefill_chunk=16), "shared", 7),
    "dense": (dict(max_batch_slots=2, max_seq_len=128), (11, 30, 7), 5),
    "dense_int8": (dict(max_batch_slots=2, max_seq_len=128, cache_dtype="int8"),
                   (11, 30, 7), 5),
}


@pytest.mark.parametrize("run", sorted(ENGINE_RUNS))
def test_engine_spec_greedy_and_stats_equal_reference(pair, run):
    jm, tm = pair
    kw, lens, max_new = ENGINE_RUNS[run]
    rng = np.random.RandomState(20)
    if lens == "shared":
        head = rng.randint(0, 1024, 40).astype(np.int32)
        prompts = [np.concatenate([head, rng.randint(0, 1024, t).astype(np.int32)])
                   for t in (3, 5, 2)]
    else:
        prompts = [rng.randint(0, 1024, n).astype(np.int32) for n in lens]
    want, jst = _serve(JEngine, jm, prompts, max_new, spec_k=4, **kw)
    got, st = _serve(LLMEngine, tm, prompts, max_new, spec_k=4, **kw)
    assert got == want
    if "cache_dtype" not in kw:  # an int8 cache rounds kv, unlike the oracle's
        assert got == [_oracle(jm, p, max_new) for p in prompts]
    assert st["spec"] == jst["spec"]
    assert st["spec"]["verify_calls"] > 0
    assert st["spec"]["drafted_tokens"] == (st["spec"]["accepted_tokens"]
                                            + st["spec"]["rolled_back_tokens"])
    if kw.get("kv_layout") == "paged":
        assert st["kv_pages_in_use"] == 0
        assert st["prefix_cache"] == {k: v for k, v in jst["prefix_cache"].items()
                                      if k != "tiers"}
    assert st["admission_reorders"] == 0


@pytest.mark.parametrize("drafter", ["oracle", "bad"])
def test_engine_spec_acceptance_and_rollback(pair, drafter):
    """Oracle drafts: every draft accepted, far fewer verifies than tokens.
    Constant drafts: (almost) all rejected, the headroom pages handed back,
    the output still exact.  The spec stats equal the reference's."""
    jm, tm = pair
    rng = np.random.RandomState(22 if drafter == "oracle" else 23)
    p = rng.randint(0, 1024, 10 if drafter == "oracle" else 30).astype(np.int32)
    n, k = (12, 3) if drafter == "oracle" else (6, 4)
    truth = _oracle(jm, p, n)
    seq = np.concatenate([p, np.asarray(truth, np.int32)])
    kw = dict(PAGED, max_batch_slots=1, spec_k=k)
    stats = {}
    for cls, m in ((JEngine, jm), (LLMEngine, tm)):
        d = OracleDrafter(seq) if drafter == "oracle" else BadDrafter()
        eng = cls(m, spec_draft=d, **kw)
        assert eng.generate(p, max_new_tokens=n) == truth
        stats[cls] = eng.stats()
    st = stats[LLMEngine]
    assert st["spec"] == stats[JEngine]["spec"]
    if drafter == "oracle":
        assert st["spec"]["verify_calls"] <= (n - 1 + k) // (k + 1) + 1
        assert st["spec"]["acceptance_ratio"] > 0.5
    else:
        assert st["spec"]["rolled_back_pages"] > 0 and st["spec"]["acceptance_ratio"] < 0.5
        assert st["kv_pages_in_use"] == 0


def test_engine_spec_topk1_sampled_is_greedy(pair):
    jm, tm = pair
    p = np.random.RandomState(24).randint(0, 1024, 12).astype(np.int32)
    want = _oracle(jm, p, 5)
    for spec_k in (0, 3):
        eng = LLMEngine(tm, max_batch_slots=2, max_seq_len=128, spec_k=spec_k,
                        generator=torch.Generator().manual_seed(0))
        f1 = eng.submit(p, max_new_tokens=5, do_sample=True, top_k=1, temperature=0.7)
        f2 = eng.submit(p, max_new_tokens=5)
        eng.run_until_complete()
        assert f1.result() == want and f2.result() == want


def test_engine_spec_guards(pair):
    tm = pair[1]
    with pytest.raises(ValueError, match="spec_k"):
        LLMEngine(tm, spec_k=-1)
    with pytest.raises(ValueError, match="decode_chunk"):
        LLMEngine(tm, spec_k=2, decode_chunk=2)
    with pytest.raises(ValueError, match="spec_draft"):
        LLMEngine(tm, spec_k=2, spec_draft=42)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_mid_verify_preemption_gives_the_oracle(pair, prefix_cache):
    """Two spec slots whose verify headroom cannot coexist in 3 allocatable
    pages (the reference suite's seed 26, prompts of 30, page_size 32,
    spec_k 3): request b is preempted mid-verify, twice.  Both finish with
    the non-speculative oracle's tokens and the pool drains.  The reference
    engine gives b's sixth token as 831 where the oracle gives 368: it
    appends b's first generated token to the prompt a second time."""
    jm, tm = pair
    rng = np.random.RandomState(26)
    pa = rng.randint(0, 1024, 30).astype(np.int32)
    pb = rng.randint(0, 1024, 30).astype(np.int32)
    eng = LLMEngine(tm, **dict(PAGED, num_pages=4), prefix_cache=prefix_cache, spec_k=3)
    fa, fb = eng.submit(pa, max_new_tokens=6), eng.submit(pb, max_new_tokens=6)
    eng.run_until_complete()
    want_b = _oracle(jm, pb, 6)
    assert fa.result() == _oracle(jm, pa, 6) and fb.result() == want_b
    st = eng.stats()
    assert st["kv_pages_in_use"] == 0 and st["preemptions"] >= 2
    assert st["recompute_tokens_by_reason"]["mid_verify"] > 0
    if not prefix_cache:
        assert want_b[5] == 368  # the issue's oracle token
