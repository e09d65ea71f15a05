"""Port parity: multi-tenant LoRA adapters and constrained decoding in the
paged LLMEngine and generate(), against the JAX reference on the CPU, in
f32, with the same weights through the converter.

- The pieces alone: ``lora_epilogue`` against the reference's on seeded
  inputs (f32 within 1e-6 of max |reference|, the zero page exactly zero);
  ``TokenConstraint`` tables (masks equal, transitions equal, the same
  state numbering) and cursor walks against the reference's, over regexes
  and JSON schemas; the registry's refcount / LRU contract; the sampler's
  token mask.
- The engine, in the reference suite's scenarios (tests/test_multi_tenant.py):
  a batch mixing three adapters, base rows and a constrained row gives the
  reference engine's tokens and solo ``generate()``'s (LLaMA and GPT);
  ``adapter_id=None`` on a multi-tenant engine is the plain engine's
  output; speculative decoding composes with adapters; refcounts of
  adapters and kv pages are conserved after every tick under finish,
  expiry, preemption and an adapter pool too small for the traffic; a
  failed admission releases its adapter; invalid combinations raise as the
  reference's do.  The reference's Pallas kernels run in interpret mode.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.inference import constrain as jcon
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import lora as jlora
from paddle_tpu.ops import lora as jolora
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import constrain as tcon
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import lora as tlora
from paddle_tpu_torch.models.lora import AdapterRegistry, LoraAdapter, lora_sites
from paddle_tpu_torch.ops import lora as tolora
from paddle_tpu_torch.ops.sampling import sample_rows

V = 1024
EOS = V - 1
PAGED = dict(max_seq_len=128, eos_token_id=EOS, kv_layout="paged", page_size=32,
             prefill_chunk=16)
SOLO = dict(eos_token_id=EOS, kv_layout="paged", page_size=32)


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


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(11)
    jm = JGPT(JGPTConfig.tiny(max_position_embeddings=256))
    jm.eval()
    tm = load_reference_state(GPTForCausalLM(GPTConfig.tiny(max_position_embeddings=256),
                                             device="cpu"), _weights(jm))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def vocab():
    """The reference suite's toy id -> string map: single digits for ids
    0-9, distinct words elsewhere, </s> at the eos id."""
    v = [str(i) if i < 10 else f"w{i}" for i in range(V)]
    v[EOS] = "</s>"
    return v


def _adapters(mod, model, n, rank=4):
    sites = mod.lora_sites(model)
    return {f"a{i}": mod.LoraAdapter.random(sites, rank=rank, seed=100 + i) for i in range(n)}


def _upto_eos(row):
    out = []
    for t in row:
        out.append(int(t))
        if int(t) == EOS:
            break
    return out


def _solo(tm, prompt, n, **kw):
    """Solo generate(), truncated at eos inclusive (the engine stops there;
    generate() pads the row)."""
    return _upto_eos(tm.generate(torch.from_numpy(np.asarray(prompt, np.int64)[None]),
                                 max_new_tokens=n, **kw)[0].tolist())


def _jsolo(jm, prompt, n, **kw):
    out = jm.generate(paddle.to_tensor(np.asarray(prompt, np.int32)[None]),
                      max_new_tokens=n, **kw)
    return _upto_eos(np.asarray(out._value)[0])


def assert_balanced(eng):
    """Every adapter's pin count equals the live requests holding its page
    (slots and the one mid-prefill); every kv page's refcount equals its
    slot holds plus its cache hold."""
    live = list(eng.slot_req)
    if eng._prefilling is not None:
        live.append(eng._prefilling[0])
    if eng.adapters is not None:
        reg, held = eng.adapters, {}
        for r in live:
            if r is not None and r.adapter_page:
                held[r.adapter_id] = held.get(r.adapter_id, 0) + 1
                assert reg._page_of.get(r.adapter_id) == r.adapter_page
        for aid, ref in reg._ref.items():
            assert ref == held.get(aid, 0), f"adapter {aid!r}: refcount {ref}"
        assert not set(held) - set(reg._ref), "a holder of an unloaded adapter"
    holds = {}
    for pages in eng._slot_pages:
        for p in pages:
            holds[p] = holds.get(p, 0) + 1
    cached = set(eng._prefix.pages()) if eng._prefix is not None else set()
    free = list(eng._free_pages)
    assert len(free) == len(set(free)) and 0 not in free
    for p in range(1, eng.num_pages):
        ref = int(eng._page_ref[p])
        assert ref == holds.get(p, 0) + (p in cached), f"page {p}: refcount {ref}"
        assert (p in free) == (ref == 0), f"page {p}: free list"


def _pump(eng, futs, limit=400):
    for _ in range(limit):
        if all(f.done() for f in futs) and eng._prefilling is None:
            break
        eng.step()
        assert_balanced(eng)
    assert all(f.done() for f in futs), "the engine did not drain"
    return [f.result(timeout=1) for f in futs]


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("pool_dtype", ["bfloat16", "float32"])
def test_lora_epilogue_matches_reference(pool_dtype):
    """Seeded x [3, 5, 48] (f32) against pools of 4 pages at rank 6 (page 0
    zeros): f32 within 1e-6 of max |reference|; the zero page's rows are
    exactly zero."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    a = rng.standard_normal((4, 48, 6)).astype(np.float32)
    b = rng.standard_normal((4, 6, 40)).astype(np.float32)
    a[0] = b[0] = 0.0
    rows = np.array([2, 0, 3], np.int32)
    jdt = getattr(jnp, pool_dtype)
    want = np.asarray(jolora.lora_epilogue(jnp.asarray(x), jnp.asarray(a, jdt),
                                           jnp.asarray(b, jdt), jnp.asarray(rows)))
    tdt = getattr(torch, pool_dtype)
    got = tolora.lora_epilogue(torch.from_numpy(x), torch.from_numpy(a).to(tdt),
                               torch.from_numpy(b).to(tdt), torch.from_numpy(rows)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 5, 40)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert not got[1].any()
    # no context: the hooks add nothing; inside one, the delta of the site
    assert tolora.apply_site("q", torch.from_numpy(x)) is None
    pools = {"q": (torch.from_numpy(a), torch.from_numpy(b))}
    with tolora.activate(pools, torch.from_numpy(rows)):
        assert tolora.active_sites() == frozenset({"q"})
        assert tolora.apply_site("o", torch.from_numpy(x)) is None
        d = tolora.apply_site("q", torch.from_numpy(x))
    assert tolora.active_sites() == frozenset()
    assert torch.equal(d, tolora.lora_epilogue(torch.from_numpy(x), *pools["q"],
                                               torch.from_numpy(rows)))


CHAR_VOCAB = [chr(c) for c in range(0x20, 0x7F)] + ["</s>"]
SCHEMA = {"type": "object", "properties": {
    "a": {"type": "integer"}, "ok": {"type": "boolean"}, "s": {"type": "string"},
    "l": {"type": "array", "items": {"type": "number"}}, "e": {"enum": ["x", 3, None]}}}


@pytest.mark.parametrize("spec,char_level", [
    (r"[0-9]+", False), (r"[0-9][0-9]", False), (r"(w1|w2)+[^w]?", False),
    ({"type": "integer"}, False), (SCHEMA, True), (r"-?\d+(\.\d+)?\s*", True)],
    ids=["digits", "two_digits", "alternation", "integer_schema", "object_schema",
         "number_regex"])
def test_token_constraint_matches_reference(spec, char_level, vocab):
    """The same mask and transition tables, state for state, and the same
    cursor walk over a seeded token sequence."""
    voc, eos = (CHAR_VOCAB, len(CHAR_VOCAB) - 1) if char_level else (vocab, EOS)
    want = jcon.compile_constraint(spec, voc, eos)
    got = tcon.compile_constraint(spec, voc, eos)
    assert (got.n_states, got.V, got.eos_token_id) == (want.n_states, want.V,
                                                       want.eos_token_id)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.trans, want.trans)
    assert tcon.regex_from_schema(SCHEMA) == jcon.regex_from_schema(SCHEMA)
    rng = np.random.RandomState(1)
    jc, tc = want.cursor(), got.cursor()
    for _ in range(40):
        allowed = np.flatnonzero(tc.mask())
        tok = int(rng.choice(allowed)) if rng.rand() < 0.9 else int(rng.randint(len(voc)))
        assert tc.advance(tok) == jc.advance(tok)
        assert tc.state == jc.state
    assert tc.rejects == jc.rejects


def test_regex_automaton_sinks_and_counts_rejects(vocab):
    tc = tcon.compile_constraint(r"[0-9][0-9]", vocab, EOS)
    cur = tc.cursor()
    m = cur.mask()
    assert m[3] and m[7] and not m[20] and not m[EOS]
    assert cur.advance(4) and cur.advance(2)
    assert cur.mask()[EOS] and cur.mask().sum() == 1  # complete: only eos
    assert cur.advance(EOS)
    assert cur.mask()[EOS] and cur.mask().sum() == 1  # the sink
    cur = tcon.compile_constraint(r"[0-9]+", vocab, EOS).cursor()
    assert not cur.advance(500) and cur.rejects == 1
    assert cur.mask()[EOS] and cur.mask().sum() == 1
    # a schema's canonical JSON walks through, and property order matters
    sc = tcon.compile_constraint({"type": "object", "properties": {
        "a": {"type": "integer"}, "ok": {"type": "boolean"}}}, CHAR_VOCAB, len(CHAR_VOCAB) - 1)
    cur = sc.cursor()
    for ch in json.dumps({"a": -42, "ok": True}, separators=(",", ":")):
        assert cur.advance(CHAR_VOCAB.index(ch)), ch
    assert cur.mask()[len(CHAR_VOCAB) - 1]
    masks, trans = sc.device_tables("cpu")
    assert masks.dtype == torch.bool and torch.equal(masks, torch.from_numpy(sc.masks))
    assert sc.device_tables("cpu")[1] is trans  # uploaded once a device


def test_registry_refcounts_lru_eviction_and_errors(llama):
    _, tm = llama
    reg = AdapterRegistry(tm, max_adapters=2, rank=4)
    for aid, ad in _adapters(tlora, tm, 3).items():
        reg.register(aid, ad)
    assert reg.acquire(None) == 0
    with pytest.raises(KeyError):
        reg.acquire("nope")
    pa, pb = reg.acquire("a0"), reg.acquire("a1")
    assert pa != pb and 0 not in (pa, pb)
    assert reg.acquire("a2") is None  # both pages pinned
    reg.release("a0")
    assert reg.acquire("a2") == pa and reg.evictions == 1  # a0 evicted, LRU
    assert reg.page_for("a0") is None
    reg.release("a1")
    reg.release("a2")
    with pytest.raises(AssertionError):
        reg.release("a2")
    st = reg.stats()
    assert st["pages_pinned"] == 0 and st["loads"] == 3 and st["pages_total"] == 2
    for a_pool, b_pool in reg.pool.tree():  # page 0 never written
        assert not a_pool[0].any() and not b_pool[0].any()
    with pytest.raises(ValueError):
        reg.register(None, LoraAdapter.random(lora_sites(tm), rank=4, seed=0))
    with pytest.raises(ValueError):  # rank over the pool's
        reg.register("big", LoraAdapter.random(lora_sites(tm), rank=8, seed=0))


def test_adapter_weights_and_pool_pages_match_reference(llama):
    """The same numpy draws, and the pool's bf16 pages equal the
    reference pool's bits."""
    jm, tm = llama
    jads, tads = _adapters(jlora, jm, 2), _adapters(tlora, tm, 2)
    assert lora_sites(tm) == jlora.lora_sites(jm)
    jreg = jlora.AdapterRegistry.from_adapters(jm, jads, rank=4)
    treg = AdapterRegistry.from_adapters(tm, tads, rank=4)
    for aid in ("a0", "a1"):
        assert jreg.acquire(aid) == treg.acquire(aid)
    for (ja, jb), (ta, tb) in zip(jreg.pool.tree(), treg.pool.tree()):
        np.testing.assert_array_equal(ta.float().numpy(), np.asarray(ja, np.float32))
        np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb, np.float32))


def test_sample_rows_applies_the_token_mask():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 50, generator=g)
    mask = torch.zeros(3, 50, dtype=torch.bool)
    mask[0, [3, 7]] = True
    mask[1, 11] = True
    mask[2] = True
    knobs = (torch.tensor([False, True, False]), torch.full((3,), 0.7),
             torch.tensor([0, 5, 0], dtype=torch.int32), torch.full((3,), 0.9))
    for _ in range(5):
        out = sample_rows(logits, g, *knobs, token_mask=mask)
        assert int(out[0]) == [3, 7][int(logits[0, [3, 7]].argmax())]
        assert int(out[1]) == 11  # sampled, but one token allowed
        assert int(out[2]) == int(logits[2].argmax())  # all True: untouched
    assert torch.equal(sample_rows(logits, g, *knobs)[[0, 2]],
                       logits[[0, 2]].argmax(-1).to(torch.int32))


# ------------------------------------------------------------ the engine


def _mixed_scenario(jm, tm, vocab, seed, lengths, specs, n_new):
    """The same traffic through the reference engine and the port's, both
    with a registry of three adapters; the port's also against its solo
    generate().  Returns the port's tokens."""
    jads = _adapters(jlora, jm, 3)
    tads = _adapters(tlora, tm, 3)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in lengths]
    jeng = JEngine(jm, max_batch_slots=4, adapters=jlora.AdapterRegistry.from_adapters(
        jm, jads, rank=4), constraint_vocab=vocab, **PAGED)
    jf = [jeng.submit(p, max_new_tokens=n_new, adapter_id=a, constraint=c)
          for p, (a, c) in zip(prompts, specs)]
    jeng.run_until_complete()
    eng = LLMEngine(tm, max_batch_slots=4, adapters=AdapterRegistry.from_adapters(
        tm, tads, rank=4), constraint_vocab=vocab, **PAGED)
    got = _pump(eng, [eng.submit(p, max_new_tokens=n_new, adapter_id=a, constraint=c)
                      for p, (a, c) in zip(prompts, specs)])
    assert got == [f.result(timeout=1) for f in jf]
    for p, (a, c), toks in zip(prompts, specs, got):
        tc = tcon.compile_constraint(c, vocab, EOS) if c is not None else None
        assert toks == _solo(tm, p, n_new, adapter_id=a,
                             adapters={a: tads[a]} if a else None, token_mask_fn=tc, **SOLO)
        if tc is not None:
            cur = tc.cursor()
            assert all(cur.advance(t) for t in toks)
    st = eng.stats()
    assert st["adapters"]["pages_pinned"] == 0 and st["kv_pages_in_use"] == 0
    assert st["constraint_rejects"] == 0 and st["constrained_tokens"] > 0
    return got


def test_engine_mixed_adapters_and_constraint_match_reference(llama, vocab):
    jm, tm = llama
    got = _mixed_scenario(jm, tm, vocab, 0, (12, 7, 19, 9),
                          [("a0", None), ("a1", None), ("a2", r"[0-9]+"), (None, None)], 6)
    assert all(0 <= t < 10 or t == EOS for t in got[2])
    # the adapters change the output: a0's request against the base model's
    assert got[0] != _solo(tm, np.random.RandomState(0).randint(0, V, 12), 6, **SOLO)


def test_engine_gpt_adapters_and_constraint_match_reference(gpt, vocab):
    jm, tm = gpt
    _mixed_scenario(jm, tm, vocab, 1, (10, 15, 8, 6),
                    [("a0", None), ("a1", None), ("a2", None), (None, r"[0-9]+")], 5)


def test_adapter_none_is_the_plain_engine(llama, vocab):
    """adapter_id=None, constraint=None on a multi-tenant engine gives the
    plain engine's tokens bit for bit (the zero page adds an exact +0) and
    the reference's solo tokens."""
    jm, tm = llama
    reg = AdapterRegistry.from_adapters(
        tm, _adapters(tlora, tm, 1),
        rank=4)
    p = np.random.RandomState(2).randint(0, V, 14).astype(np.int32)
    mt = LLMEngine(tm, max_batch_slots=2, adapters=reg, constraint_vocab=vocab, **PAGED)
    plain = LLMEngine(tm, max_batch_slots=2, **PAGED)
    got = mt.generate(p, max_new_tokens=6)
    assert got == plain.generate(p, max_new_tokens=6)
    assert got == _jsolo(jm, p, 6, **SOLO)


def test_spec_decode_composes_with_adapters(llama):
    jm, tm = llama
    jads = _adapters(jlora, jm, 1)
    tads = _adapters(tlora, tm, 1)
    eng = LLMEngine(tm, max_batch_slots=2, spec_k=2,
                    adapters=AdapterRegistry.from_adapters(tm, tads, rank=4), **PAGED)
    p = np.random.RandomState(3).randint(0, V, 16).astype(np.int32)
    got = _pump(eng, [eng.submit(p, max_new_tokens=8, adapter_id="a0")])[0]
    assert eng.stats()["spec"]["verify_calls"] > 0
    assert got == _jsolo(jm, p, 8, adapter_id="a0", adapters=jads, **SOLO)
    assert got == _solo(tm, p, 8, adapter_id="a0", adapters=tads, spec_k=2, **SOLO)


def test_invalid_combinations_raise_as_the_reference(llama, vocab):
    _, tm = llama
    reg = AdapterRegistry.from_adapters(
        tm, _adapters(tlora, tm, 1),
        rank=4)
    eng = LLMEngine(tm, max_batch_slots=2, constraint_vocab=vocab, **PAGED)
    p = np.arange(6, dtype=np.int32)
    with pytest.raises(TypeError):
        eng.submit(p, constraint=42)
    with pytest.raises(ValueError):  # no registry on the engine
        eng.submit(p, adapter_id="a0")
    assert eng.stats()["constraint_rejects"] == 1
    with pytest.raises(ValueError):  # vocab size
        eng.submit(p, constraint=tcon.compile_constraint(r"[0-9]+", vocab[:100], 99))
    with pytest.raises(ValueError):  # eos
        eng.submit(p, constraint=tcon.compile_constraint(r"[0-9]+", vocab, 5))
    with pytest.raises(ValueError):  # a wire form without constraint_vocab
        LLMEngine(tm, max_batch_slots=2, **PAGED).submit(p, constraint=r"[0-9]+")
    with pytest.raises(ValueError):  # constraints exclude spec_k
        LLMEngine(tm, max_batch_slots=2, spec_k=2, constraint_vocab=vocab,
                  **PAGED).submit(p, constraint=r"[0-9]+")
    with pytest.raises(KeyError):
        LLMEngine(tm, max_batch_slots=2, adapters=reg, **PAGED).submit(p, adapter_id="zz")
    dense = LLMEngine(tm, max_batch_slots=2, max_seq_len=128, eos_token_id=EOS)
    with pytest.raises(ValueError):
        dense.submit(p, constraint=r"[0-9]+")
    with pytest.raises(ValueError):
        LLMEngine(tm, max_batch_slots=2, max_seq_len=128, adapters=reg)
    with pytest.raises(TypeError):
        LLMEngine(tm, max_batch_slots=2, adapters={"a0": None}, **PAGED)
    tc = tcon.compile_constraint(r"[0-9]+", vocab, EOS)
    ids = torch.from_numpy(p[None].astype(np.int64))
    with pytest.raises(ValueError):
        tm.generate(ids, max_new_tokens=2, token_mask_fn=tc, spec_k=2)
    with pytest.raises(ValueError):
        tm.generate(ids, max_new_tokens=2, token_mask_fn=tc, eos_token_id=3)
    with pytest.raises(ValueError):
        tm.generate(ids, max_new_tokens=2, token_mask_fn=tcon.compile_constraint(
            r"[0-9]+", vocab[:100], 99))
    with pytest.raises(TypeError):
        tm.generate(ids, max_new_tokens=2, token_mask_fn=lambda: 42)
    with pytest.raises(ValueError):
        tm.generate(ids, max_new_tokens=2, adapter_id="a0")
    # the constraint's eos is generate()'s default
    out = tm.generate(ids, max_new_tokens=4, token_mask_fn=lambda: tcon.compile_constraint(
        r"[0-9]", vocab, EOS))[0].tolist()
    assert out[0] < 10 and out[1] == EOS


def test_adapter_pool_conservation_under_churn(llama, vocab):
    """Finish, deadline expiry and pool-dry preemption with more adapters
    than registry pages (an admission waits for a page) and a constrained
    row, on 4 usable kv pages: refcounts balance after every tick and
    drain to zero, and every request that finishes gives its solo tokens
    (a preempted one too: recompute preemption)."""
    _, tm = llama
    t = [0.0]
    tads = _adapters(tlora, tm, 3)
    reg = AdapterRegistry(tm, max_adapters=2, rank=4)
    for aid, ad in tads.items():
        reg.register(aid, ad)
    eng = LLMEngine(tm, max_batch_slots=3, num_pages=5, clock=lambda: t[0], adapters=reg,
                    constraint_vocab=vocab, **PAGED)
    rng = np.random.RandomState(40)
    shared = rng.randint(0, V, 34).astype(np.int32)
    reqs = [(np.concatenate([shared, rng.randint(0, V, 3).astype(np.int32)]), 40, "a0",
             None, None),  # grows to a third page
            (rng.randint(0, V, 20).astype(np.int32), 60, "a1", None, 5.0),  # expires
            (np.concatenate([shared, rng.randint(0, V, 5).astype(np.int32)]), 3, "a2",
             None, None),  # a third adapter: waits for a page
            (rng.randint(0, V, 8).astype(np.int32), 4, None, r"[0-9]+", None)]
    futs = [eng.submit(p, max_new_tokens=n, adapter_id=a, constraint=c, timeout=to)
            for p, n, a, c, to in reqs]
    for i in range(300):
        if all(f.done() for f in futs) and eng._prefilling is None:
            break
        eng.step()
        assert_balanced(eng)
        if i == 40:
            t[0] = 10.0  # the deadline fires
    assert all(f.done() for f in futs)
    st = eng.stats()
    assert st["adapters"]["pages_pinned"] == 0 and st["kv_pages_in_use"] == 0
    assert st["expired"] == 1 and st["preemptions"] > 0 and st["adapters"]["evictions"] > 0
    with pytest.raises(Exception):
        futs[1].result(timeout=1)
    for (p, n, a, c, _), f in zip(reqs, futs):
        if f is not futs[1]:
            tc = tcon.compile_constraint(c, vocab, EOS) if c else None
            assert f.result(timeout=1) == _solo(tm, p, n, adapter_id=a,
                                                adapters={a: tads[a]} if a else None,
                                                token_mask_fn=tc, **SOLO)


def test_admission_death_releases_adapter(llama, monkeypatch):
    """A prefill that raises after the adapter was pinned fails only that
    request and unpins the adapter; the next request for it gives its solo
    tokens."""
    _, tm = llama
    tads = _adapters(tlora, tm, 1)
    eng = LLMEngine(tm, max_batch_slots=2, adapters=AdapterRegistry.from_adapters(
        tm, tads, rank=4), **dict(PAGED, prefill_chunk=32))
    real, calls = tm.prefill_chunk_step, {"n": 0}

    def poisoned(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected admission fault")
        return real(*a, **kw)

    monkeypatch.setattr(tm, "prefill_chunk_step", poisoned)
    rng = np.random.RandomState(42)
    f1 = eng.submit(rng.randint(0, V, 40).astype(np.int32), max_new_tokens=4, adapter_id="a0")
    eng.step()
    with pytest.raises(RuntimeError, match="injected admission fault"):
        f1.result(timeout=1)
    assert_balanced(eng)
    assert eng.stats()["adapters"]["pages_pinned"] == 0
    p2 = rng.randint(0, V, 12).astype(np.int32)
    got = _pump(eng, [eng.submit(p2, max_new_tokens=4, adapter_id="a0")])[0]
    monkeypatch.undo()
    assert got == _solo(tm, p2, 4, adapter_id="a0", adapters=tads, **SOLO)
