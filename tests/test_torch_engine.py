"""Port parity: paddle_tpu_torch's LLMEngine, paged and dense, against the
JAX reference engine on the CPU, in f32, with the same weights.

Greedy tokens must be EQUAL, request by request.  Paged: more requests
than slots, prompts spanning several prefill chunks and pages, plain and
int8 pools, a page pool small enough to force a recompute preemption, and
``decode_chunk=4`` across page boundaries.  Dense: prompts in every prompt
bucket and past them, slot reuse, an int8 cache, and ``decode_chunk=4``
with an eos mid-chunk.  The reference engine runs its Pallas kernels in
interpret mode.  Sampled
tokens differ between the frameworks (their random streams differ), so the
sampler is checked through ``mask_logits`` numerically and by where its
draws land.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.ops import sampling as jsampling
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine, ServerOverloadedError
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import sampling as tsampling

DIMS = dict(num_attention_heads=2, num_key_value_heads=1,
            max_position_embeddings=512)
ENGINE = dict(max_batch_slots=2, max_seq_len=512, kv_layout="paged",
              page_size=128, prefill_chunk=128, prefix_cache=False)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(**DIMS))
    jm.eval()
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(
        LlamaForCausalLM(LlamaConfig.tiny(**DIMS), device="cpu"), ref)
    tm.eval()
    return jm, tm


def _serve(engine_cls, model, prompts, max_new, **kw):
    eng = engine_cls(model, **{**ENGINE, **kw})
    futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_complete()
    return [f.result() for f in futs], eng


RUNS = {
    # 4 requests on 2 slots; 250/300-token prompts take 2-3 chunks and pages
    "plain": (dict(), (250, 60, 300, 130), 8),
    "int8": (dict(cache_dtype="int8"), (250, 60, 300, 130), 8),
    # 4 allocatable pages: both 240-token slots fill the pool, and crossing
    # position 256 preempts one (requeued, re-prefilled, then resumed)
    "preempt": (dict(num_pages=5), (250, 240, 40), 12),
    # 384 positions and 256-token chunks: the second chunk of the 300-token
    # prompt pads past the page table (rows 384..511)
    "chunk_past_table": (dict(max_seq_len=300, prefill_chunk=256), (300, 200), 8),
    # 4 decode steps per tick: the 120- and 250-token slots cross pages
    # 128 and 256 inside a tick
    "decode_chunk4": (dict(decode_chunk=4), (120, 250), 11),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_greedy_tokens_equal_reference_engine(pair, run):
    jm, tm = pair
    kw, lens, max_new = RUNS[run]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 1024, n).astype(np.int32) for n in lens]
    want, _ = _serve(JEngine, jm, prompts, max_new, **kw)
    got, eng = _serve(LLMEngine, tm, prompts, max_new, **kw)
    assert got == want
    st = eng.stats()
    assert st["completed"] == len(prompts)
    assert st["kv_pages_in_use"] == 0  # every page came back
    if run == "preempt":
        assert st["preemptions"] >= 1 and st["recompute_tokens"] > 0


DENSE = dict(max_batch_slots=2, max_seq_len=512)
DENSE_RUNS = {
    # 5 requests on 2 slots, so slots are reused: one prompt in each bucket
    # (32, 64, 128, 256) and one past them (the L = 512 bucket)
    "buckets": (dict(), (20, 50, 100, 200, 300), 6),
    "int8": (dict(cache_dtype="int8"), (50, 300), 6),
    "decode_chunk4": (dict(decode_chunk=4), (20, 100), 10),
}


@pytest.mark.parametrize("run", sorted(DENSE_RUNS))
def test_dense_greedy_tokens_equal_reference_engine(pair, run):
    jm, tm = pair
    kw, lens, max_new = DENSE_RUNS[run]
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, 1024, n).astype(np.int32) for n in lens]
    jeng = JEngine(jm, **DENSE, **kw)
    jfuts = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run_until_complete()
    eng = LLMEngine(tm, **DENSE, **kw)
    futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_complete()
    assert [f.result() for f in futs] == [f.result() for f in jfuts]
    st = eng.stats()
    assert st["kv_layout"] == "dense" and st["completed"] == len(prompts)
    assert st["prefill_buckets"] == {eng._bucket(n): 1 for n in lens}


def test_dense_decode_chunk_stops_at_eos_mid_chunk(pair):
    """decode_chunk=4 with an eos inside the second chunk: the surplus
    tokens of the chunk are dropped, as in the reference."""
    jm, tm = pair
    prompt = np.random.RandomState(9).randint(1, 1024, 40).astype(np.int32)
    base = LLMEngine(tm, **DENSE).generate(prompt, max_new_tokens=10)
    eos = base[5]
    want = JEngine(jm, **DENSE, decode_chunk=4, eos_token_id=eos).generate(
        prompt, max_new_tokens=10)
    got = LLMEngine(tm, **DENSE, decode_chunk=4, eos_token_id=eos).generate(
        prompt, max_new_tokens=10)
    assert got == want == base[:base.index(eos) + 1]


def test_pool_too_small_is_rejected(pair):
    _, tm = pair
    eng = LLMEngine(tm, **ENGINE, num_pages=2)
    fut = eng.submit(np.arange(1, 200, dtype=np.int32), max_new_tokens=2)
    eng.run_until_complete()
    with pytest.raises(ServerOverloadedError):
        fut.result()


def _knobs():
    rng = np.random.RandomState(5)
    logits = (rng.randn(6, 64) * 2).astype(np.float32)
    logits[3, 10] = logits[3, 11] = 9.0  # a tie at the top-k threshold
    temp = np.array([1.0, 0.7, 1.3, 1.0, 0.5, 2.0], np.float32)
    top_k = np.array([0, 5, 0, 2, 64, 10], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 1.0, 0.5, 0.8], np.float32)
    mask = rng.rand(6, 64) > 0.3
    return logits, temp, top_k, top_p, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_mask_logits_matches_reference(with_mask):
    logits, temp, top_k, top_p, mask = _knobs()
    m = mask if with_mask else None
    want = np.asarray(jsampling.mask_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), None if m is None else jnp.asarray(m)))
    got = tsampling.mask_logits(
        torch.from_numpy(logits), torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p), None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_sample_rows_stays_inside_the_mask():
    logits, temp, top_k, top_p, _ = _knobs()
    do_s = np.array([False, True, True, False, True, True])
    allowed = np.isfinite(np.asarray(jsampling.mask_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p))))
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy
    for _ in range(20):
        ids = tsampling.sample_rows(t(logits), gen, t(do_s), t(temp), t(top_k),
                                    t(top_p)).numpy()
        for b in range(6):
            if do_s[b]:
                assert allowed[b, ids[b]]
            else:
                assert ids[b] == int(np.argmax(logits[b]))
    want = np.asarray(jsampling.sample_rows(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(do_s),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))
    assert (ids[~do_s] == want[~do_s]).all()  # greedy rows agree exactly


def test_sampled_requests_finish_with_valid_ids(pair):
    _, tm = pair
    eng = LLMEngine(tm, **ENGINE, generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(9)
    futs = [eng.submit(rng.randint(1, 1024, n), max_new_tokens=6, do_sample=True,
                       temperature=0.8, top_p=0.9) for n in (30, 140, 70)]
    eng.start()
    try:
        outs = [f.result(timeout=60) for f in futs]
    finally:
        eng.stop()
    assert all(len(o) == 6 and all(0 <= t < 1024 for t in o) for o in outs)


@pytest.mark.parametrize("kw", [
    dict(kv_layout=None, spec_k=2), dict(kv_layout="dense", adapters=[]),
    dict(prefix_cache=None), dict(prefix_cache=True), dict(spec_k=2),
    dict(adapters=[]), dict(host_cache_pages=4), dict(metrics_port=0),
    dict(kv_layout=None, metrics_port=0)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_engine_options_raise(pair, kw):
    _, tm = pair
    args = {**ENGINE, **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine(tm, **args)


def test_threaded_submitters_count_every_call(pair):
    """Eight threads submit at once against a running pump and a queue
    small enough to shed: every accepted call counts as submitted, and shed
    plus submitted is every attempt."""
    import threading

    _, tm = pair
    eng = LLMEngine(tm, **ENGINE, max_queue_len=2).start()
    accepted, shed, futures = [0] * 8, [0] * 8, [[] for _ in range(8)]
    go = threading.Barrier(8)

    def submitter(i):
        go.wait()
        for n in range(25):
            try:
                futures[i].append(eng.submit(np.arange(1, 4 + (i + n) % 5), max_new_tokens=1))
                accepted[i] += 1
            except ServerOverloadedError:
                shed[i] += 1

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for f in (f for fs in futures for f in fs):
            f.result(timeout=120)
    finally:
        eng.stop()
    stats = eng.stats()
    assert sum(shed) > 0 and sum(accepted) > 0
    assert stats["submitted"] == sum(accepted)
    assert stats["shed"] == sum(shed)
    assert stats["shed"] + stats["submitted"] == 8 * 25
