"""Port parity: paddle_tpu_torch's GPT family against the JAX reference's on
the CPU, in f32, with the same weights through the converter.

The tiny config (4 heads of 32, learned positions up to 128): forward
logits within 1e-4 and the loss; every cache layout of ``GPTBlock`` (the
growing (k, v) pair, static plain and int8, paged) through ``generate``,
with and without ``spec_k``; the dense and paged engines, with the prefix
cache off and on and with ``spec_k``.  Greedy tokens must be EQUAL.  The
reference's Pallas kernels run in interpret mode.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch.convert import load_reference_state, to_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM


@pytest.fixture(scope="module")
def pair():
    paddle.seed(9)
    jm = JGPT(JConfig.tiny())
    jm.eval()
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(GPTForCausalLM(GPTConfig.tiny(), device="cpu"), ref)
    return jm, tm.eval(), ref


def test_converter_carries_every_parameter(pair):
    _, tm, ref = pair
    back = to_reference_state(tm)
    assert sorted(back) == sorted(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(back[name], arr)
    assert tm.gpt.h[0].qkv.weight.shape == (3 * 128, 128)  # [out, in]
    assert tm.gpt.wpe.weight.shape == (128, 128)           # not transposed
    bad = dict(ref, extra=ref["lm_head.weight"])
    with pytest.raises(KeyError):
        load_reference_state(GPTForCausalLM(GPTConfig.tiny(), device="cpu"), bad)


def test_forward_logits_and_loss_match_reference(pair):
    jm, tm, _ = pair
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (2, 48)).astype(np.int32)
    labels = rng.randint(0, 1024, (2, 48)).astype(np.int32)
    labels[0, :5] = -100
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels).long())
    assert np.abs(logits.numpy() - np.asarray(jlogits._value)).max() <= 1e-4
    assert abs(float(loss) - float(np.asarray(jloss._value))) <= 1e-5


def test_growing_cache_steps_match_reference(pair):
    """The legacy growing (k, v) cache: a prefill then a 4-token step whose
    queries attend their past through the explicit causal mask."""
    jm, tm, _ = pair
    ids = np.random.RandomState(1).randint(0, 1024, (2, 20)).astype(np.int32)
    jl, jc = jm.generate_step(paddle.to_tensor(ids[:, :16]))
    with torch.no_grad():
        tl, tc = tm.generate_step(torch.from_numpy(ids[:, :16]))
        for lo, hi in ((16, 20),):
            jl, jc = jm.generate_step(paddle.to_tensor(ids[:, lo:hi]), caches=jc)
            tl, tc = tm.generate_step(torch.from_numpy(ids[:, lo:hi]), caches=tc)
            assert np.abs(tl.numpy() - np.asarray(jl._value)).max() <= 1e-4
    assert tc[0][0].shape == (2, 20, 4, 32)


@pytest.mark.parametrize("kw", [dict(), dict(cache_dtype="int8"), dict(kv_layout="paged"),
                                dict(spec_k=3), dict(cache_dtype="int8", spec_k=3),
                                dict(kv_layout="paged", spec_k=3)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "static")
def test_generate_tokens_equal_reference(pair, kw):
    jm, tm, _ = pair
    rng = np.random.RandomState(2)
    base = rng.randint(0, 1024, (2, 12)).astype(np.int32)
    ids = np.concatenate([base, base[:, :6]], axis=1)
    kw = dict(kw, max_new_tokens=8, page_size=32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), **kw)._value)
    got = tm.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()


ENGINES = {
    "dense": dict(max_batch_slots=2, max_seq_len=128, decode_chunk=2),
    "dense_spec": dict(max_batch_slots=2, max_seq_len=128, spec_k=3),
    "paged": dict(max_batch_slots=2, max_seq_len=128, kv_layout="paged", page_size=32,
                  prefill_chunk=16, prefix_cache=False),
    "paged_prefix": dict(max_batch_slots=2, max_seq_len=128, kv_layout="paged",
                         page_size=32, prefill_chunk=16),
    "paged_prefix_spec": dict(max_batch_slots=2, max_seq_len=128, kv_layout="paged",
                              page_size=32, prefill_chunk=16, spec_k=3),
}


@pytest.mark.parametrize("run", sorted(ENGINES))
def test_engine_tokens_equal_reference(pair, run):
    """Shared-prefix prompts off the page grid (37 tokens) so the cache's
    partial tails and forks occur; tokens and the prefix and spec stats
    equal the reference engine's."""
    jm, tm, _ = pair
    rng = np.random.RandomState(52)
    head = rng.randint(0, 1024, 37).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(0, 1024, t).astype(np.int32)])
               for t in (6, 4, 9)] + [rng.randint(0, 1024, 21).astype(np.int32)]
    out = {}
    for cls, m in ((JEngine, jm), (LLMEngine, tm)):
        eng = cls(m, **ENGINES[run])
        futs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_complete()
        out[cls] = [f.result() for f in futs], eng.stats()
    got, st = out[LLMEngine]
    want, jst = out[JEngine]
    assert got == want
    if "prefix" in run:
        assert st["prefix_cache"]["hit_tokens"] == jst["prefix_cache"]["hit_tokens"] > 0
        assert st["prefix_cache"]["cow_copies"] == jst["prefix_cache"]["cow_copies"]
    if "spec" in run:
        assert st["spec"] == jst["spec"]


def test_tensor_parallel_raises_naming_the_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        GPTForCausalLM(GPTConfig.tiny(tensor_parallel=True), device="cpu")
