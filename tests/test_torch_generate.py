"""Port parity: paddle_tpu_torch's generate() against the JAX reference's
model.generate on the CPU, in f32, with the same weights.

Greedy tokens must be EQUAL on every cache layout the reference offers
without speculation: static f32, static int8, paged, paged with a shared
prefix, with eos/pad, and with one new token.  The model is the
tile-aligned tiny config of tests/test_torch_engine.py (head dim 128), so
the reference's decode steps run its Pallas kernels in interpret mode
while the port runs the kernels' plain versions.  Sampled tokens differ
between the frameworks (their random streams differ), so sampled runs are
checked for shape, the eos/pad contract and seed determinism.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

DIMS = dict(num_attention_heads=2, num_key_value_heads=1,
            max_position_embeddings=512)


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


def _prompts(B=2, S0=40, seed=0, shared=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 1024, (B, S0)).astype(np.int32)
    ids[:, :shared] = ids[0, :shared]
    return ids


def _both(pair, ids, n, **kw):
    jm, tm = pair
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=n, **kw)._value)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=n, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (ids.shape[0], n)
    return got.numpy(), want


RUNS = {
    "static_f32": (dict(), dict()),
    "static_int8": (dict(), dict(cache_dtype="int8")),
    "paged": (dict(), dict(kv_layout="paged")),
    # 140 shared prompt tokens: page 0 of each row aliases row 0's page
    "paged_share_prefix": (dict(S0=150, shared=140),
                           dict(kv_layout="paged", share_prefix=True)),
    "paged_int8": (dict(), dict(kv_layout="paged", cache_dtype="int8")),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_greedy_tokens_equal_reference(pair, run):
    pk, kw = RUNS[run]
    got, want = _both(pair, _prompts(**pk), 6, **kw)
    np.testing.assert_array_equal(got, want)


def test_eos_then_pad_and_one_token(pair):
    ids = _prompts(B=3, seed=2)
    free, _ = _both(pair, ids, 6)
    eos = int(free[1, 2])  # row 1 stops at its third token
    got, want = _both(pair, ids, 6, eos_token_id=eos, pad_token_id=5)
    np.testing.assert_array_equal(got, want)
    stop = list(got[1]).index(eos)
    assert (got[1, stop + 1:] == 5).all()
    got1, want1 = _both(pair, ids, 1)
    np.testing.assert_array_equal(got1, want1)
    np.testing.assert_array_equal(got1[:, 0], free[:, 0])


def test_sampled_shape_eos_pad_and_seed_determinism(pair):
    _, tm = pair
    ids = torch.from_numpy(_prompts(B=3, seed=4))
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5, top_k=50, top_p=0.95)
    a = tm.generate(ids, generator=torch.Generator().manual_seed(3), **kw)
    b = tm.generate(ids, generator=torch.Generator().manual_seed(3), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (3, 8) and bool(((a >= 0) & (a < 1024)).all())
    eos = int(a[0, 1])
    c = tm.generate(ids, generator=torch.Generator().manual_seed(3), eos_token_id=eos,
                    pad_token_id=7, **kw)
    for row in c.tolist():
        if eos in row:
            assert all(t == 7 for t in row[row.index(eos) + 1:])
    assert c[0, 1] == eos


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(adapter_id="a", adapters={}),
                                dict(token_mask_fn=lambda: None)],
                         ids=["spec_k", "adapter_id", "token_mask_fn"])
def test_unported_options_raise(pair, kw):
    """Every option here is ported since: spec_k in slice 11, so its case
    holds its greedy tokens equal to spec_k=0's
    (tests/test_torch_spec_decode.py holds the rest); LoRA and constraints
    in the multi-tenant slice, whose cases here are invalid (an adapter id missing from
    ``adapters``, a ``token_mask_fn`` that gives no constraint) and raise
    the reference's error (tests/test_torch_multi_tenant.py holds the
    rest)."""
    jm, tm = pair
    ids = torch.from_numpy(_prompts())
    if "spec_k" in kw:
        got = tm.generate(ids, max_new_tokens=2, **kw)
        assert torch.equal(got, tm.generate(ids, max_new_tokens=2))
        return
    with pytest.raises((KeyError, TypeError)) as want:
        jm.generate(paddle.to_tensor(_prompts()), max_new_tokens=2, **kw)
    with pytest.raises(want.type):
        tm.generate(ids, max_new_tokens=2, **kw)


def test_generate_and_dense_engine_agree(pair):
    """The slice as a whole: the same prompts through the port's generate()
    and through its dense engine (bucketed prefill into slots, per-slot
    decode) give identical greedy tokens, as the reference's engine-vs-solo
    parity does."""
    _, tm = pair
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 1024, n).astype(np.int32) for n in (20, 100, 300)]
    eng = LLMEngine(tm, max_batch_slots=2, max_seq_len=512)
    futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_complete()
    for p, f in zip(prompts, futs):
        solo = tm.generate(torch.from_numpy(p[None]), max_new_tokens=6)
        assert f.result() == solo[0].tolist()
