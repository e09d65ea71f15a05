"""Port parity: paddle_tpu_torch's LLaMA against the JAX reference on the
CPU, in f32, with the same weights (carried by paddle_tpu_torch.convert).

The model is the tile-aligned tiny config of
tests/test_ragged_attention_engine.py (hidden 256, 2 heads, 1 kv head,
head dim 128), so the reference's paged path runs its Pallas kernel (in
interpret mode) while the port runs its plain paged attention.

Tolerance: logits within 1e-4 absolute and relative.  Both sides compute in
f32; the difference is summation order through two layers of 256-wide
matmuls and a 1024-way head, which stays near 1e-6 relative.  With int8
pools the reference's Pallas kernel rounds its probabilities to bf16 (a
~4e-3 relative step) where the plain versions do not, so the int8 model
run is held against the reference's own plain paged path (its
``_FORCE_PATH = "dense"`` test hook); the kernel itself is compared at the
attention level in tests/test_torch_paged_attention.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu.tensor.tensor import Tensor
from paddle_tpu_torch.convert import convert_state_dict, load_reference_state
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           _rope_cache, apply_rope)

TOL = 1e-4
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
    return jm, tm, ref


def test_converter_names_and_layouts(pair):
    jm, tm, ref = pair
    port = tm.state_dict()
    assert set(port) == set(ref)
    w = "llama.layers.0.self_attn.q_proj.weight"
    np.testing.assert_array_equal(port[w].numpy(), ref[w].T)  # [in,out]->[out,in]
    for name in ("llama.embed_tokens.weight", "llama.norm.weight"):
        np.testing.assert_array_equal(port[name].numpy(), ref[name])
    np.testing.assert_array_equal(port["lm_head.weight"].numpy(),
                                  ref["lm_head.weight"].T)
    bad = dict(ref)
    bad[w] = ref[w][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_state_dict(bad, tm)
    with pytest.raises(KeyError):
        convert_state_dict({k: v for k, v in ref.items() if k != w}, tm)


def test_rope_matches_reference_per_slot_offsets():
    from paddle_tpu.models.llama import _rope_cache as j_rope_cache
    from paddle_tpu.models.llama import apply_rope as j_apply_rope

    cos, sin = _rope_cache(128, 64, 10000.0)
    jcos, jsin = j_rope_cache(128, 64, 10000.0)
    np.testing.assert_array_equal(cos, np.asarray(jcos))
    x = np.random.RandomState(0).randn(3, 4, 2, 128).astype(np.float32)
    off = np.array([0, 7, 30], np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                     torch.from_numpy(sin), torch.from_numpy(off))
    want = j_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got5 = apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                      torch.from_numpy(sin), 5)
    want5 = j_apply_rope(jnp.asarray(x), jcos, jsin, 5)
    np.testing.assert_allclose(got5.numpy(), np.asarray(want5), rtol=1e-6, atol=1e-6)


def test_full_forward_logits(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(1).randint(0, 1024, (2, 37)).astype(np.int32)
    with tape.no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _pools(nl, P, ps, quant):
    shape = (P, 1, ps, 128)
    if quant:
        return [(np.zeros(shape, np.int8), np.zeros(shape, np.int8),
                 np.full(shape[:3], 1e-8, np.float32),
                 np.full(shape[:3], 1e-8, np.float32)) for _ in range(nl)]
    return [(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
            for _ in range(nl)]


def _j_caches(pools, pos, tbl):
    return [(Tensor(jnp.asarray(c[0])), Tensor(jnp.asarray(c[1])), jnp.asarray(pos),
             Tensor(jnp.asarray(tbl))) + tuple(Tensor(jnp.asarray(x)) for x in c[2:])
            for c in pools]


def _j_pools(new_caches):
    out = []
    for c in new_caches:
        vals = tuple(np.asarray(x._value if isinstance(x, Tensor) else x) for x in c)
        out.append((vals[0], vals[1]) + vals[4:])
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_paged_prefill_chunks_then_decode(pair, quant):
    """Two slots prefill a 200-token prompt in two 128-token chunks (the
    last one pad-padded, logits at last_index), then decode 3 steps at
    per-slot positions over the paged pools — logits at every step match
    the reference, and the pools match after the run."""
    jm, tm, _ = pair
    jda._FORCE_PATH = "dense" if quant else None
    try:
        _prefill_then_decode(jm, tm, quant)
    finally:
        jda._FORCE_PATH = None


def _prefill_then_decode(jm, tm, quant):
    C, ps, P, n = 128, 128, 9, 200
    rng = np.random.RandomState(2)
    prompts = rng.randint(0, 1024, (2, n)).astype(np.int64)
    tbl = np.array([[1, 3, 5, 0], [2, 4, 6, 0]], np.int32)
    j_pools = _pools(2, P, ps, quant)
    t_pools = [tuple(torch.from_numpy(x.copy()) for x in c) for c in j_pools]
    for b in range(2):
        for done in range(0, n, C):
            m = min(C, n - done)
            chunk = np.zeros((1, C), np.int64)
            chunk[0, :m] = prompts[b, done:done + m]
            with tape.no_grad():
                jl, jc = jm.prefill_chunk_step(
                    Tensor(jnp.asarray(chunk.astype(np.int32))),
                    _j_caches(j_pools, np.array([done], np.int32), tbl[b:b + 1]),
                    jnp.asarray(m - 1, jnp.int32))
            j_pools = _j_pools(jc)
            with torch.no_grad():
                tl, _ = tm.prefill_chunk_step(
                    torch.from_numpy(chunk),
                    [(c[0], c[1], torch.tensor([done]), torch.from_numpy(tbl[b:b + 1]))
                     + tuple(c[2:]) for c in t_pools], m - 1)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                                       rtol=TOL, atol=TOL)
    pos = np.array([n, n], np.int32)
    tok = prompts[:, -1:] % 7
    for _ in range(3):
        with tape.no_grad():
            jl, jc = jm.generate_step(Tensor(jnp.asarray(tok.astype(np.int32))),
                                      caches=_j_caches(j_pools, pos, tbl))
        j_pools = _j_pools(jc)
        with torch.no_grad():
            tl, _ = tm.generate_step(
                torch.from_numpy(tok),
                caches=[(c[0], c[1], torch.from_numpy(pos), torch.from_numpy(tbl))
                        + tuple(c[2:]) for c in t_pools])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value), rtol=TOL, atol=TOL)
        tok = tl.numpy()[:, -1].argmax(-1)[:, None].astype(np.int64)
        pos = pos + 1
    for jc_, tc_ in zip(j_pools, t_pools):
        for a, b in zip(jc_, tc_):
            live = slice(1, None)  # page 0 holds the padded tail's garbage
            if quant and a.dtype == np.int8:
                # a rounding-edge element may quantize one step apart
                assert np.abs(a[live].astype(int) - b.numpy()[live]).max() <= 1
            else:
                np.testing.assert_allclose(b.numpy()[live], a[live], rtol=TOL, atol=TOL)


def test_unported_options_raise(pair):
    """What still raises; and ``labels=``, which no longer does: the port's
    (loss, logits) equal the reference's (no shift, -100 ignored)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=True), device="cpu")
    jm, tm_, _ = pair
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 1024, (2, 16)).astype(np.int64)
    labels = rng.randint(0, 1024, (2, 16)).astype(np.int64)
    labels[1, 3:9] = -100
    jloss, jlogits = jm(Tensor(jnp.asarray(ids)), labels=Tensor(jnp.asarray(labels)))
    loss, logits = tm_(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._value),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(loss.detach()), float(np.asarray(jloss._value)), rtol=TOL)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int64)
    # a static cache takes no external attention mask (nor does a paged one)
    cfg = tm.config
    static = (torch.zeros(1, cfg.num_key_value_heads, 128, 32),
              torch.zeros(1, cfg.num_key_value_heads, 128, 32), 0)
    with pytest.raises(NotImplementedError, match="external attention mask"):
        tm.llama(ids, attn_mask=torch.ones(4, 4, dtype=torch.bool),
                 caches=[static, static])
    assert tkv.TRASH_PAGE == 0
