"""Port parity of the attention backward at float16: the plain backward
versions (what a CPU tensor runs, and the CUDA-core kernels' oracle in
chip_smoke.py) against the reference's Pallas backward kernels in interpret
mode, with the same float16 inputs and cotangents from numpy.

* flash (``_flash_bwd_dense`` against jax.vjp through ``_dq_kernel`` and
  ``_dkv_kernel``): causal at Sq = Sk, causal at Sq < Sk (bottom-right
  aligned), and the lse cotangent of ``flash_attention_with_lse``;
* the encoder (``_encoder_bwd_dense`` against jax.vjp through
  ``_bwd_kernel``) at rate 0, full and causal, at S = 128 and, with the
  forward, at S = 256, D = 128 (the streamed kernels' regime);
* flash at head dim 256 too, the range the D = 256 backward kernels take;
* the two paths the D = 256 and float16 kernels serve, at a tiny size: a
  LLaMA with one head of 256 through TrainStep against the reference's
  (f32, flash forced on both sides), and a BERT at float16 through the
  fused LN's plain version against the reference's float16 forward.

Tolerance, of max |want| for each of dQ, dK, dV: both sides take their
products in f32 on the same float16 values and round dS (and flash's P for
dV) to float16 in the same places, then write float16 (2^-11 of an
element); the f32 sums run in other orders, so a value near a float16
rounding boundary may round the other way on one side (ENCODER_GRAD_TOL;
measured at most 4.0e-4).  Flash also takes each side's own forward output:
the two O differ in their float16 rounding, and dsum = rowsum(dO * O)
carries that into every dS (FLASH_GRAD_TOL; measured at most 1.5e-3).

The rounding rules themselves are pinned by exact equality: the plain dV
equals the reference's bit for bit in at least EXACT_SHARE of its elements,
while the same backward with the other rule for dV's P (flash: P left in
f32; the encoder: P rounded to float16) matches in at most OTHER_SHARE.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import encoder_attention as jea
from paddle_tpu_torch.ops import encoder_attention as tea
from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
FLASH_GRAD_TOL = 5e-3
ENCODER_GRAD_TOL = 2e-3
EXACT_SHARE = 0.99
OTHER_SHARE = 0.9


def _inputs(B, Sq, Sk, H, D, seed, q_std=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, Sq, H, D) * q_std).astype(np.float16)
    k, v = (rng.randn(B, Sk, H, D).astype(np.float16) for _ in range(2))
    do = rng.randn(B, Sq, H, D).astype(np.float16)
    return q, k, v, do


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


def _exact_share(got, want):
    return float(np.mean(np.asarray(got, np.float16) == np.asarray(want, np.float16)))


def _t(a):
    return torch.from_numpy(np.array(a))


# (Sq, Sk, causal, with_dlse, D, H): head dim 64, and 256 (the D = 256
# backward kernels' range) at one head
FLASH_CASES = {"causal_sq_eq_sk": (128, 128, True, False, 64, 2),
               "causal_sq_lt_sk": (128, 256, True, False, 64, 2),
               "causal_dlse": (128, 128, True, True, 64, 2),
               "d256_causal": (128, 128, True, False, 256, 1),
               "d256_full_sq_lt_sk": (128, 256, False, False, 256, 1),
               "d256_causal_sq_lt_sk_dlse": (128, 256, True, True, 256, 1)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_f16_flash_backward_matches_reference_kernels(case):
    """``_flash_bwd_dense`` at float16 on the port's forward outputs against
    jax.vjp of the reference's flash kernels at float16: dQ, dK and dV
    within FLASH_GRAD_TOL of max, dV's P rounded to float16 as ``_dkv_kernel``
    rounds it (:184)."""
    Sq, Sk, causal, with_dlse, D, H = FLASH_CASES[case]
    q, k, v, do = _inputs(1, Sq, Sk, H, D, seed=Sq + Sk + with_dlse, q_std=2.0)
    dlse = np.random.RandomState(11).randn(1, H, Sq).astype(np.float32)

    def ref(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=causal, interpret=True)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    cot = (jnp.asarray(do), jnp.asarray(dlse if with_dlse else np.zeros_like(dlse)))
    want = [np.asarray(g) for g in vjp(cot)]
    assert all(w.dtype == np.float16 for w in want)

    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    outs, cots = [o], [_t(do)]
    if with_dlse:
        outs.append(lse)
        cots.append(_t(dlse))
    got = torch.autograd.grad(outs, (tq, tk, tv), cots)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float16
        assert _rel(g.numpy(), w) <= FLASH_GRAD_TOL, f"d{name}"

    # the rule for dV: P rounded to float16 (the plain version) matches the
    # reference bit for bit; P left in f32 does not
    scale = 1.0 / D ** 0.5
    o, lse = (t.detach() for t in (o, lse))
    dl = _t(dlse) if with_dlse else None
    p = torch.exp(tfa._scores(tq.detach(), tk.detach(), causal, scale) - lse[..., None])
    dv_f32_p = torch.einsum("bhqk,bqhd->bkhd", p, _t(do).float()).half()
    assert _exact_share(got[2].numpy(), want[2]) >= EXACT_SHARE
    assert _exact_share(dv_f32_p.numpy(), want[2]) <= OTHER_SHARE
    assert tfa._flash_bwd_dense(tq.detach(), tk.detach(), tv.detach(), o, lse, _t(do), causal,
                                scale, dl)[2].equal(got[2])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_f16_encoder_backward_matches_reference_kernel(causal):
    """``_encoder_bwd_dense`` at float16, rate 0, against jax.vjp of the
    reference's ``_bwd_kernel`` at float16: dQ, dK and dV within
    ENCODER_GRAD_TOL of max.  The reference widens dO to f32 and takes dV =
    P_d^T dO with P_d in f32 (:109, :121-123), unlike flash: the plain dV
    matches it bit for bit, a dV from P rounded to float16 does not."""
    q, k, v, do = _inputs(1, 128, 128, 2, 64, seed=21 + causal, q_std=2.0)

    def ref(q, k, v):
        return jea.encoder_attention(q, k, v, causal=causal)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    assert all(w.dtype == np.float16 for w in want)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = tea.encoder_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float16
        assert _rel(g.numpy(), w) <= ENCODER_GRAD_TOL, f"d{name}"

    p = tea._probs(tq.detach(), tk.detach(), 1.0 / 64 ** 0.5, causal)
    dv_f16_p = torch.einsum("bhqk,bqhd->bkhd", p.half().float(), _t(do).float()).half()
    assert _exact_share(got[2].numpy(), want[2]) >= EXACT_SHARE
    assert _exact_share(dv_f16_p.numpy(), want[2]) <= OTHER_SHARE


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_f16_encoder_streamed_regime_matches_reference_kernel(causal):
    """The plain float16 encoder forward and backward at S = 256, D = 128
    (the shapes the card's streamed kernels take: the two-pass forward and
    the row and column backward from the forward's lse), rate 0, against
    the reference's ``encoder_attention`` at float16 and jax.vjp of it
    (Pallas in interpret mode): the output and dQ, dK and dV within
    ENCODER_GRAD_TOL of max (both sides round P and dS to float16 in the
    same places and write float16: one unit is 2^-11 of a value), and the
    output and dV equal bit for bit in at least EXACT_SHARE of their
    elements, while a dV from P rounded to float16 matches in at most
    OTHER_SHARE."""
    q, k, v, do = _inputs(1, 256, 256, 2, 128, seed=31 + causal, q_std=2.0)

    def ref(q, k, v):
        return jea.encoder_attention(q, k, v, causal=causal)

    want_o, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    assert np.asarray(want_o).dtype == np.float16 and all(w.dtype == np.float16 for w in want)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = tea.encoder_attention(tq, tk, tv, causal=causal)
    assert o.dtype == torch.float16
    assert _rel(o.detach().numpy(), want_o) <= ENCODER_GRAD_TOL
    assert _exact_share(o.detach().numpy(), want_o) >= EXACT_SHARE
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float16
        assert _rel(g.numpy(), w) <= ENCODER_GRAD_TOL, f"d{name}"
    p = tea._probs(tq.detach(), tk.detach(), 1.0 / 128 ** 0.5, causal)
    dv_f16_p = torch.einsum("bhqk,bqhd->bkhd", p.half().float(), _t(do).float()).half()
    assert _exact_share(got[2].numpy(), want[2]) >= EXACT_SHARE
    assert _exact_share(dv_f16_p.numpy(), want[2]) <= OTHER_SHARE


# ------------------------------------------ the slices' paths at a tiny size

LLAMA_STEPS, LLAMA_B, LLAMA_S = 2, 2, 64
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4  # of each tensor's max |p|, as test_torch_train_step.py


def _flash_sdpa(monkeypatch, module):
    """Route ``module.scaled_dot_product_attention`` to backend="flash" (the
    reference's SDPA sends D = 256 to its dense path below S = 1024)."""
    sdpa = module.scaled_dot_product_attention

    def flash(*a, backend=None, **kw):
        return sdpa(*a, backend="flash", **kw)

    monkeypatch.setattr(module, "scaled_dot_product_attention", flash)


def test_llama_head_dim_256_train_step_matches_reference(monkeypatch):
    """A tiny LLaMA with one head of 256 (Gemma-2B's head dim) through
    TrainStep + AdamW, flash attention forced on both sides: the port's
    plain D = 256 backward (what the card's D = 256 kernels compute) against
    the reference's Pallas kernels in interpret mode under its TrainStep, in
    f32.  The losses of both steps within LOSS_RTOL, the parameters after
    them within PARAM_ATOL of each tensor's max |p|."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch import jit as tjit
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_reference_state, to_reference_state
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as TF

    dims = dict(num_attention_heads=1, num_key_value_heads=1)
    paddle.seed(5)
    jm = JLlama(JConfig.tiny(tensor_parallel=False, **dims))
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(**dims), device="cpu"), ref)
    assert tm.config.hidden_size // tm.config.num_attention_heads == 256
    _flash_sdpa(monkeypatch, JF)
    _flash_sdpa(monkeypatch, TF)
    calls, jcalls = [], []
    bwd, jflash = tfa._flash_bwd_dense, jfa.flash_attention
    monkeypatch.setattr(tfa, "_flash_bwd_dense", lambda *a: calls.append(a[0].shape) or bwd(*a))
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda q, *a, **kw: jcalls.append(q.shape) or jflash(q, *a, **kw))
    jstep = paddle.jit.TrainStep(
        jm, lambda ids, labels: jm(ids, labels=labels)[0],
        paddle.optimizer.AdamW(3e-4, parameters=jm.parameters(), weight_decay=0.01))
    tstep = tjit.TrainStep(tm, lambda ids, labels: tm(ids, labels=labels)[0],
                           topt.AdamW(3e-4, weight_decay=0.01))
    rng = np.random.RandomState(7)
    for _ in range(LLAMA_STEPS):
        ids, labels = (rng.randint(0, 1024, (LLAMA_B, LLAMA_S)).astype(np.int64)
                       for _ in range(2))
        want = float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
        got = float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    n_layers = tm.config.num_hidden_layers
    assert calls == [(LLAMA_B, LLAMA_S, 1, 256)] * (n_layers * LLAMA_STEPS)
    assert jcalls and set(jcalls) == {(LLAMA_B, LLAMA_S, 1, 256)}  # traced once a layer
    got = to_reference_state(tm)
    for k, v in jm.state_dict().items():
        w = np.asarray(v._value)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_ATOL * np.abs(w).max(),
                                   err_msg=k)


# The float16 BERT forward against the reference's at float16: both round
# every activation to float16, the port through the fused LN's plain
# version (the card's kernel math: LN statistics and affine in f32, one
# rounding), the reference through its composed LN on the CPU (the
# normalised value rounded, then the affine in float16), so they differ by
# a few float16 units of each layer's output: BERT_F16_TOL of max |want|
# (float16's 2^-10 times 8).
BERT_F16_TOL = 8 * 2.0 ** -10


def test_bert_float16_forward_through_fused_ln_matches_reference(monkeypatch):
    """A tiny BERT at float16: the port's encoder layers run the fused
    dropout + add + LN at float16 (its routing forced on the CPU, where it
    takes the plain version), against the reference's BertModel cast to
    float16; sequence and pooled outputs within BERT_F16_TOL of max."""
    import paddle_tpu as paddle
    from paddle_tpu.models.bert import BertConfig as JConfig
    from paddle_tpu.models.bert import BertModel as JBert
    from paddle_tpu_torch.convert import load_reference_state
    from paddle_tpu_torch.models import BertConfig, BertModel
    from paddle_tpu_torch.nn.functional import norm
    from paddle_tpu_torch.ops import fused_ln as tfl

    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(2)
    jb = JBert(JConfig.tiny(**no_drop))
    state = {k: np.asarray(v._value) for k, v in jb.state_dict().items()}
    jb.half()
    jb.eval()
    tb = load_reference_state(BertModel(BertConfig.tiny(**no_drop), device="cpu",
                                        dtype=torch.float16), state)
    tb.eval()
    assert next(tb.parameters()).dtype == torch.float16
    monkeypatch.setattr(norm, "_use_fused_kernel",
                        lambda x, w, b, n, h: w is not None and b is not None
                        and tfl.supported(n, h))
    calls = []
    dense = tfl._fused_ln_dense
    monkeypatch.setattr(tfl, "_fused_ln_dense",
                        lambda x, *a, **k: calls.append(x.dtype) or dense(x, *a, **k))
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 1024, (2, 128)).astype(np.int32)
    seg = (rng.rand(2, 128) > 0.5).astype(np.int32)
    jseq, jpool = jb(paddle.to_tensor(ids), paddle.to_tensor(seg))
    with torch.no_grad():
        tseq, tpool = tb(torch.from_numpy(ids), torch.from_numpy(seg))
    assert calls == [torch.float16] * (2 * tb.config.num_hidden_layers)
    for got, want, name in ((tseq, jseq, "sequence"), (tpool, jpool, "pooled")):
        assert got.dtype == torch.float16, name
        want = np.asarray(want._value, np.float32)
        assert str(jseq._value.dtype) == "float16"
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert np.isfinite(got.float().numpy()).all() and err <= BERT_F16_TOL, (name, err)
