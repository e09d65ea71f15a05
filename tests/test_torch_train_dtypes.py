"""Port parity of the attention backward at float16: the plain backward
versions (what a CPU tensor runs, and the CUDA-core kernels' oracle in
chip_smoke.py) against the reference's Pallas backward kernels in interpret
mode, with the same float16 inputs and cotangents from numpy.

* flash (``_flash_bwd_dense`` against jax.vjp through ``_dq_kernel`` and
  ``_dkv_kernel``): causal at Sq = Sk, causal at Sq < Sk (bottom-right
  aligned), and the lse cotangent of ``flash_attention_with_lse``;
* the encoder (``_encoder_bwd_dense`` against jax.vjp through
  ``_bwd_kernel``) at rate 0, full and causal.

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


FLASH_CASES = {"causal_sq_eq_sk": (128, 128, True, False),
               "causal_sq_lt_sk": (128, 256, True, False),
               "causal_dlse": (128, 128, True, True)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_f16_flash_backward_matches_reference_kernels(case):
    """``_flash_bwd_dense`` at float16 on the port's forward outputs against
    jax.vjp of the reference's flash kernels at float16: dQ, dK and dV
    within FLASH_GRAD_TOL of max, dV's P rounded to float16 as ``_dkv_kernel``
    rounds it (:184)."""
    Sq, Sk, causal, with_dlse = FLASH_CASES[case]
    q, k, v, do = _inputs(1, Sq, Sk, 2, 64, seed=Sq + Sk + with_dlse, q_std=2.0)
    dlse = np.random.RandomState(11).randn(1, 2, Sq).astype(np.float32)

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
    scale = 1.0 / 64 ** 0.5
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
