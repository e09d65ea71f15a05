"""Port parity at float16 and float32: the attention forward kernels'
plain versions and the admission by type of every attention kernel.

On the card every attention kernel runs on the tensor cores at
bfloat16, float16 and float32 (float32 as split-bf16 products): flash and
the encoder, forward and backward (``csrc/flash_attention.cu``,
``flash_attention_bwd.cu``, ``encoder_attention.cu``,
``encoder_attention_bwd.cu``), and decode and paged
(``csrc/decode_attention.cu``, ``paged_attention.cu``, one body in
``kv_attention.cuh``) at every (q, cache) pair it is built for.  Which
instantiation a call runs is ``ops/_admit.admit``'s decision.  Here, on
the CPU, the tests hold:

* the plain decode, paged, encoder-forward and flash-forward functions at
  float16 (what a CPU tensor runs, and the kernels' oracle in
  chip_smoke.py) against the reference's Pallas kernels in interpret mode
  at float16.  Tolerance 1e-2 of max |out| (plain paths) and 4e-3 (the
  split model): both sides round p to float16 (2^-11) and the output to
  float16, and the plain decode and paged versions score in float16 (their
  einsum of float16 tensors), which the kernels do not;
* the plain model of the kernels' int8 arithmetic (``_split_merge_dense``:
  scores from the int8 cache widened exactly, p rounded to bfloat16 after
  the v-scale) with float32 and float16 q against the reference's kernels,
  within the reference's own int8 bound, 3e-4 (tests/test_decode_attention.py);
* the admission lists against the ``KV_*`` instantiation lists of
  ``kv_attention.cuh`` and the ``FLASH_*`` and ``ENCODER_*`` lists of the
  flash and encoder sources, their type codes one table
  (``_admit.TC_TYPE_CODES``; the decode and paged entries'
  ``_admit.KV_TYPE_CODES`` agree with it on the float types);
* float64 q refused, naming the admitted types; every float32 and float16
  flash and encoder call, forward and backward, admitted to the
  tensor-core kernels, flash at head dims 64, 128 and 256 at every type
  (the encoder at 64 and 128), every decode and paged pair at 64, 128 and
  256; one wrapper a kernel at every type, no cast to bfloat16, and the
  wrappers refuse CPU tensors;
* a small LLaMA at float16 (head dim 64) through the paged engine, greedy
  tokens equal to the reference engine's.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu.ops import encoder_attention as jea
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import _admit
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import encoder_attention as tea
from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
CUH = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" / "kv_attention.cuh"
FLASH_CU = CUH.with_name("flash_attention.cu")
FLASH_BWD_CU = CUH.with_name("flash_attention_bwd.cu")
ENCODER_CU = CUH.with_name("encoder_attention.cu")
ENCODER_BWD_CU = CUH.with_name("encoder_attention_bwd.cu")
TORCH_OF_C = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32,
              "int8_t": torch.int8}
F16_TOL = 1e-2
F16_MODEL_TOL = 4e-3
INT8_TOL = 3e-4
SCALE = 1 / 128 ** 0.5


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max |got - want| / max |want| = {err:.2e} > {tol}"


def _static(B=3, S=1, H=8, Hkv=4, L=256, offsets=(0, 37, 200), seed=0, dtype=np.float16,
            std=0.5):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, H, 128) * std).astype(dtype)
    k = (rng.randn(B, Hkv, L, 128) * std).astype(dtype)
    v = (rng.randn(B, Hkv, L, 128) * std).astype(dtype)
    return q, k, v, np.asarray(offsets, np.int32)


def _paged(B=3, S=1, H=8, Hkv=4, ps=128, M=4, offsets=(37, 300, 410), seed=0,
           dtype=np.float16, std=0.5):
    rng = np.random.RandomState(seed)
    P = 1 + B * M
    q = (rng.randn(B, S, H, 128) * std).astype(dtype)
    kp = (rng.randn(P, Hkv, ps, 128) * std).astype(dtype)
    vp = (rng.randn(P, Hkv, ps, 128) * std).astype(dtype)
    free = list(range(1, P))
    rng.shuffle(free)
    pt = np.zeros((B, M), np.int32)
    for b in range(B):
        for j in range(min(M, -(-(int(offsets[b]) + S) // ps))):
            pt[b, j] = free.pop()
    return q, kp, vp, pt, np.asarray(offsets, np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ------------------------------------------------------ plain at float16

@pytest.mark.parametrize("offsets", [(0, 37, 200), (255, 128, 5)], ids=["ragged", "edges"])
def test_plain_f16_decode_matches_reference_kernel(offsets):
    """The reference's static kernel takes one query row a slot."""
    q, k, v, off = _static(offsets=offsets)
    want = jda._decode_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
                              None, None, scale=SCALE, bk=128, interpret=True)
    got = tda.decode_attention(_t(q), _t(k), _t(v), _t(off))
    assert got.dtype == torch.float16 and np.asarray(want).dtype == np.float16
    _rel_close(got.numpy(), want, F16_TOL)


@pytest.mark.parametrize("S,offsets", [(1, (37, 300, 410)), (16, (10, 200, 300))],
                         ids=["decode", "chunk_s16"])
def test_plain_f16_paged_matches_reference_kernel(S, offsets):
    q, kp, vp, pt, off = _paged(S=S, offsets=offsets)
    want = jda._paged_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(off + S), jnp.asarray(pt), None, None, scale=SCALE,
                             interpret=True)
    got = tda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(off), _t(pt))
    assert got.dtype == torch.float16
    _rel_close(got.numpy(), want, F16_TOL)


def test_split_model_f16_q_f32_pool_matches_reference_kernel():
    """A float16 model's engines keep float32 pools (the reference's
    choice): q float16 against k/v float32, p in float32, out float16."""
    q, kp, vp, pt, off = _paged(S=4, offsets=(37, 300, 410))
    kp, vp = kp.astype(np.float32), vp.astype(np.float32)
    want = jda._paged_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(off + 4), jnp.asarray(pt), None, None, scale=SCALE,
                             interpret=True)
    tpt = _t(pt)
    got = tda._split_merge_dense(_t(q), tda.gather_pages(_t(kp), tpt),
                                 tda.gather_pages(_t(vp), tpt), _t(off), None, None, SCALE, 128)
    assert got.dtype == torch.float16
    _rel_close(got.numpy(), want, F16_MODEL_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_f16_encoder_matches_reference_kernel(D, causal):
    rng = np.random.RandomState(D)
    q, k, v = ((rng.randn(1, 128, 2, D) * 0.5).astype(np.float16) for _ in range(3))
    want = jea.encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tea.encoder_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float16
    _rel_close(got.numpy(), want, F16_TOL)


@pytest.mark.parametrize("Sq,Sk,D,causal", [(128, 128, 64, True), (128, 256, 128, True),
                                             (128, 128, 256, False)])
def test_plain_f16_flash_matches_reference_kernel(Sq, Sk, D, causal):
    rng = np.random.RandomState(Sq + D)
    q = rng.randn(1, Sq, 2, D).astype(np.float16)
    k, v = (rng.randn(1, Sk, 2, D).astype(np.float16) for _ in range(2))
    want_o, want_lse = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                                    jnp.asarray(v), causal=causal,
                                                    interpret=True)
    o, lse = tfa.flash_attention_with_lse(_t(q), _t(k), _t(v), causal=causal)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    _rel_close(o.numpy(), want_o, F16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-4, atol=1e-4)


# ------------------------------------------- the int8 model at f32 and f16

@pytest.mark.parametrize("q_dtype", [np.float32, np.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("layout", ["static", "paged"])
def test_int8_model_matches_reference_kernel(layout, q_dtype):
    """The plain model of the kernels' int8 arithmetic against the
    reference kernel at float32 and float16 q: K and V widened exactly (the
    reference widens int8 to bfloat16 whatever q's type), the k-scale on the
    scores, the v-scale on p after l, p rounded to bfloat16.  Inputs ~N(0,
    0.3^2), as the reference's own int8 test draws them for this bound."""
    if layout == "static":
        q, k, v, off = _static(offsets=(0, 37, 255), dtype=np.float32, std=0.3)
        (kq, ks), (vq, vs) = jkv._quantize_kv(jnp.asarray(k)), jkv._quantize_kv(jnp.asarray(v))
        q = q.astype(q_dtype)
        want = jda._decode_pallas(jnp.asarray(q), kq, vq, jnp.asarray(off), ks, vs, scale=SCALE,
                                  bk=128, interpret=True)
        got = tda._split_merge_dense(_t(q), _t(kq), _t(vq), _t(off), _t(ks), _t(vs), SCALE, 64)
    else:
        q, kp, vp, pt, off = _paged(S=3, offsets=(37, 300, 410), dtype=np.float32, std=0.3)
        (kq, ks), (vq, vs) = jkv._quantize_kv(jnp.asarray(kp)), jkv._quantize_kv(jnp.asarray(vp))
        q = q.astype(q_dtype)
        want = jda._paged_pallas(jnp.asarray(q), kq, vq, jnp.asarray(off + 3), jnp.asarray(pt),
                                 ks, vs, scale=SCALE, interpret=True)
        tpt = _t(pt)
        got = tda._split_merge_dense(
            _t(q), tda.gather_pages(_t(kq), tpt), tda.gather_pages(_t(vq), tpt), _t(off),
            tda.gather_pages(_t(ks), tpt), tda.gather_pages(_t(vs), tpt), SCALE, 192)
    assert got.dtype == torch.from_numpy(q).dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=INT8_TOL, atol=INT8_TOL)


# ----------------------------------------------------------- admission

def _cuh_list(name, path=CUH):
    """The entries of ``#define name(X) X(..) X(..)`` in a .cuh file."""
    line = re.search(rf"^#define {name}\(X\)(.*)$", path.read_text(), re.M).group(1)
    return [tuple(a.strip() for a in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", line)]


def _tc_built(cu, types, dims):
    """The tensor-core flash or encoder instantiations a source builds: its
    (element type, type code) list against the type codes the wrappers pass
    (_admit.TC_TYPE_CODES, which flash's TYPE_CODES is: one table, each
    source building a part of it), times its head dims."""
    codes = {TORCH_OF_C[c]: int(code) for c, code in _cuh_list(types, cu)}
    assert all(_admit.TC_TYPE_CODES[t] == c for t, c in codes.items())
    assert tfa.TYPE_CODES is _admit.TC_TYPE_CODES
    return {(cu.stem, t, t, int(d), None) for t in codes for (d,) in _cuh_list(dims, cu)}


def test_admission_list_is_the_cuh_instantiations():
    """ops/_admit.py's decode and paged lists are kv_attention.cuh's KV_*
    lists (type codes, (q, kv) pairs, head dims), and every instantiation
    admit() can return is one a source builds: both regimes of every (q, kv)
    pair and head dim of the decode and paged kernels, and flash and the
    encoder at bfloat16, float16 and float32 (flash_attention.cu's
    FLASH_TYPES and FLASH_DIMS, encoder_attention.cu's ENCODER_TYPES and
    ENCODER_DIMS, the head dims ``supported`` admits).  No attention body
    is left on the CUDA cores: attention_simt.cuh and its entries are gone,
    with their lists."""
    codes = {TORCH_OF_C[c]: int(code) for c, code in _cuh_list("KV_TYPES")}
    assert codes == _admit.KV_TYPE_CODES
    assert all(_admit.KV_TYPE_CODES[t] == c for t, c in _admit.TC_TYPE_CODES.items())
    assert {t: TORCH_OF_C[c] for t, c in _admit.C_TYPES.items()} == {t: t for t in codes}
    assert ([(TORCH_OF_C[a], TORCH_OF_C[b]) for a, b in _cuh_list("KV_PAIRS")]
            == list(_admit.KV_PAIRS))
    assert ([int(d) for (d,) in _cuh_list("KV_DIMS")] == list(_admit.KV_DIMS)
            == list(tda.KV_HEAD_DIMS))
    for gone in ("attention_simt.cuh", "attention_simt_decode.cu", "attention_simt_paged.cu",
                 "attention_simt_flash.cu", "attention_simt_encoder.cu"):
        assert not (CUH.parent / gone).exists()
    assert not any(hasattr(_admit, n) for n in ("FLASH_TYPES", "ENCODER_TYPES", "FLASH_DIMS",
                                                 "ENCODER_DIMS", "TYPE_CODES", "BF16_KV"))
    built = {(f"{r}_attention", q, kv, D, split_k)
             for r in ("decode", "paged") for q, kv in _admit.KV_PAIRS for D in _admit.KV_DIMS
             for split_k in (True, False)}
    flash = _tc_built(FLASH_CU, "FLASH_TYPES", "FLASH_DIMS")
    enc = _tc_built(ENCODER_CU, "ENCODER_TYPES", "ENCODER_DIMS")
    built |= flash | enc
    for regime, tc in (("flash", flash), ("encoder", enc)):
        assert (set(_admit.TC_TYPES[regime]) == {b[1] for b in tc}
                == {torch.bfloat16, torch.float16, torch.float32})
    assert {d for *_, d, _ in flash} == set(tfa.FWD_HEAD_DIMS)
    assert ({d for *_, d, _ in enc}
            == {d for d in range(8, 513, 8) if tea.supported(1, 128, d)})
    admitted = {tuple(_admit.admit(r, q, kv, D, rows))
                for r in ("decode", "paged") for q, kv in _admit.KV_PAIRS for D in _admit.KV_DIMS
                for rows in (1, _admit.DECODE_ROWS, _admit.DECODE_ROWS + 1)}
    admitted |= {tuple(_admit.admit(r, t, t, D)) for r, dims in (("flash", tfa.FWD_HEAD_DIMS),
                                                               ("encoder", (64, 128)))
                 for t in (torch.float32, torch.float16, torch.bfloat16) for D in dims}
    assert admitted == built
    for lib in {b[0] for b in built}:  # each entry's source exists
        assert (CUH.parent / f"{lib}.cu").is_file()


def test_backward_admission_list_is_the_cuh_instantiations():
    """No backward is built on the CUDA cores (attention_simt_bwd.cuh and
    its entries are gone, and _admit keeps no list of them), and every
    instantiation admit() returns for "flash_bwd" and "encoder_bwd" at
    float32, float16 and bfloat16 is one a tensor-core source builds: the
    flash backward (flash_attention_bwd.cu's FLASH_BWD_TYPES and
    FLASH_BWD_DIMS, head dim 256 at every type) and the encoder backward
    (encoder_attention_bwd.cu's ENCODER_BWD_TYPES and ENCODER_BWD_DIMS,
    float32 as split-bf16 products, the head dims ``supported`` admits)."""
    for gone in ("attention_simt_bwd.cuh", "attention_simt_flash_bwd.cu",
                 "attention_simt_encoder_bwd.cu"):
        assert not (CUH.parent / gone).exists()
    assert not any(hasattr(_admit, n) for n in ("ENCODER_BWD_TYPES", "ENCODER_BWD_DIMS",
                                                "BWD_ROWS"))
    tc = _tc_built(FLASH_BWD_CU, "FLASH_BWD_TYPES", "FLASH_BWD_DIMS")
    tc_enc = _tc_built(ENCODER_BWD_CU, "ENCODER_BWD_TYPES", "ENCODER_BWD_DIMS")
    for regime, lib in (("flash_bwd", tc), ("encoder_bwd", tc_enc)):
        assert set(_admit.TC_TYPES[regime]) == {b[1] for b in lib} == set(_admit.TC_TYPE_CODES)
    admitted = {tuple(_admit.admit(r, t, t, D)) for r, dims in (("flash_bwd", (64, 128, 256)),
                                                               ("encoder_bwd", (64, 128)))
                for t in (torch.float32, torch.float16, torch.bfloat16) for D in dims}
    assert admitted == tc | tc_enc
    assert {tuple(_admit.admit("flash_bwd", t, t, D)) for t in tfa.TYPE_CODES
            for D in tfa.BWD_HEAD_DIMS} == tc
    assert ({d for *_, d, _ in tc_enc}
            == {d for d in range(8, 513, 8) if tea.supported(1, 128, d)})
    assert not tea.supported(1, 128, 256)  # the encoder kernels' head dims
    for lib in {b[0] for b in admitted}:
        assert (CUH.parent / f"{lib}.cu").is_file()
        assert "attention_simt" not in (CUH.parent / f"{lib}.cu").read_text()


def _encoder_refusals(regime, q16, q32):
    """(wrapper, args, message): the one encoder forward wrapper and the one
    backward wrapper, each of which takes every type, called with float64,
    the refusal naming the admitted types."""
    if regime == "encoder":
        return [(tea.encoder_attention_kernel, (q32.double(),) * 3, "bfloat16, float32, float16")]
    return [(tea.encoder_attention_bwd_kernel, (q32.double(),) * 4, "bfloat16, float32, float16")]


@pytest.mark.parametrize("regime", ["decode", "paged", "flash", "flash_bwd", "encoder",
                                    "encoder_bwd"])
def test_admission_picks_kernel_by_q_dtype(regime):
    """decode and paged: every (q, kv) pair built on the one kernel of
    each, at head dims 64, 128 and 256, its regime by rows (split-K up to
    16).  flash and the encoder, forward and backward: every type on the
    tensor-core kernels (float32 as split-bf16 products); float16 against
    bfloat16 k/v and float32 against float16 are refused (no cast reaches a
    kernel), and each wrapper refuses float64, naming the types it takes."""
    tc_types = (torch.bfloat16, torch.float16, torch.float32)
    if regime.startswith("encoder"):
        tc_lib = "encoder_attention" + ("_bwd" if regime == "encoder_bwd" else "")
        for t in tc_types:
            for D in (64, 128):
                got = _admit.admit(regime, t, t, D)
                assert got.lib == tc_lib and (got.q, got.kv, got.D) == (t, t, D)
        with pytest.raises(ValueError, match="q float16 takes k/v of float16"):
            _admit.admit(regime, torch.float16, torch.bfloat16, 128)
        with pytest.raises(ValueError, match="q float32 takes k/v of float32"):
            _admit.admit(regime, torch.float32, torch.float16, 128)
        q16, q32 = (torch.zeros(1, 128, 2, 64, dtype=t) for t in (torch.float16, torch.float32))
        for fn, args, msg in _encoder_refusals(regime, q16, q32):
            before = fn.launches
            with pytest.raises(ValueError, match=msg):
                fn(*args)
            assert fn.launches == before
        return
    if regime.startswith("flash"):
        tc_lib = "flash_attention" + ("_bwd" if regime == "flash_bwd" else "")
        for t in tc_types:
            for D in (64, 128, 256):
                got = _admit.admit(regime, t, t, D)
                assert got.lib == tc_lib and (got.q, got.kv, got.D) == (t, t, D)
        with pytest.raises(ValueError, match="q float16 takes k/v of float16"):
            _admit.admit(regime, torch.float16, torch.bfloat16, 128)
        with pytest.raises(ValueError, match="q float32 takes k/v of float32"):
            _admit.admit(regime, torch.float32, torch.float16, 128)
        q16, q64 = (torch.zeros(1, 128, 2, 64, dtype=t) for t in (torch.float16, torch.float64))
        lse = torch.zeros(1, 2, 128)
        if regime == "flash":
            refusals = [(tfa.flash_attention_kernel, (q64, q64, q64),
                         "bfloat16, float32, float16")]
        else:  # one backward at every type: the split pass is float32's alone
            refusals = [(tfa.flash_attention_bwd_split, (q16,) * 4,
                         "the split pass takes float32")]
            refusals += [(fn, (q64,) * 5 + (lse,), "bfloat16, float32, float16")
                         for fn in (tfa.flash_attention_dq_kernel, tfa.flash_attention_dkv_kernel)]
        for fn, args, msg in refusals:
            before = fn.launches
            with pytest.raises(ValueError, match=msg):
                fn(*args)
            assert fn.launches == before
        return
    for q, kv in _admit.KV_PAIRS:
        for D in (64, 128, 256):
            got = _admit.admit(regime, q, kv, D, 16)
            assert got.lib == f"{regime}_attention" and got.split_k
            assert (got.q, got.kv, got.D) == (q, kv, D)
            assert not _admit.admit(regime, q, kv, D, 17).split_k
    with pytest.raises(ValueError, match="pairs built"):  # no cast to reach a kernel
        _admit.admit(regime, torch.float32, torch.float16, 128)
    with pytest.raises(ValueError, match="Queue 2, item 9"):
        _admit.admit(regime, torch.float32, torch.float32, 96)


@pytest.mark.parametrize("regime", ["decode", "paged", "flash", "encoder"])
def test_f64_q_refused_naming_admitted_dtypes(regime):
    with pytest.raises(ValueError, match="bfloat16, float32, float16"):
        _admit.admit(regime, torch.float64, torch.float64, 128)
    q = torch.zeros(1, 128, 2, 64, dtype=torch.float64)
    kernels = {"decode": lambda: tda.decode_attention_kernel(
                   q[:, :1], q.reshape(1, 2, 128, 64), q.reshape(1, 2, 128, 64),
                   torch.ones(1, dtype=torch.int32)),
               "paged": lambda: tda.paged_attention_kernel(
                   q[:, :1], q.reshape(1, 2, 128, 64), q.reshape(1, 2, 128, 64),
                   torch.ones(1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32)),
               "flash": lambda: tfa.flash_attention_kernel(q, q, q),
               "encoder": lambda: tea.encoder_attention_kernel(q, q, q)}
    with pytest.raises(ValueError, match="bfloat16, float32, float16"):
        kernels[regime]()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["f32", "f16"])
def test_backward_refused_naming_queue_2_item_11(dtype):
    """Queue 2 items 8 and 11 are closed: a float32 or float16 gradient is
    admitted to a backward kernel at head dims 64 and 128, the flash one at
    256 too: the flash and encoder backward at the tensor-core kernels at
    every type (flash_attention_bwd.cu, encoder_attention_bwd.cu; float32
    as split-bf16 products); the backward wrappers refuse CPU tensors, and
    the split pass every type but float32; the flash backward at head dim
    256 is admitted at every type (the D = 256 wrappers reach their device
    check), while k/v of another type and other head dims are refused
    before any launch."""
    f16 = dtype == torch.float16
    for regime in ("flash_bwd", "encoder_bwd"):
        lib = f"{regime[:-4]}_attention_bwd"
        for D in (64, 128, 256) if regime == "flash_bwd" else (64, 128):
            got = _admit.admit(regime, dtype, dtype, D)
            assert got.lib == lib and (got.q, got.kv, got.D) == (dtype, dtype, D)
        with pytest.raises(ValueError, match=f"q {str(dtype)[6:]} takes k/v of {str(dtype)[6:]}"):
            _admit.admit(regime, dtype, torch.bfloat16, 64)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa._check_head_dim(96, backward=True)
    for t in (dtype, torch.bfloat16):
        got = _admit.admit("flash_bwd", t, t, 256)
        assert got.D == 256
    q = torch.zeros(1, 128, 2, 64, dtype=dtype)
    lse = torch.zeros(1, 2, 128)
    for fn in (tfa.flash_attention_dq_kernel, tfa.flash_attention_dkv_kernel):
        before = fn.launches
        with pytest.raises(ValueError, match="not a CUDA device"):
            fn(q, q, q, q, q, lse, causal=True)
        assert fn.launches == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa.flash_attention_bwd_stats(q, q, lse)
    before = tfa.flash_attention_bwd_split.launches
    with pytest.raises(ValueError, match="the split pass takes float32" if f16
                       else "not a CUDA device"):
        tfa.flash_attention_bwd_split(q, q, q, q)
    assert tfa.flash_attention_bwd_split.launches == before
    before = tea.encoder_attention_bwd_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tea.encoder_attention_bwd_kernel(q, q, q, q)
    assert tea.encoder_attention_bwd_kernel.launches == before
    q256 = torch.zeros(1, 128, 2, 256, dtype=dtype)
    for fn in (tfa.flash_attention_dq_kernel, tfa.flash_attention_dkv_kernel):
        before = fn.launches
        with pytest.raises(ValueError, match="not a CUDA device"):
            fn(q256, q256, q256, q256, q256, lse, causal=True)
        assert fn.launches == before
    b256 = q256.bfloat16()
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa.flash_attention_dq_kernel(b256, b256, b256, b256, b256, lse, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["f32", "f16"])
def test_typed_wrappers_reject_cpu_tensors(dtype):
    """The wrappers of dtype's kernels (flash and the encoder, forward and
    backward, and decode and paged against a cache of q's type, float32 and
    int8) launch on CUDA tensors only and never run the plain version; a
    refused call does not count.  Every attention wrapper takes every type:
    the CUDA-core wrappers, and the helpers that picked between two
    wrappers, are gone."""
    q = torch.zeros(1, 128, 2, 64, dtype=dtype)
    lse = torch.zeros(1, 2, 128)
    cache = q.reshape(1, 2, 128, 64)
    lengths, tbl = torch.ones(1, dtype=torch.int32), torch.ones(1, 1, dtype=torch.int32)
    i8, scales = cache.to(torch.int8), torch.ones(1, 2, 128)
    stats, dq, dkv = (tfa.flash_attention_bwd_stats, tfa.flash_attention_dq_kernel,
                      tfa.flash_attention_dkv_kernel)
    calls = [(tfa.flash_attention_kernel, (q, q, q)),
             (tea.encoder_attention_kernel, (q, q, q)),
             (stats, (q, q, lse)),
             (dq, (q, q, q, q, q, lse)),
             (dkv, (q, q, q, q, q, lse)),
             (tea.encoder_attention_bwd_kernel, (q, q, q, q)),
             (tda.decode_attention_kernel, (q[:, :1], cache, cache, lengths)),
             (tda.decode_attention_kernel, (q[:, :1], cache.float(), cache.float(), lengths)),
             (tda.decode_attention_kernel, (q[:, :1], i8, i8, lengths, scales, scales)),
             (tda.paged_attention_kernel, (q[:, :1], cache, cache, lengths, tbl)),
             (tda.paged_attention_kernel, (q[:, :1], cache.float(), cache.float(), lengths, tbl)),
             (tda.paged_attention_kernel, (q[:, :1], i8, i8, lengths, tbl, scales, scales))]
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="not a CUDA device"):
            fn(*args)
        assert fn.launches == before
    for mod, gone in ((tfa, "flash_attention_simt_kernel"), (tea, "encoder_attention_simt_kernel"),
                      (tda, "decode_attention_simt_kernel"), (tda, "paged_attention_simt_kernel")):
        assert not hasattr(mod, gone) and not hasattr(mod, "_fwd_kernel")
        assert gone not in mod.__all__


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
def test_encoder_kernel_helpers_pick_by_q_dtype(dtype):
    """Every type runs one wrapper a kernel, the tensor-core one: the
    encoder's and flash's forward and backward are admitted to their
    tensor-core sources at ``dtype``, float32 too, so no helper picks
    between wrappers, and the autograd Functions call the tensor-core
    wrappers directly."""
    assert dtype in _admit.TC_TYPES["encoder"] and dtype in _admit.TC_TYPES["flash"]
    assert not hasattr(tea, "_fwd_kernel") and not hasattr(tfa, "_fwd_kernel")
    assert not hasattr(tea, "_bwd_kernel")
    assert not hasattr(tea, "encoder_attention_simt_bwd_kernel")
    for regime, lib in (("encoder", "encoder_attention"), ("encoder_bwd", "encoder_attention_bwd"),
                        ("flash", "flash_attention"), ("flash_bwd", "flash_attention_bwd")):
        inst = _admit.admit(regime, dtype, dtype, 64)
        assert inst.lib == lib
    assert dtype in _admit.TC_TYPES["flash_bwd"] and dtype in _admit.TC_TYPES["encoder_bwd"]
    assert _admit.TC_TYPE_CODES[dtype] == tfa.TYPE_CODES[dtype]


def test_f16_encoder_wrappers_refuse_cpu_and_cuda_core_wrappers_refuse_f16():
    """float16 and float32 run the tensor-core encoder wrappers, which
    launch on CUDA tensors only (on the CPU the plain versions run through
    the autograd Function, never through a wrapper), and cast nothing; a
    refused call counts no launch and no copy.  No CUDA-core encoder
    forward wrapper is left to refuse a type."""
    assert not hasattr(tea, "encoder_attention_simt_kernel")
    copies = tea._check_inputs.copies
    for dt in (torch.float16, torch.float32):
        q = torch.zeros(1, 256, 2, 64, dtype=dt)
        lse = torch.zeros(2, 256)
        for fn, args in [(tea.encoder_attention_kernel, (q, q, q)),
                         (tea.encoder_attention_bwd_kernel, (q, q, q, q))]:
            before = fn.launches
            with pytest.raises(ValueError, match="not a CUDA device"):
                fn(*args, lse=lse) if fn is tea.encoder_attention_bwd_kernel else fn(*args)
            assert fn.launches == before
    assert tea._check_inputs.copies == copies
    # the float16 forward and backward on CPU tensors: the plain versions, in float16
    q = torch.zeros(1, 256, 2, 64, dtype=torch.float16)
    qr = q.clone().requires_grad_(True)
    o = tea.encoder_attention(qr, q, q, causal=True)
    o.sum().backward()
    assert o.dtype == qr.grad.dtype == torch.float16


# ------------------------------------------------- a float16 LLaMA served

DIMS = dict(num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
            dtype="float16")
ENGINE = dict(max_batch_slots=2, max_seq_len=512, kv_layout="paged", page_size=128,
              prefill_chunk=128, prefix_cache=False)


def test_f16_llama_paged_engine_tokens_equal_reference_engine():
    """LLaMA at float16 (head dim 64) through the paged engine, whose pools
    are float32 for a model that is not bfloat16 (the reference's rule):
    float16 q against float32 pages, the pair the engines launch on the
    card.  Greedy tokens equal the reference engine's, request by request."""
    paddle.seed(13)
    jm = JLlama(JConfig.tiny(**DIMS))
    jm.eval()
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(**DIMS), device="cpu"), ref)
    tm.eval()
    assert next(tm.parameters()).dtype == torch.float16
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 1024, n).astype(np.int32) for n in (200, 60, 140)]
    outs = []
    for cls, model in ((JEngine, jm), (LLMEngine, tm)):
        eng = cls(model, **ENGINE)
        futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_complete()
        outs.append([f.result() for f in futs])
    assert tm is not None and eng.caches[0][0].dtype == torch.float32
    assert outs[1] == outs[0]
