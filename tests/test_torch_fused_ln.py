"""Port parity: paddle_tpu_torch's fused dropout + add + LayerNorm
(ops/fused_ln.py), F.fused_dropout_add_layer_norm, F.layer_norm,
F.dropout and the LayerNorm and Dropout layers, against the JAX reference
on the CPU.

The port's plain versions (what CPU tensors take, and the oracles of the
Hopper kernels in chip_smoke.py) are held against the reference's Pallas
``fused_dropout_add_layer_norm`` in interpret mode, on the same
numpy-seeded inputs:
- at rate 0, the forward and the ``jax.vjp`` gradients (dbranch,
  dresidual, dgamma, dbeta);
- at rate 0.1, the port with its own Philox mask against the reference at
  rate 0 fed branch * keep / (1 - rate), whose dbranch times keep / (1 -
  rate) is the port's by the chain rule (the two platforms' masks differ by
  design).
Tolerances: f32 within 1e-5 (the outputs are O(3); the two sum in another
order); bf16 within two bf16 units in the last place of the value (rtol
2^-7, atol 1e-2): both round the same f32 results to bf16, and a sum in
another order can move a value across a rounding boundary.  At rate 0.1 in
bf16 the reference's input branch * keep / (1 - rate) is itself rounded to
bf16 where the port keeps it in f32: s = residual + that then rounds twice
and may land one unit of s apart, which the normalisation carries into the
output scaled by rstd * gamma (below 1.5 here), so there the gate is rtol
2^-6, atol 2e-2.

WIDE_SHAPES run the same tests at h > 1024 (up to the reference's 32768),
where the card runs the wide kernels; ``_plan`` and the kernel
instantiations of csrc/fused_ln.cu are held to be one list, and the plain
partials model (``_team_partials``) to the kernels' row-to-team
assignment.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import fused_ln as jfl
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_ln as tfl

EPS = 1e-12
RATE = 0.1
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=1e-2)}
TOL_FED = {"float32": TOL["float32"], "bfloat16": dict(rtol=2**-6, atol=2e-2)}
SHAPES = [(128, 256), (24, 384)]
WIDE_SHAPES = [(16, 1152), (8, 4096), (8, 32768)]
ALL_SHAPES = SHAPES + WIDE_SHAPES
CU = Path(tfl.__file__).resolve().parents[1] / "csrc" / "fused_ln.cu"


def _inputs(n, h, seed):
    rng = np.random.RandomState(seed)
    return dict(branch=rng.randn(n, h).astype(np.float32),
                residual=(rng.randn(n, h) * 2 + 0.5).astype(np.float32),
                gamma=(1 + 0.2 * rng.randn(h)).astype(np.float32),
                beta=(0.2 * rng.randn(h)).astype(np.float32),
                dout=rng.randn(n, h).astype(np.float32))


def _np(t):
    return t.detach().float().numpy()


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _ref(inp, dtype, branch=None):
    """The reference kernel at rate 0 (interpret mode): out and its vjp
    (dbranch, dresidual, dgamma, dbeta) against dout, as f32 numpy."""
    args = [_jax(inp["branch"] if branch is None else branch, dtype)] + [
        _jax(inp[k], dtype) for k in ("residual", "gamma", "beta")]

    def f(b, r, g, be):
        return jfl.fused_dropout_add_layer_norm(b, r, g, be, jnp.zeros((2,), jnp.int32),
                                                0.0, EPS)

    out, vjp = jax.vjp(f, *args)
    grads = vjp(_jax(inp["dout"], dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32))
                                                for g in grads]


def _port(inp, dtype, rate, seed):
    td = getattr(torch, dtype)
    ts = {k: torch.from_numpy(inp[k]).to(td).requires_grad_(True)
          for k in ("branch", "residual", "gamma", "beta")}
    out = tfl.fused_dropout_add_layer_norm(ts["branch"], ts["residual"], ts["gamma"],
                                           ts["beta"], seed, rate, EPS)
    out.backward(torch.from_numpy(inp["dout"]).to(td))
    return out, [ts[k].grad for k in ("branch", "residual", "gamma", "beta")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", ALL_SHAPES, ids=[f"n{n}_h{h}" for n, h in ALL_SHAPES])
def test_plain_matches_reference_kernel_rate0(n, h, dtype):
    inp = _inputs(n, h, n + h)
    want, wgrads = _ref(inp, dtype)
    before = (tfl.fused_ln_kernel.launches, tfl.fused_ln_bwd_kernel.launches)
    out, grads = _port(inp, dtype, 0.0, None)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), want, **TOL[dtype])
    for g, w, name in zip(grads, wgrads, ("branch", "residual", "gamma", "beta")):
        scale = max(1.0, np.abs(w).max())  # dgamma, dbeta sum over n rows
        np.testing.assert_allclose(_np(g) / scale, w / scale, **TOL[dtype], err_msg=name)
    assert (tfl.fused_ln_kernel.launches, tfl.fused_ln_bwd_kernel.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", ALL_SHAPES, ids=[f"n{n}_h{h}" for n, h in ALL_SHAPES])
def test_dropout_matches_reference_fed_the_ports_mask(n, h, dtype):
    inp = _inputs(n, h, 3 * n + h)
    seed = torch.tensor([n, -h], dtype=torch.int32)
    keep = tfl.dropout_keep(seed, n, h, RATE).numpy()
    assert abs(keep.mean() - (1 - RATE)) < 0.02
    fed = np.where(keep, inp["branch"] * np.float32(1 / (1 - RATE)), 0).astype(np.float32)
    want, (wdb, wdr, wdg, wdbeta) = _ref(inp, dtype, branch=fed)
    out, (db, dr, dg, dbeta) = _port(inp, dtype, RATE, seed)
    np.testing.assert_allclose(_np(out), want, **TOL_FED[dtype])
    want_db = np.where(keep, wdb * np.float32(1 / (1 - RATE)), 0)
    for g, w, name in ((db, want_db, "branch"), (dr, wdr, "residual"), (dg, wdg, "gamma"),
                       (dbeta, wdbeta, "beta")):
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(_np(g) / scale, w / scale, **TOL_FED[dtype], err_msg=name)


def test_backward_reuses_the_forwards_mask():
    """dbranch is zero exactly where the branch was dropped, whatever the
    upscale mode, and the partials sum to the full reduction."""
    inp = _inputs(64, 128, 5)
    seed = torch.tensor([3, 4], dtype=torch.int32)
    for upscale in (True, False):
        b = torch.from_numpy(inp["branch"]).requires_grad_(True)
        r = torch.from_numpy(inp["residual"])
        g, be = torch.from_numpy(inp["gamma"]), torch.from_numpy(inp["beta"])
        out = tfl.fused_dropout_add_layer_norm(b, r, g, be, seed, RATE, EPS, upscale)
        out.backward(torch.from_numpy(inp["dout"]))
        keep = tfl.dropout_keep(seed, 64, 128, RATE)
        assert torch.equal(b.grad != 0, keep)
    s = torch.from_numpy(inp["residual"])
    _, _, dgp, dbp = tfl._fused_ln_bwd_dense(s, g, torch.from_numpy(inp["dout"]), seed, 0.0,
                                             EPS, True)
    assert dgp.shape == (1, 128)  # one partial row per 128 rows
    np.testing.assert_allclose(dbp.sum(0).numpy(), inp["dout"].sum(0), rtol=1e-5, atol=1e-5)


def _cu_list(macro):
    """The arguments of each X(...) in csrc/fused_ln.cu's ``#define macro(X)``."""
    line = re.search(rf"#define {macro}\(X\)(.*)", CU.read_text()).group(1)
    return [tuple(a.strip() for a in args.split(",")) for args in re.findall(r"X\(([^)]*)\)",
                                                                             line)]


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU.read_text()).group(1))


def test_every_admitted_width_has_a_kernel():
    """Every h that ``supported`` admits for some n gets a plan whose kernel
    csrc/fused_ln.cu instantiates and whose blocks cover the row, by the
    .cu's own admission (``bad_plan``); above 32768 no n is admitted."""
    narrow = {int(ng) for (ng,) in _cu_list("FUSED_LN_NARROW")}
    wide = {(t, int(k)) for t, k in _cu_list("FUSED_LN_WIDE")}
    assert narrow == set(range(1, 9)) and wide
    assert _cu_const("kNarrowMaxH") == tfl.NARROW_MAX_H
    assert _cu_const("kMaxH") == 32768 and _cu_const("kWideValues") == tfl.WIDE_VALUES
    assert tfl.BLOCK_THREADS == 32 * _cu_const("kWarps")
    assert tfl.BWD_ROWS == _cu_const("kWarps")
    widths = [h for h in range(128, 32769, 128) if tfl.supported(8, h)]
    assert widths == list(range(128, 32769, 128))
    assert not any(tfl.supported(n, 32896) for n in (8, 16, 512, 4096))
    for h in widths:
        for bf16, ctype in ((True, "__nv_bfloat16"), (False, "float")):
            p = tfl._plan(h, bf16)
            if h <= tfl.NARROW_MAX_H:
                assert not p.wide and p.k == h // 128 in narrow and p.cl == 1, (h, p)
                assert p.threads == tfl.BLOCK_THREADS and p.rows == tfl.BWD_ROWS
                continue
            v = 8 if bf16 else 4
            pieces = h // v
            per = -(-pieces // p.cl)
            assert p.wide and (ctype, p.k) in wide and p.rows == 1, (h, p)
            assert p.cl in (1, 2, 4, 8) and p.threads % 32 == 0, (h, p)
            assert 0 < p.threads <= tfl.BLOCK_THREADS and p.k * v <= tfl.WIDE_VALUES, (h, p)
            assert p.threads * p.k >= per and pieces - (p.cl - 1) * per > 0, (h, p)


@pytest.mark.parametrize("teams,rows", [(5, 8), (7, 1), (1, 8)])
def test_team_partials_sum_to_full_and_match_old_layout(teams, rows):
    """The plain partials for a given grid: row r goes to team (r // rows)
    % teams; they sum to the full dgamma/dbeta, and to what the old layout
    (one partial row per 128 consecutive rows) summed to."""
    n, h = 300, 256
    inp = _inputs(n, h, 17)
    s, dz = torch.from_numpy(inp["residual"]), torch.from_numpy(inp["dout"])
    g = torch.from_numpy(inp["gamma"])
    _, _, dgp, dbp = tfl._fused_ln_bwd_dense(s, g, dz, None, 0.0, EPS, True, teams=teams,
                                             rows=rows)
    assert dgp.shape == dbp.shape == (teams, h)
    mean, rstd = tfl._stats(s, EPS)
    prod = dz * (s - mean) * rstd
    for t in range(teams):
        mine = (torch.arange(n) // rows) % teams == t
        torch.testing.assert_close(dgp[t], prod[mine].sum(0), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dbp[t], dz[mine].sum(0), rtol=1e-5, atol=1e-5)
    old = torch.nn.functional.pad(prod, (0, 0, 0, 84)).reshape(3, 128, h).sum(1)
    torch.testing.assert_close(dgp.sum(0), old.sum(0), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dgp.sum(0), prod.sum(0), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dbp.sum(0), dz.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training,p", [(True, 0.0), (False, 0.3)], ids=["p0", "eval"])
def test_functional_matches_reference_composed(dtype, training, p):
    """F.fused_dropout_add_layer_norm on CPU tensors: the composed math on
    both sides (statistics on the f32 sum, the normalised value cast before
    weight and bias), at rate 0 (p = 0, or eval)."""
    inp = _inputs(32, 256, 11)
    x = inp["branch"].reshape(2, 16, 256)
    res = inp["residual"].reshape(2, 16, 256)
    dout = inp["dout"].reshape(2, 16, 256)
    jargs = [paddle.to_tensor(a).astype(dtype) for a in (x, res, inp["gamma"], inp["beta"])]
    for a in jargs:
        a.stop_gradient = False
    jout = JF.fused_dropout_add_layer_norm(*jargs, p=p, epsilon=1e-12, training=training)
    (jout.astype("float32") * paddle.to_tensor(dout)).sum().backward()
    td = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(td).requires_grad_(True)
             for a in (x, res, inp["gamma"], inp["beta"])]
    tout = TF.fused_dropout_add_layer_norm(*targs, p=p, epsilon=1e-12, training=training)
    (tout.float() * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout._value.astype(jnp.float32)),
                               **TOL[dtype])
    for t, j in zip(targs, jargs):
        w = np.asarray(j.grad._value.astype(jnp.float32))
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(_np(t.grad) / scale, w / scale, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 6, 192) * 3 + 40).astype(np.float32)  # |mean| >> spread
    w, b = (1 + 0.1 * rng.randn(192)).astype(np.float32), rng.randn(192).astype(np.float32)
    want = JF.layer_norm(paddle.to_tensor(x).astype(dtype), 192,
                         paddle.to_tensor(w).astype(dtype), paddle.to_tensor(b).astype(dtype),
                         epsilon=1e-12)
    td = getattr(torch, dtype)
    got = TF.layer_norm(torch.from_numpy(x).to(td), 192, torch.from_numpy(w).to(td),
                        torch.from_numpy(b).to(td), epsilon=1e-12)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), np.asarray(want._value.astype(jnp.float32)),
                               **TOL[dtype])
    two = TF.layer_norm(torch.from_numpy(x), [6, 192], epsilon=1e-5)
    want2 = JF.layer_norm(paddle.to_tensor(x), [6, 192], epsilon=1e-5)
    np.testing.assert_allclose(two.numpy(), np.asarray(want2._value), rtol=1e-4, atol=1e-4)


def test_layer_norm_layer():
    ln = tnn.LayerNorm(64, epsilon=1e-6)
    assert torch.equal(ln.weight, torch.ones(64)) and torch.equal(ln.bias, torch.zeros(64))
    bare = tnn.LayerNorm([64], epsilon=1e-6, weight_attr=False, bias_attr=False)
    assert bare.weight is None and bare.bias is None and len(list(bare.parameters())) == 0
    x = torch.randn(3, 64)
    torch.testing.assert_close(ln(x), bare(x))


def test_errors_match_reference():
    x = torch.zeros(16, 100)
    g = torch.ones(100)
    for fn, xs, gs in ((tfl.fused_dropout_add_layer_norm, x, g),
                       (jfl.fused_dropout_add_layer_norm, jnp.zeros((16, 100)), jnp.ones(100))):
        with pytest.raises(ValueError, match="not tileable"):
            fn(xs, xs, gs, gs, None, 0.0)
    for n, h in ((5, 128), (16, 128), (1024, 512), (8, 65536), (24, 256)):
        assert tfl.supported(n, h) == jfl.supported(n, h), (n, h)
    y = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="rate < 1"):
        tfl.fused_dropout_add_layer_norm(y, y, torch.ones(128), torch.zeros(128),
                                         torch.zeros(2, dtype=torch.int32), 1.0)


def test_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros(16, 128, dtype=torch.bfloat16)
    g = torch.ones(128)
    before = (tfl.fused_ln_kernel.launches, tfl.fused_ln_bwd_kernel.launches)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfl.fused_ln_kernel(x, x, g, g, None, 0.0, EPS)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfl.fused_ln_bwd_kernel(x, g, x, None, 0.0, EPS)
    assert (tfl.fused_ln_kernel.launches, tfl.fused_ln_bwd_kernel.launches) == before


class TestDropoutSemantics:
    """tests/test_fused_ln.py TestDropoutSemantics, on the port."""

    def test_train_stats_and_upscale(self):
        from paddle_tpu_torch import seed

        seed(7)
        y = TF.dropout(torch.ones(2000, 100), p=0.3, training=True).numpy()
        assert abs((y == 0).mean() - 0.3) < 0.02
        np.testing.assert_allclose(y[y != 0], 1 / 0.7, atol=1e-3)
        assert abs(y.mean() - 1.0) < 0.03

    def test_eval_identity_and_downscale(self):
        x = torch.ones(8, 8)
        np.testing.assert_array_equal(TF.dropout(x, p=0.4, training=False).numpy(), 1.0)
        np.testing.assert_allclose(
            TF.dropout(x, p=0.4, training=False, mode="downscale_in_infer").numpy(), 0.6)
        assert torch.equal(TF.dropout(x, p=1.0), torch.zeros(8, 8))

    def test_axis_broadcast(self):
        from paddle_tpu_torch import seed

        seed(9)
        y = TF.dropout(torch.ones(64, 4, 16), p=0.5, axis=[0, 1], training=True).numpy()
        assert ((y != 0).all(axis=2) | (y == 0).all(axis=2)).all()

    def test_grad_uses_same_mask(self):
        from paddle_tpu_torch import seed

        seed(13)
        x = torch.ones(200, 50, requires_grad=True)
        out = TF.dropout(x, p=0.5, training=True)
        out.sum().backward()
        np.testing.assert_array_equal(x.grad.numpy() != 0, out.detach().numpy() != 0)

    def test_bf16_scale_rounds_like_the_reference(self):
        """The reference multiplies by the scale rounded to the input's
        dtype: bf16(1 / 0.9) = 1.109375."""
        x = paddle.ones([4096]).astype("bfloat16")
        jy = np.asarray(JF.dropout(x, p=0.1, training=True)._value.astype(jnp.float32))
        ty = TF.dropout(torch.ones(4096, dtype=torch.bfloat16), p=0.1).float().numpy()
        assert set(np.unique(jy)) == set(np.unique(ty)) == {0.0, 1.109375}

    def test_layer_honours_training(self):
        drop = tnn.Dropout(0.5)
        x = torch.ones(100, 100)
        assert (drop(x) == 0).any()
        drop.eval()
        assert torch.equal(drop(x), x)
