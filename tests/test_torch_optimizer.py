"""Port parity: paddle_tpu_torch's optimizers and gradient clipping against
the JAX reference's update rule (paddle_tpu/optimizer/optimizer.py) on the
CPU.

The reference is driven as its compiled train step drives it:
``_clipped_grads`` over every (name, grad), then ``_apply_update`` per
parameter with the learning rate as an f32 scalar and the parameter's
``_param_decay_coeff``.  The port is driven through ``step()`` on torch
Parameters whose ``.grad`` holds the same numpy-seeded gradients.  Three
steps each.

Tolerances: f32 parameters within 1e-6 of their scale (max |p|), relative
and absolute: the same f32 operations in the same order, Adam's division
by sqrt(v) included.  bf16 parameters with bf16 moments: equal on this
machine once the port rounds each Python scalar to bf16 as JAX does; the
gate allows one bf16 rounding (2^-8 of the value and of the tensor's
scale), because XLA may keep a bf16 expression in f32 between operations
where torch rounds after each one.
"""
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt

SHAPES = {"w": (8, 6), "b": (6,), "e": (5, 4)}
LR = 0.05
STEPS = 3


def _data(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 0.7).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _reference(jo, params, grads, dtype=jnp.float32):
    named = {k: types.SimpleNamespace(_value=jnp.asarray(v, dtype), name="")
             for k, v in params.items()}
    vals = {k: p._value for k, p in named.items()}
    state = {k: jo._init_state(named[k]) for k in named}
    lr = jnp.asarray(LR, jnp.float32)
    for g in grads:
        for k, gk in jo._clipped_grads([(k, jnp.asarray(g[k], dtype)) for k in named]):
            vals[k], state[k] = jo._apply_update(vals[k], gk, state[k], lr,
                                                 jo._param_decay_coeff(named[k]))
    return ({k: np.asarray(v.astype(jnp.float32)) for k, v in vals.items()},
            {k: {n: np.asarray(jnp.asarray(x).astype(jnp.float32)) for n, x in st.items()}
             for k, st in state.items()})


def _port(to, tparams, grads, dtype=torch.float32):
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k]).to(dtype)
        to.step()
    return ({k: p.detach().float().numpy() for k, p in tparams.items()},
            {k: {n: x.float().numpy() for n, x in to._accumulators[p].items()}
             for k, p in tparams.items()})


def _params(params, dtype=torch.float32):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
            for k, v in params.items()}


OPTS = {
    "sgd": lambda m, ps, clip: m.SGD(LR, parameters=ps, weight_decay=0.01, grad_clip=clip),
    "momentum": lambda m, ps, clip: m.Momentum(LR, 0.9, parameters=ps, weight_decay=0.01,
                                               grad_clip=clip),
    "nesterov": lambda m, ps, clip: m.Momentum(LR, 0.9, parameters=ps, use_nesterov=True,
                                               grad_clip=clip),
    "adam": lambda m, ps, clip: m.Adam(LR, parameters=ps, weight_decay=0.01, grad_clip=clip),
    "adamw": lambda m, ps, clip: m.AdamW(LR, parameters=ps, weight_decay=0.01, grad_clip=clip),
}
CLIPS = {
    "none": lambda m: None,
    "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0),
    "norm": lambda m: m.ClipGradByNorm(0.8),
    "value": lambda m: m.ClipGradByValue(0.5),
}


def _assert_close(got, want, rtol, atol_scale):
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol_scale * scale,
                                   err_msg=k)


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_update_matches_reference(opt, clip):
    params, grads = _data(10 * sorted(OPTS).index(opt) + sorted(CLIPS).index(clip))
    tp = _params(params)
    to = OPTS[opt](topt, list(tp.values()), CLIPS[clip](tnn))
    got, got_state = _port(to, tp, grads)
    jo = OPTS[opt](jopt, None, CLIPS[clip](jnn))
    want, want_state = _reference(jo, params, grads)
    _assert_close(got, want, 1e-6, 1e-6)
    for k in want_state:
        _assert_close(got_state[k], want_state[k], 1e-6, 1e-6)
    assert to._step_count == STEPS


@pytest.mark.parametrize("decay_all", [True, False], ids=["decay_all", "decay_none"])
def test_adamw_apply_decay_param_fun(decay_all):
    """apply_decay_param_fun sees "" for every parameter in both packages
    (the reference's LLaMA parameters are unnamed, torch's carry no name)."""
    seen = []

    def fun(name):
        seen.append(name)
        return decay_all or name != ""

    params, grads = _data(11)
    tp = _params(params)
    got, _ = _port(topt.AdamW(LR, parameters=list(tp.values()), weight_decay=0.1,
                              apply_decay_param_fun=fun), tp, grads)
    assert set(seen) == {""}
    want, _ = _reference(jopt.AdamW(LR, weight_decay=0.1, apply_decay_param_fun=fun),
                         params, grads)
    _assert_close(got, want, 1e-6, 1e-6)
    nodecay, _ = _reference(jopt.AdamW(LR, weight_decay=0.0), params, grads)
    assert np.allclose(got["w"], nodecay["w"], rtol=1e-6, atol=1e-7) != decay_all


def test_bf16_parameters_keep_bf16_moments():
    params, grads = _data(12)
    tp = _params(params, torch.bfloat16)
    to = topt.AdamW(LR, parameters=list(tp.values()), weight_decay=0.01,
                    grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    got, got_state = _port(to, tp, grads, torch.bfloat16)
    for p in tp.values():
        st = to._accumulators[p]
        assert p.dtype == st["moment1"].dtype == st["moment2"].dtype == torch.bfloat16
        assert st["beta1_pow"].dtype == torch.float32 and st["beta1_pow"].dim() == 0
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
          for k, v in params.items()}
    want, want_state = _reference(
        jopt.AdamW(LR, weight_decay=0.01, grad_clip=jnn.ClipGradByGlobalNorm(1.0)),
        bf, grads, jnp.bfloat16)
    _assert_close(got, want, 2 ** -8, 2 ** -8)
    for k in want_state:
        _assert_close(got_state[k], want_state[k], 2 ** -8, 2 ** -8)


def test_step_skips_missing_grads_and_clear_grad():
    params, grads = _data(13)
    tp = _params(params)
    to = topt.SGD(LR, parameters=list(tp.values()))
    tp["w"].grad = torch.from_numpy(grads[0]["w"])
    to.step()
    np.testing.assert_allclose(tp["w"].detach().numpy(), params["w"] - LR * grads[0]["w"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tp["b"].detach().numpy(), params["b"])
    to.clear_grad()
    assert all(p.grad is None for p in tp.values())
    to.set_lr(0.5)
    assert to.get_lr() == 0.5


def test_unported_options_raise():
    from paddle_tpu.optimizer.lr import StepDecay

    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        topt.Adam(StepDecay(0.1, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        topt.SGD(0.1, weight_decay=types.SimpleNamespace(_coeff=0.1))
    for name in ("Adagrad", "RMSProp", "Lamb", "lr"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            getattr(topt, name)
