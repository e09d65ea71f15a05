"""The train step as programs (paddle_tpu_torch/jit/train_step.py over
jit/graphs.py) and the fused Adam update's plain version
(ops/fused_adam.py), on the CPU.

- Three ``TrainStep`` steps of the tiny LLaMA (AdamW with
  ClipGradByGlobalNorm, accum_steps 1 and 2), the tiny ERNIE at rate 0
  (AdamW) and ResNet-50 at 32 x 32 (Momentum) against the reference's
  ``paddle.jit.TrainStep``, at the tolerances of test_torch_train_step.py,
  test_torch_bert.py and test_torch_resnet.py; each runs one program.
- ``adam_update_dense`` against the reference's ``AdamW._apply_update``
  over three steps: float32 within 1e-6 of each tensor's scale (as
  test_torch_optimizer.py), bf16 bit for bit with the port's own chain
  (``Optimizer._apply_update``), decay on and off.
- What a captured step relies on: the optimizer's state tensors keep their
  storage across steps; ``set_lr`` reaches the next step through the staged
  input; a returned loss is the caller's own; the program key changes with
  the batch's shape, a replaced ``Parameter`` and the trainable set, and
  nothing else; the capture tally takes a launch from any thread on the
  capturing stream and none from another stream.
"""
import threading
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_reference_state, to_reference_state
from paddle_tpu_torch.jit.graphs import Program, Programs
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_adam as FA

B, S, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4  # of each tensor's max |p| (test_torch_train_step.py)


def _ref_state(m):
    return {k: np.asarray(v._value) for k, v in m.state_dict().items()}


def _llama(seed=3):
    paddle.seed(seed)
    jm = JLlama(JConfig.tiny(tensor_parallel=False))
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), _ref_state(jm))
    return jm, tm


def _tokens(cfg, seed, b=B):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, S)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (b, S)).astype(np.int64)
    return ids, labels


def _labels_loss(m):
    return lambda ids, labels: m(ids, labels=labels)[0]


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1_clip", "accum2_clip"])
def test_llama_program_steps_match_reference(accum):
    jm, tm = _llama()
    jstep = paddle.jit.TrainStep(jm, _labels_loss(jm), jopt.AdamW(
        3e-4, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=jnn.ClipGradByGlobalNorm(1.0)), accum_steps=accum)
    tstep = tjit.TrainStep(tm, _labels_loss(tm), topt.AdamW(
        3e-4, weight_decay=0.01, grad_clip=tnn.ClipGradByGlobalNorm(1.0)), accum_steps=accum)
    for i in range(STEPS):
        ids, labels = _tokens(tm.config, 40 + i)
        want = float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
        got = tstep(torch.from_numpy(ids), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    assert len(tstep.programs.keys()) == 1 and tstep.optimizer._step_count == STEPS
    got, want = to_reference_state(tm), _ref_state(jm)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=PARAM_ATOL * np.abs(want[k]).max(), err_msg=k)


def test_ernie_program_steps_match_reference():
    """Rate 0, AdamW(1e-4, weight_decay=0.01) as bench.py: the losses within
    LOSS_RTOL; the parameters as test_torch_bert.py holds them (a tensor
    that starts at zero within 1% of one step, 1e-3 of a tensor's elements
    allowed a step the other way, the key bias held to 2 x 3 lr)."""
    from paddle_tpu.models.bert import BertConfig as JBConfig
    from paddle_tpu.models.bert import ErnieForPretraining as JErnie
    from paddle_tpu_torch.models import BertConfig, ErnieForPretraining

    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(3)
    jm = JErnie(JBConfig.tiny(**no_drop))
    tm = load_reference_state(ErnieForPretraining(BertConfig.tiny(**no_drop), device="cpu"),
                              _ref_state(jm))
    lr, b, s, p = 1e-4, 4, 128, 20

    def loss_of(m):
        return lambda ids, seg, pos, labels, nsp: m(
            ids, token_type_ids=seg, masked_lm_labels=labels, next_sentence_label=nsp,
            masked_positions=pos)[0]

    jstep = paddle.jit.TrainStep(jm, loss_of(jm), jopt.AdamW(lr, weight_decay=0.01,
                                                             parameters=jm.parameters()))
    tstep = tjit.TrainStep(tm, loss_of(tm), topt.AdamW(lr, weight_decay=0.01))
    cfg = tm.config
    for i in range(STEPS):
        rng = np.random.RandomState(20 + i)
        batch = (rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 (rng.rand(b, s) > 0.5).astype(np.int32),
                 np.stack([rng.choice(s, p, replace=False) for _ in range(b)]).astype(np.int32),
                 rng.randint(0, cfg.vocab_size, (b, p)).astype(np.int32),
                 rng.randint(0, 2, (b, 1)).astype(np.int32))
        want = float(jstep(*(paddle.to_tensor(a) for a in batch)).item())
        got = float(tstep(*(torch.from_numpy(a) for a in batch)))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert len(tstep.programs.keys()) == 1
    got, want = to_reference_state(tm), _ref_state(jm)
    h = cfg.hidden_size
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("attention.qkv.bias"):
            np.testing.assert_allclose(g[h:2 * h], w[h:2 * h], rtol=0, atol=2 * 3 * lr,
                                       err_msg=k)
            g, w = np.delete(g, np.s_[h:2 * h]), np.delete(w, np.s_[h:2 * h])
        err = np.abs(g - w)
        tight = max(PARAM_ATOL * np.abs(w).max(), 1e-2 * lr)
        assert err.max() <= 2 * 3 * lr, (k, err.max())
        assert (err > tight).mean() <= 1e-3, (k, (err > tight).sum(), err.max())


def test_resnet_program_steps_match_reference():
    """ResNet-50 (NCHW, 10 classes) at B 8 x 32 x 32 with Momentum(0.01,
    0.9): the losses within test_torch_resnet.py's LOSS_ATOL, the
    parameters' displacement within its STEP_GLOBAL, and the BatchNorm
    running statistics as it holds them."""
    import test_torch_resnet as R

    jm, tm = R._models("NCHW", seed=5)
    x, y = R._batch("NCHW", seed=9)
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jstep = paddle.jit.TrainStep(jm, lambda a, b: jce(jm(a), b), jopt.Momentum(
        learning_rate=R.LR, momentum=0.9, parameters=jm.parameters()))
    tstep = tjit.TrainStep(tm, lambda a, b: tce(tm(a), b),
                           topt.Momentum(learning_rate=R.LR, momentum=0.9))
    start = _ref_state(jm)
    for _ in range(STEPS):
        lj = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).item())
        lt = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(lj - lt) < R.LOSS_ATOL, (lj, lt)
    assert len(tstep.programs.keys()) == 1
    ref, got = _ref_state(jm), to_reference_state(tm)
    params = [n for n, _ in tm.named_parameters()]
    flat = lambda st: np.concatenate([st[n].ravel() - start[n].ravel() for n in params])  # noqa: E731
    assert np.linalg.norm(flat(got) - flat(ref)) / np.linalg.norm(flat(ref)) < R.STEP_GLOBAL
    for n in ref:
        if n.endswith("._mean"):
            np.testing.assert_allclose(got[n], ref[n], atol=5e-3, rtol=1e-3, err_msg=n)
        elif n.endswith("._variance"):
            np.testing.assert_allclose(got[n], ref[n], atol=5e-3, rtol=5e-3, err_msg=n)


@pytest.mark.parametrize("decay", [0.01, 0.0], ids=["decay", "no_decay"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_update_matches_reference_chain(dtype, decay):
    """Three steps of ``adam_update_dense`` on three parameters: float32
    against the reference's ``AdamW._apply_update`` within 1e-6 of each
    tensor's scale; bf16 bit for bit against the port's
    ``Optimizer._apply_update`` (the chain it replaces), both in place."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    shapes = [(8, 6), (6,), (5, 4)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 0.7).astype(np.float32) for s in shapes] for _ in range(STEPS)]
    tdt = getattr(torch, dtype)
    ps = [torch.from_numpy(p).to(tdt, copy=True) for p in p0]
    opt = topt.AdamW(0.05, weight_decay=decay)
    states = [opt._init_state(p) for p in ps]
    first = [dict(st) for st in states]
    lr = torch.tensor(0.05, dtype=torch.float32)
    chain_p = [p.clone() for p in ps]
    chain_st = [opt._init_state(p) for p in ps]
    for gs in grads:
        for i, g in enumerate(gs):
            gt = torch.from_numpy(g).to(tdt)
            FA.adam_update_dense(ps[i], gt, states[i], lr, decay, "decoupled", 0.9, 0.999, 1e-8)
            chain_p[i], chain_st[i] = opt._apply_update(chain_p[i], gt, chain_st[i], lr,
                                                        (decay, "decoupled", 1.0))
    for st, st0 in zip(states, first):  # written in place
        assert all(st[k] is st0[k] for k in st)
    if dtype == "bfloat16":
        for p, st, cp, cst in zip(ps, states, chain_p, chain_st):
            assert torch.equal(p, cp) and all(torch.equal(st[k], cst[k]) for k in st)
        return
    jo = jopt.AdamW(0.05, weight_decay=decay)
    named = [types.SimpleNamespace(_value=jnp.asarray(p), name="") for p in p0]
    vals = [n._value for n in named]
    jst = [jo._init_state(n) for n in named]
    for gs in grads:
        for i, g in enumerate(gs):
            vals[i], jst[i] = jo._apply_update(vals[i], jnp.asarray(g), jst[i],
                                               jnp.asarray(0.05, jnp.float32),
                                               jo._param_decay_coeff(named[i]))
    for p, st, v, js in zip(ps, states, vals, jst):
        for got, want in [(p, v)] + [(st[k], js[k]) for k in st]:
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * max(np.abs(want).max(), 1e-30))


def test_state_is_written_in_place_and_lr_reaches_the_next_step():
    """The optimizer's state tensors keep their storage across steps (a
    captured step reads them at every replay); set_lr between calls is
    the next step's lr, through the staged input of the same program: at
    lr 0 AdamW leaves every parameter as it was."""
    _, tm = _llama()
    opt = topt.AdamW(1e-2, weight_decay=0.01)
    step = tjit.TrainStep(tm, _labels_loss(tm), opt)
    ids, labels = (torch.from_numpy(a) for a in _tokens(tm.config, 7))
    step(ids, labels)
    ptrs = {id(p): [t.data_ptr() for t in opt._accumulators[p].values()]
            for p in tm.parameters()}
    step(ids, labels)
    assert all([t.data_ptr() for t in opt._accumulators[p].values()] == ptrs[id(p)]
               for p in tm.parameters())
    opt.set_lr(0.0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step(ids, labels)
    assert all(torch.equal(p, before[n]) for n, p in tm.named_parameters())
    opt.set_lr(1e-2)
    step(ids, labels)
    assert not torch.equal(tm.llama.embed_tokens.weight, before["llama.embed_tokens.weight"])
    assert len(step.programs.keys()) == 1 and opt._step_count == 4


def test_returned_loss_is_the_callers_own():
    """On CPU the body's outputs are new tensors each call; a replayed
    program made with fresh=True hands out copies of its static outputs,
    so a kept loss does not change when the next replay writes them (a
    stand-in graph replays here)."""
    _, tm = _llama()
    step = tjit.TrainStep(tm, _labels_loss(tm), topt.AdamW(1e-2))
    ids, labels = (torch.from_numpy(a) for a in _tokens(tm.config, 8))
    first = step(ids, labels)
    kept = first.clone()
    step(ids, labels)
    assert torch.equal(first, kept)

    owner = Programs("cpu")
    out = torch.zeros(())
    prog = Program(owner, "k", lambda: out, {}, fresh=True)
    owner.cuda = True  # replay as on a card, with no staged input to upload
    prog.graph = types.SimpleNamespace(replay=lambda: out.add_(1.0))
    prog.outputs = (out, 3)
    a, n = prog()
    b, _ = prog()
    assert (float(a), float(b), n) == (1.0, 2.0, 3) and a is not out


def test_program_key_follows_what_the_step_bakes():
    _, tm = _llama()
    opt = topt.AdamW(1e-3)
    step = tjit.TrainStep(tm, _labels_loss(tm), opt)
    ids, labels = (torch.from_numpy(a) for a in _tokens(tm.config, 9))
    step(ids, labels)
    step(ids, labels)
    assert len(step.programs.keys()) == 1                  # the same ones reuse it
    step(ids[:2], labels[:2])
    assert len(step.programs.keys()) == 2                  # a new batch shape
    step(ids, labels)
    assert len(step.programs.keys()) == 2
    old = tm.llama.norm.weight
    tm.llama.norm.weight = torch.nn.Parameter(old.detach().clone())
    step(ids, labels)
    assert len(step.programs.keys()) == 3                  # a replaced Parameter
    tm.lm_head.weight.requires_grad_(False)
    step(ids, labels)
    assert len(step.programs.keys()) == 4                  # another trainable set
    step(ids, labels)
    assert len(step.programs.keys()) == 4
    step.free_programs()
    assert step.programs.keys() == []


def test_capture_tally_takes_every_thread_on_the_capturing_stream(monkeypatch):
    """A launch that another thread (autograd's worker) makes on the
    capturing stream goes into the capture's tally; one on another stream
    counts at once.  Streams are stand-ins: a thread-local handle."""
    from paddle_tpu_torch.ops import flash_attention as fa

    local = threading.local()
    monkeypatch.setattr(_build, "_capture_stream", lambda: getattr(local, "stream", None))
    fn = fa.flash_attention_dq_kernel
    before = fn.launches

    def launch(stream):
        local.stream = stream
        _build.count(fn)

    with _build.capture_tally(11) as tally:
        for stream in (11, 11, 12, None):
            t = threading.Thread(target=launch, args=(stream,))
            t.start()
            t.join()
    assert tally == {(fn, "launches"): 2} and fn.launches == before + 2
    with pytest.raises(RuntimeError, match="already has a capture tally"):
        with _build.capture_tally(13), _build.capture_tally(13):
            pass
