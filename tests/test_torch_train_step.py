"""Port parity for the training slice as a whole: paddle_tpu_torch's
``TrainStep`` + ``AdamW`` + ``ClipGradByGlobalNorm`` on the tiny LLaMA
against the JAX reference's ``paddle.jit.TrainStep`` on the CPU, in f32.

Both models start from the same weights (the reference's, carried by
paddle_tpu_torch.convert) and see the same numpy-seeded batches.  After
every step the losses agree within 1e-5 relative: both sides compute in f32
and differ in summation order, which the three updates carry forward.
After the last step every parameter (read back with ``to_reference_state``)
agrees within 1e-4 of its tensor's scale (max |p|), absolute: Adam divides
by sqrt(v), so an element whose gradient is near zero moves by up to lr in
a direction that rounding can flip, while the scale of the weights is
about 1 (embeddings) or 0.05 (projections) and a step moves them by 3e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_reference_state, to_reference_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

B, S, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4  # of each tensor's max |p|


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels[0, :5] = -100  # ignored positions
    return ids, labels


def _models(seed=3):
    paddle.seed(seed)
    jm = JLlama(JConfig.tiny(tensor_parallel=False))
    ref = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), ref)
    return jm, tm


def _loss_fns(kind, jm, tm):
    V = tm.config.vocab_size
    if kind == "bench":  # bench.py _bench_llama's loss
        return (lambda ids, labels: paddle.nn.functional.cross_entropy(
                    jm(ids).reshape([-1, V]), labels.reshape([-1])),
                lambda ids, labels: TF.cross_entropy(tm(ids).reshape(-1, V), labels.reshape(-1)))
    return (lambda ids, labels: jm(ids, labels=labels)[0],
            lambda ids, labels: tm(ids, labels=labels)[0])


def _assert_params_close(tm, jm):
    got = to_reference_state(tm)
    want = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=PARAM_ATOL * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("kind,accum", [("bench", 1), ("labels", 2)],
                         ids=["bench_loss", "labels_accum2"])
def test_adamw_steps_match_reference(kind, accum):
    jm, tm = _models()
    jloss, tloss = _loss_fns(kind, jm, tm)
    wd = dict(weight_decay=0.01)
    jstep = paddle.jit.TrainStep(
        jm, jloss, paddle.optimizer.AdamW(3e-4, parameters=jm.parameters(),
                                          grad_clip=jnn.ClipGradByGlobalNorm(1.0), **wd),
        accum_steps=accum)
    topt_ = topt.AdamW(3e-4, grad_clip=tnn.ClipGradByGlobalNorm(1.0), **wd)
    tstep = tjit.TrainStep(tm, tloss, topt_, accum_steps=accum)
    losses = []
    for i in range(STEPS):
        ids, labels = _batch(tm.config, i)
        want = float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
        got = tstep(torch.from_numpy(ids), torch.from_numpy(labels))
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
        losses.append(float(got))
    assert topt_._step_count == STEPS
    _assert_params_close(tm, jm)


def test_accum_matches_full_batch():
    """accum_steps=2 over a 4-batch == one step over the same 4-batch
    (mean loss: the averaged microbatch gradients are the same)."""
    _, t1 = _models()
    _, t2 = _models()
    s1 = tjit.TrainStep(t1, _loss_fns("labels", None, t1)[1], topt.AdamW(3e-4))
    s2 = tjit.TrainStep(t2, _loss_fns("labels", None, t2)[1], topt.AdamW(3e-4), accum_steps=2)
    for i in range(STEPS):
        ids, labels = (torch.from_numpy(a) for a in _batch(t1.config, 10 + i))
        # no ignored rows here: a mean over valid rows only averages equal
        # microbatches when each holds as many of them
        labels[0, :5] = ids[0, :5]
        np.testing.assert_allclose(float(s2(ids, labels)), float(s1(ids, labels)), rtol=1e-5)
    for (k, a), b in zip(t1.state_dict().items(), t2.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=PARAM_ATOL * a.abs().max().item(), err_msg=k)


def test_loss_falls_and_aux_outputs_return():
    _, tm = _models()

    def loss_fn(ids, labels):
        loss, logits = tm(ids, labels=labels)
        return loss, logits.shape[-1]

    step = tjit.TrainStep(tm, loss_fn, topt.AdamW(1e-2))
    ids, labels = (torch.from_numpy(a) for a in _batch(tm.config, 20))
    losses = []
    for _ in range(3):
        loss, vocab = step(ids, labels)
        losses.append(float(loss))
    assert vocab == tm.config.vocab_size
    assert losses[2] < losses[1] < losses[0]


def test_indivisible_batch_and_scaler_raise():
    _, tm = _models()
    step = tjit.TrainStep(tm, _loss_fns("labels", None, tm)[1], topt.AdamW(3e-4), accum_steps=3)
    ids, labels = (torch.from_numpy(a) for a in _batch(tm.config, 0))
    with pytest.raises(ValueError, match="does not divide the batch size 4"):
        step(ids, labels)
    with pytest.raises(NotImplementedError, match="GradScaler"):
        tjit.TrainStep(tm, lambda *a: None, topt.AdamW(3e-4), scaler=object())


def test_reference_state_round_trip():
    """reference -> port -> reference is the identity on every name, shape
    and value (Linear weights transposed twice)."""
    jm, tm = _models(seed=5)
    want = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    got = to_reference_state(tm)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bf = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"),
                                               device="cpu"), want)
    back = to_reference_state(bf)
    w = "llama.layers.0.mlp.up_proj.weight"
    assert back[w].dtype == np.float32 and back[w].shape == want[w].shape
    np.testing.assert_array_equal(back[w], torch.from_numpy(want[w].copy()).bfloat16().float().numpy())
