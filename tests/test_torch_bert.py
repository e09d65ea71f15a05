"""Port parity for the encoder slice as a whole: paddle_tpu_torch's BERT/ERNIE
(models/bert.py) against the JAX reference's on the CPU, in f32, at
dropout 0 (the two platforms draw different masks by design).

- The converter carries the reference's ERNIE state in and out unchanged:
  the tied MLM decoder weight lives under one name only,
  ``bert.embeddings.word_embeddings.weight``, beside ``cls.decoder_bias``,
  and the task-type embedding is there.
- ``BertModel``'s sequence and pooled outputs, the MLM and NSP logits and
  the pretraining loss agree within 1e-5 (relative for the loss, absolute
  on outputs of O(1)-O(30) scaled by their max), with a 2-D
  ``attention_mask`` and with ``masked_positions`` in both the [B, P] and
  the pre-offset flat form.
- Three ``TrainStep`` + ``AdamW(1e-4, weight_decay=0.01)`` steps (bench.py's
  optimizer) on a tiny ERNIE against ``paddle.jit.TrainStep``: the losses
  within 1e-5 relative, the parameters afterwards within 1e-4 of each
  tensor's max |p|, as test_torch_train_step.py holds LLaMA's, or, for a
  tensor that starts at zero (the biases, whose max |p| is a few steps of
  lr), within 1% of one step, about what the first rule allows LLaMA's
  projections (1e-4 of 0.05 against a 3e-4 step).  Adam moves an element
  whose gradient is near zero by up to lr a step, in a direction that
  rounding can flip, so at most 1e-3 of a tensor's elements may miss that
  bound, and none by more than 2 * 3 * lr; the attention's key bias, whose
  gradient is 0 but for rounding (the softmax ignores the q.b it adds to a
  row), is held to that last bound alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.bert import BertModel as JBert
from paddle_tpu.models.bert import ErnieForPretraining as JErnie
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_reference_state, to_reference_state
from paddle_tpu_torch.models import BertConfig, BertModel, ErnieForPretraining

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4  # of each tensor's max |p|
STEP_ATOL = 1e-2   # of one Adam step (lr), for tensors that start at zero
FLIP_SHARE = 1e-3  # of a tensor's elements may take a step the other way
LR = 1e-4
B, S, P = 4, 128, 20


def _ref_state(m):
    return {k: np.asarray(v._value) for k, v in m.state_dict().items()}


def _ernie(seed=0, **over):
    paddle.seed(seed)
    jm = JErnie(JConfig.tiny(**NO_DROP, **over))
    tm = load_reference_state(ErnieForPretraining(BertConfig.tiny(**NO_DROP, **over),
                                                  device="cpu"), _ref_state(jm))
    return jm, tm


def _batch(cfg, seed, b=B):
    """bench.py _bench_ernie's batch at a small size: int32 ids and
    segments, 20 distinct masked positions a row, their labels, and NSP
    labels [B, 1]."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, S)).astype(np.int32)
    seg = (rng.rand(b, S) > 0.5).astype(np.int32)
    pos = np.stack([rng.choice(S, P, replace=False) for _ in range(b)]).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (b, P)).astype(np.int32)
    labels[0, :3] = -100  # ignored rows
    nsp = rng.randint(0, 2, (b, 1)).astype(np.int32)
    return ids, seg, pos, labels, nsp


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy() / max(1.0, np.abs(want).max()),
                               want / max(1.0, np.abs(want).max()), rtol=0, atol=tol,
                               err_msg=msg)


def test_converter_round_trip_keeps_the_tied_weight_under_one_name():
    jm, tm = _ernie(seed=4)
    want = _ref_state(jm)
    own = tm.state_dict()
    assert set(own) == set(want)
    assert "bert.embeddings.word_embeddings.weight" in own and "cls.decoder_bias" in own
    assert "bert.embeddings.task_type_embeddings.weight" in own
    assert not any(k.startswith("cls.") and "embedding" in k for k in own)
    assert len(list(tm.parameters())) == len(want)  # the tied weight counted once
    got = to_reference_state(tm)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the decoder reads the embedding's Parameter itself, before and after .to()
    emb = tm.bert.embeddings.word_embeddings
    assert tm.cls._tied_embedding is emb
    bf = tm.to(torch.bfloat16)
    assert bf.cls._tied_embedding.weight is bf.bert.embeddings.word_embeddings.weight
    assert bf.cls._tied_embedding.weight.dtype == torch.bfloat16


def test_config_is_not_mutated_and_tensor_parallel_raises():
    cfg = BertConfig.tiny(**NO_DROP)
    m = ErnieForPretraining(cfg, device="cpu")
    assert cfg.use_task_id is False and m.config.use_task_id is True
    assert BertConfig.base().hidden_size == 768 and BertConfig.base().layer_norm_eps == 1e-12
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ErnieForPretraining(BertConfig.tiny(tensor_parallel=True), device="cpu")


def test_bert_model_outputs_match_reference_with_attention_mask():
    paddle.seed(2)
    jcfg = JConfig.tiny(**NO_DROP)
    jb = JBert(jcfg)
    tb = BertModel(BertConfig.tiny(**NO_DROP), device="cpu")
    tb.load_state_dict({k: v for k, v in _convert(jb, tb).items()})
    ids, seg, _, _, _ = _batch(jcfg, 3)
    mask = np.ones((B, S), np.int32)
    mask[1, 100:] = 0
    mask[3, 7:] = 0
    jseq, jpool = jb(paddle.to_tensor(ids), paddle.to_tensor(seg), paddle.to_tensor(mask))
    T = torch.from_numpy
    tseq, tpool = tb(T(ids), T(seg), T(mask))
    _close(tseq, jseq._value, msg="sequence")
    _close(tpool, jpool._value, msg="pooled")


def _convert(jmodel, tmodel):
    from paddle_tpu_torch.convert import convert_state_dict

    return convert_state_dict(_ref_state(jmodel), tmodel)


@pytest.mark.parametrize("form", ["per_row", "flat"])
def test_pretraining_logits_and_loss_match_reference(form):
    jm, tm = _ernie(seed=1)
    ids, seg, pos, labels, nsp = _batch(tm.config, 5)
    if form == "flat":  # the reference pipeline's pre-offset positions
        pos = (pos + np.arange(B)[:, None] * S).reshape(-1).astype(np.int32)
    J, T = paddle.to_tensor, torch.from_numpy
    jl, jmlm = jm(J(ids), token_type_ids=J(seg), masked_lm_labels=J(labels),
                  next_sentence_label=J(nsp), masked_positions=J(pos))
    tl, tmlm = tm(T(ids), token_type_ids=T(seg), masked_lm_labels=T(labels),
                  next_sentence_label=T(nsp), masked_positions=T(pos))
    np.testing.assert_allclose(float(tl), float(jl.item()), rtol=LOSS_RTOL)
    _close(tmlm, jmlm._value, msg="mlm logits")
    assert tmlm.shape == (B * P, tm.config.vocab_size)
    jm2, jnsp = jm(J(ids), token_type_ids=J(seg), masked_positions=J(pos))
    tm2, tnsp = tm(T(ids), token_type_ids=T(seg), masked_positions=T(pos))
    _close(tnsp, jnsp._value, msg="nsp logits")
    _close(tm2, jm2._value, msg="mlm logits without labels")


def test_adamw_steps_match_reference():
    jm, tm = _ernie(seed=3)

    def jloss(ids, seg, pos, labels, nsp):
        return jm(ids, token_type_ids=seg, masked_lm_labels=labels, next_sentence_label=nsp,
                  masked_positions=pos)[0]

    def tloss(ids, seg, pos, labels, nsp):
        return tm(ids, token_type_ids=seg, masked_lm_labels=labels, next_sentence_label=nsp,
                  masked_positions=pos)[0]

    # bench.py _bench_ernie's optimizer
    jstep = paddle.jit.TrainStep(jm, jloss, paddle.optimizer.AdamW(
        LR, weight_decay=0.01, parameters=jm.parameters()))
    tstep = tjit.TrainStep(tm, tloss, topt.AdamW(LR, weight_decay=0.01))
    losses = []
    for i in range(3):
        batch = _batch(tm.config, 10 + i)
        want = float(jstep(*(paddle.to_tensor(a) for a in batch)).item())
        got = float(tstep(*(torch.from_numpy(a) for a in batch)))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        losses.append(got)
    got = to_reference_state(tm)
    want = _ref_state(jm)
    assert set(got) == set(want)
    h = tm.config.hidden_size
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("attention.qkv.bias"):
            # the key bias adds q.b to every score of a row, which the softmax
            # ignores: its gradient is 0 up to rounding, and Adam moves each of
            # its elements by lr a step in a direction the rounding picks
            np.testing.assert_allclose(g[h:2 * h], w[h:2 * h], rtol=0, atol=2 * 3 * LR,
                                       err_msg=k)
            g, w = np.delete(g, np.s_[h:2 * h]), np.delete(w, np.s_[h:2 * h])
        err = np.abs(g - w)
        tight = max(PARAM_ATOL * np.abs(w).max(), STEP_ATOL * LR)
        assert err.max() <= 2 * 3 * LR, (k, err.max())
        assert (err > tight).mean() <= FLIP_SHARE, (k, (err > tight).sum(), err.max())


def test_dropout_training_is_reproducible_from_the_seed():
    """With dropout on (CPU: F.dropout and the plain fused-LN and dense
    attention paths), seed(s) fixes the loss; another seed changes it; the
    loss falls over three steps on one batch."""
    from paddle_tpu_torch import seed

    tm = ErnieForPretraining(BertConfig.tiny(), device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    batch = [torch.from_numpy(a) for a in _batch(tm.config, 20)]

    def loss_fn(ids, seg, pos, labels, nsp):
        return tm(ids, token_type_ids=seg, masked_lm_labels=labels, next_sentence_label=nsp,
                  masked_positions=pos)[0]

    with torch.no_grad():
        seed(1)
        a = loss_fn(*batch)
        seed(1)
        b = loss_fn(*batch)
        seed(2)
        c = loss_fn(*batch)
        tm.eval()
        d, e = loss_fn(*batch), loss_fn(*batch)
        tm.train()
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)
    step = tjit.TrainStep(tm, loss_fn, topt.AdamW(1e-3, weight_decay=0.01))
    losses = [float(step(*batch)) for _ in range(3)]
    assert losses[2] < losses[0]
