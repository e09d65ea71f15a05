"""The training step (counterpart of paddle_tpu/jit/train_step.py).

``TrainStep(model, loss_fn, optimizer)`` keeps the reference's contract:
``step(*batch)`` runs ``loss_fn(*batch)`` (a loss, or a tuple ``(loss,
*aux)``), takes the gradients of every parameter that requires them,
averages them over ``accum_steps`` microbatches of the batch axis, clips
them with the optimizer's ``grad_clip``, applies one update to each
parameter and adds 1 to ``optimizer._step_count``.  It returns the loss, or
``(loss, *aux)``, as tensors of its own: a loss kept from one step is not
the next step's.  The batch is torch tensors.

The reference traces forward, backward and update into one XLA program,
one per input signature (``jax.jit(step, donate_argnums=(0, 2))``), with
the learning rate a traced f32 argument.  The port runs the same body as
a program of ``jit/graphs.py``: one per key, the key being what that
program bakes: the batch's shapes and dtypes, ``accum_steps``, the set of
trainable parameters, the optimizer (its scalars but the learning rate)
and its clip, the model's training mode, and the storage of every
parameter, buffer and optimizer state tensor, so that a replaced
``Parameter`` or restored optimizer state captures anew and is never
replayed stale.  A call copies the batch into the program's device
statics on the stream, stages ``get_lr()`` (an f32 scalar input, only
when it changed) and runs the program: on CUDA its first call is this
step eagerly on the capture stream (the warm-up), followed by the capture
of forward, backward, clipping and update into one CUDA graph with the
device generator registered (dropout draws what an eager step draws, and
``seed()`` reseeds the replays); every later call replays it with one
launch.  On the CPU and under ``jit.disable_graphs()`` the same body runs
eagerly, through the same staging.  A capture or a replay that fails
raises.  The update is in place, so ``donate`` is accepted and has no
effect.  The two phases carry ``torch.profiler`` labels,
``TrainStep.forward_backward`` and ``TrainStep.optimizer``, in the eager
runs.  ``scaler=`` (dynamic loss scaling) is not ported yet and raises
NotImplementedError.
"""
from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

from ..framework.random import get_generator
from ._step_impl import loss_and_grads
from .graphs import Program, Programs

# optimizer scalars that a captured step does not bake: the lr is staged,
# the step count is the host's
_UNBAKED = ("_learning_rate", "_step_count")


def _scalars(obj):
    """The Python scalars (and the ids of the callables) an object carries:
    what a captured body bakes of it."""
    if obj is None:
        return None
    out = []
    for k, v in sorted(vars(obj).items()):
        if k in _UNBAKED:
            continue
        if isinstance(v, (bool, int, float, str, type(None))):
            out.append((k, v))
        elif callable(v):
            out.append((k, id(v)))
    return (type(obj).__name__, tuple(out))


class TrainStep:
    """train_step = TrainStep(model, loss_fn, optimizer); loss = train_step(x, y)."""

    def __init__(self, model, loss_fn, optimizer, donate=True, accum_steps=1, scaler=None):
        if scaler is not None:
            raise NotImplementedError(
                "TrainStep(scaler=): GradScaler and AMP loss scaling are not ported "
                "yet (ROADMAP.md Queue 1 item 6: the rest of the surface, amp/)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._donate = donate
        self.accum_steps = max(1, int(accum_steps))
        self.scaler = None
        self.programs = None  # the step's programs (jit/graphs.py), on its first call's device

    def __call__(self, *batch):
        for b in batch:
            if not torch.is_tensor(b):
                raise TypeError(f"TrainStep takes a batch of tensors, got {type(b).__name__}")
        opt = self.optimizer
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            opt._state_for(p)  # made before the key reads its storage
        dev = params[0].device if params else batch[0].device
        if self.programs is None or self.programs.device != dev:
            self.free_programs()
            self.programs = Programs(dev)
        key = self._key(params, batch)
        prog = self.programs.get(key, lambda: self._program(key, params, batch))
        for name, b in zip(prog.batch_names, batch):
            prog.inputs[name].copy_(b)
        lr = opt.get_lr()
        if prog.staged_lr != lr:
            prog.stage(lr=lr)
            prog.staged_lr = lr
        out = prog()
        opt._step_count += 1
        return out if len(out) > 1 else out[0]

    def _key(self, params, batch):
        opt, model = self.optimizer, self.model
        state = [t for p in params for t in opt._accumulators[p].values() if torch.is_tensor(t)]
        return (tuple((tuple(b.shape), b.dtype) for b in batch), self.accum_steps,
                tuple(map(id, params)), id(opt), _scalars(opt), _scalars(opt._grad_clip),
                model.training, tuple(map(torch.Tensor.data_ptr, params)),
                tuple(map(torch.Tensor.data_ptr, model.buffers())),
                tuple(map(torch.Tensor.data_ptr, state)))

    def _program(self, key, params, batch):
        """The step's body over the batch's device statics and a staged lr.
        It holds the parameters, the loss function and the optimizer, and
        not this TrainStep, so that dropping the TrainStep frees its graphs."""
        loss_fn, opt, accum = self.loss_fn, self.optimizer, self.accum_steps
        names = [f"batch{i}" for i in range(len(batch))]
        dev = self.programs.device
        statics = {n: torch.empty(b.shape, dtype=b.dtype, device=dev)
                   for n, b in zip(names, batch)}

        def body(lr, **inputs):
            with record_function("TrainStep.forward_backward"):
                loss, aux, grads = loss_and_grads(loss_fn, params,
                                                  tuple(inputs[n] for n in names), accum)
            with record_function("TrainStep.optimizer"):
                opt._update(list(zip(params, grads)), lr)
            return (loss, *aux)

        prog = Program(self.programs, key, body, {"lr": torch.zeros((), dtype=torch.float32)},
                       generators=(get_generator(dev),), statics=statics, fresh=True,
                       release_warmup=True)
        prog.batch_names, prog.staged_lr = names, None
        return prog

    def free_programs(self):
        """Drop this step's programs and their graphs (their pool's memory
        returns to the allocator); the next call captures anew."""
        if self.programs is not None:
            self.programs.clear()

    def __del__(self):
        try:
            self.free_programs()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
