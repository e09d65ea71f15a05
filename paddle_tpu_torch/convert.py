"""Carry weights between the reference (paddle_tpu) and the port.

The reference's ``state_dict()`` and the port's share parameter and buffer
names (``llama.layers.0.self_attn.q_proj.weight``, ``layer1.0.conv1.weight``,
``layer1.0.downsample.1._mean`` ...: the port's ``nn.Sequential`` names its
children 0, 1 as the reference's does).  The one layout change is the
Linear weight: Paddle stores ``[in, out]`` (``y = x @ W``), torch's
``nn.Linear`` ``[out, in]``, so Linear weights are transposed on the way.
Convolution weights are ``[Cout, Cin / groups, kh, kw]`` in both and
BatchNorm's running buffers (``_mean``, ``_variance``) are state in both,
so they cross as they are.
The reference arrays arrive as numpy (``np.asarray`` of each value), so
this module imports neither JAX nor the reference package;
``to_reference_state`` goes the other way, so that the port's trained
parameters can be compared with the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.layer.common import Linear


def _linear_weight_names(model):
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, Linear)}


def convert_state_dict(ref_state, model):
    """Reference ``{name: array [in, out] or other}`` -> the port's
    ``{name: torch.Tensor}`` for ``model`` (on its device and dtypes).
    Raises KeyError on a missing or unexpected name and ValueError on a
    shape that does not match after the transpose."""
    own = model.state_dict()
    linear = _linear_weight_names(model)
    missing = sorted(set(own) - set(ref_state))
    unexpected = sorted(set(ref_state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    out = {}
    for name, ref in ref_state.items():
        arr = np.asarray(ref)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot wrap it
            arr = arr.astype(np.float32)  # exact; cast back to dst below
        if name in linear:
            arr = arr.T
        dst = own[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {name}: reference "
                             f"{arr.shape} -> {tuple(dst.shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(  # a writable copy
            device=dst.device, dtype=dst.dtype)
    return out


def load_reference_state(model, ref_state):
    """Convert the reference's numpy state and load it into ``model``."""
    model.load_state_dict(convert_state_dict(ref_state, model), strict=True)
    return model


def to_reference_state(model):
    """The port's ``model.state_dict()`` in the reference's layout:
    ``{name: np.ndarray}`` on the host, Linear weights transposed back to
    ``[in, out]``.  bf16 values come back as f32 (exactly: numpy has no
    bfloat16); every other dtype as it is."""
    linear = _linear_weight_names(model)
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        out[name] = np.ascontiguousarray(arr.T if name in linear else arr)
    return out
