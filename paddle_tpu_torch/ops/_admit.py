"""Admission of the attention kernels by type: which kernel, and which
instantiation of it, a call runs.

The reference's attention kernels take any float type and type their
outputs by q.  On the card every attention kernel runs on the tensor cores:
the flash and encoder kernels, forward and backward
(``csrc/flash_attention.cu``, ``flash_attention_bwd.cu``,
``encoder_attention.cu``, ``encoder_attention_bwd.cu``), at bfloat16,
float16 and float32, one ``wgmma`` design each, instantiated at either
2-byte type and at float32, whose products are split-bf16
(``split_bf16.cuh``: two bf16 planes an operand, three bf16 products a
product); ``TC_TYPES`` lists the types, whose entries take the type codes
``TC_TYPE_CODES``.  The decode and paged kernels (``decode_attention.cu``,
``paged_attention.cu``, one body in ``kv_attention.cuh``) take the (q, cache)
type pairs of ``KV_PAIRS``, float32 as split-bf16 products too, through
entries that take the type codes ``KV_TYPE_CODES``.  Nothing is cast to
reach a kernel: a call whose types have no kernel raises.

``admit`` is the one place that decides, a pure function of (regime, q
type, cache type, head dim, query rows a kv head).  Its decode and paged
lists below are the ``KV_*`` instantiation lists of ``kv_attention.cuh``,
which a CPU test parses and holds equal to them, as it holds ``TC_TYPES``
and ``TC_TYPE_CODES`` to the type lists of the flash and encoder sources.
The flash and decode kernels take head dims 64, 128 and 256 at every type,
the encoder kernels 64 and 128.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32, F16, BF16, I8 = torch.float32, torch.float16, torch.bfloat16, torch.int8

# kv_attention.cuh KV_TYPES, KV_PAIRS and KV_DIMS: the C types and type
# codes of q and of the caches, the (q, kv) pairs the decode and paged
# kernels are built for, and their head dims.  A float16 model's engines
# keep float32 caches (the reference's choice for every model that is not
# bfloat16), so a float16 q meets float32 k and v there, and float16 ones
# in generate().
C_TYPES = {F32: "float", BF16: "__nv_bfloat16", F16: "__half", I8: "int8_t"}
KV_TYPE_CODES = {F32: 0, BF16: 1, F16: 2, I8: 3}
KV_PAIRS = ((BF16, BF16), (BF16, I8), (F32, F32), (F16, F16), (F16, F32), (F32, I8), (F16, I8))
KV_DIMS = (64, 128, 256)
# The q types of the flash and encoder kernels, forward and backward
# (csrc/flash_attention.cu FLASH_TYPES, flash_attention_bwd.cu
# FLASH_BWD_TYPES, encoder_attention.cu ENCODER_TYPES,
# encoder_attention_bwd.cu ENCODER_BWD_TYPES), and the type codes those
# four entries take, one table for their wrappers.
TC_TYPES = {"flash": (BF16, F16, F32), "flash_bwd": (BF16, F16, F32),
            "encoder": (BF16, F16, F32), "encoder_bwd": (BF16, F16, F32)}
TC_TYPE_CODES = {BF16: 1, F16: 2, F32: 0}
# Query rows of one kv head up to which the decode and paged kernels run
# their split-K decode regime (16-row blocks); more run the chunk regime.
DECODE_ROWS = 16

REGIMES = ("decode", "paged", "flash", "encoder", "flash_bwd", "encoder_bwd")
_LIBS = {"decode": "decode_attention", "paged": "paged_attention",
         "flash": "flash_attention", "encoder": "encoder_attention",
         "flash_bwd": "flash_attention_bwd", "encoder_bwd": "encoder_attention_bwd"}


class Instantiation(NamedTuple):
    """What a call runs: the kernel library (``csrc/<lib>.cu``), its q and
    k/v types, the head dim and, for decode and paged, whether the rows
    take the split-K decode regime (True) or the chunk regime (False)."""
    lib: str
    q: torch.dtype
    kv: torch.dtype
    D: int
    split_k: bool | None = None


def _names(dtypes):
    return ", ".join(str(d).replace("torch.", "") for d in dtypes)


def admit(regime, q_dtype, kv_dtype=None, D=None, rows=1):
    """The kernel and instantiation that attention ``regime`` runs for q of
    ``q_dtype`` against k/v of ``kv_dtype`` (None: q's type) at head dim
    ``D`` with ``rows`` query rows a kv head (S * H / Hkv; decode and paged
    only).  Raises ValueError, naming what is admitted, where no kernel is
    built.  Head dims of the flash and encoder kernels are left to their
    own checks; decode and paged take KV_DIMS (others: ROADMAP Queue 2,
    item 9)."""
    if regime not in REGIMES:
        raise ValueError(f"attention admission: unknown regime {regime!r}")
    kv_dtype = q_dtype if kv_dtype is None else kv_dtype
    if q_dtype not in (BF16, F32, F16):
        raise ValueError(f"attention kernel ({regime}): q dtype {q_dtype}; the kernels take "
                         f"{_names((BF16, F32, F16))}")
    if regime not in ("decode", "paged"):
        if kv_dtype != q_dtype:
            raise ValueError(f"attention kernel ({regime}): q {_names((q_dtype,))} takes k/v "
                             f"of {_names((q_dtype,))}, got {kv_dtype}")
        return Instantiation(_LIBS[regime], q_dtype, kv_dtype, D)
    if (q_dtype, kv_dtype) not in KV_PAIRS:
        raise ValueError(f"attention kernel ({regime}): q {q_dtype} with k/v {kv_dtype}; "
                         "the pairs built are " + "; ".join(
                             f"q {_names((a,))} k/v {_names((b,))}" for a, b in KV_PAIRS))
    if D not in KV_DIMS:
        raise ValueError(f"attention kernel ({regime}): head dim {D}, the decode and paged "
                         f"kernels are built for {KV_DIMS} (other head dims: ROADMAP Queue 2, "
                         "item 9)")
    return Instantiation(_LIBS[regime], q_dtype, kv_dtype, D, rows <= DECODE_ROWS)
