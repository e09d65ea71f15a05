"""Admission of the attention kernels by type: which kernel, and which
instantiation of it, a call runs.

The reference's attention kernels take any float type and type their
outputs by q.  On the card, the flash and encoder kernels, forward and
backward (``csrc/flash_attention.cu``, ``flash_attention_bwd.cu``,
``encoder_attention.cu``, ``encoder_attention_bwd.cu``), run on the tensor
cores at bfloat16, float16 and float32: one ``wgmma`` design each,
instantiated at either 2-byte type and at float32, whose products are
split-bf16 (``split_bf16.cuh``: two bf16 planes an operand, three bf16
products a product); ``TC_TYPES`` lists the types, whose entries take the
type codes ``TC_TYPE_CODES``.  Decode and paged run the tensor-core kernels
(``decode_attention.cu``, ``paged_attention.cu``) at bfloat16, and the f32
CUDA-core body of ``csrc/attention_simt.cuh`` at float32 and float16
(``attention_simt_decode.cu``, ``attention_simt_paged.cu``).  Nothing is
cast to reach a kernel: a call whose types have no kernel raises.

``admit`` is the one place that decides, a pure function of (regime, q
type, cache type, head dim, query rows a kv head).  Its decode and paged
lists below are the ``SIMT_*`` instantiation lists of
``attention_simt.cuh``, which a CPU test parses and holds equal to them, as
it holds ``TC_TYPES`` and ``TC_TYPE_CODES`` to the type lists of the
tensor-core flash and encoder sources.  The flash kernels take head dims
64, 128 and 256 at every type, the encoder kernels 64 and 128.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32, F16, BF16, I8 = torch.float32, torch.float16, torch.bfloat16, torch.int8

# The C types of the instantiation lists, and the type codes the entries take.
C_TYPES = {F32: "float", F16: "__half", I8: "int8_t"}
TYPE_CODES = {F32: 0, F16: 1, I8: 2}

# attention_simt.cuh SIMT_KV_PAIRS and SIMT_KV_DIMS: (q, kv) types of the
# decode and paged kernels.  A float16 model's engines keep float32 caches
# (the reference's choice for every model that is not bfloat16), so a
# float16 q meets float32 k and v there, and float16 ones in generate().
KV_PAIRS = ((F32, F32), (F16, F16), (F16, F32), (F32, I8), (F16, I8))
KV_DIMS = (64, 128, 256)
# The q types of the tensor-core kernels: bfloat16 but for flash and the
# encoder, forward and backward, which run float16 and float32 too
# (csrc/flash_attention.cu FLASH_TYPES, flash_attention_bwd.cu
# FLASH_BWD_TYPES, encoder_attention.cu ENCODER_TYPES,
# encoder_attention_bwd.cu ENCODER_BWD_TYPES), and the type codes those
# four entries take, one table for their wrappers.
TC_TYPES = {"flash": (BF16, F16, F32), "flash_bwd": (BF16, F16, F32),
            "encoder": (BF16, F16, F32), "encoder_bwd": (BF16, F16, F32)}
TC_TYPE_CODES = {BF16: 1, F16: 2, F32: 0}
# The bfloat16 kernels' caches: bfloat16, or int8 with f32 scales.
BF16_KV = (BF16, I8)
# Query rows of one kv head up to which the decode regime (split-K, 16-row
# blocks) runs; more run in 64-row tiles.
DECODE_ROWS = 16
CHUNK_ROWS = 64

REGIMES = ("decode", "paged", "flash", "encoder", "flash_bwd", "encoder_bwd")
_TC_LIBS = {"decode": "decode_attention", "paged": "paged_attention",
            "flash": "flash_attention", "encoder": "encoder_attention",
            "flash_bwd": "flash_attention_bwd", "encoder_bwd": "encoder_attention_bwd"}


class Instantiation(NamedTuple):
    """What a call runs: the kernel library (``csrc/<lib>.cu``), its q and
    k/v types, the head dim and, for the f32 CUDA-core decode and paged
    bodies, the query rows a block (16: the split-K decode regime; 64)."""
    lib: str
    q: torch.dtype
    kv: torch.dtype
    D: int
    rows: int | None = None

    @property
    def simt(self):
        return self.lib.startswith("attention_simt")


def _names(dtypes):
    return ", ".join(str(d).replace("torch.", "") for d in dtypes)


def admit(regime, q_dtype, kv_dtype=None, D=None, rows=1):
    """The kernel and instantiation that attention ``regime`` runs for q of
    ``q_dtype`` against k/v of ``kv_dtype`` (None: q's type) at head dim
    ``D`` with ``rows`` query rows a kv head (S * H / Hkv; decode and paged
    only).  Raises ValueError, naming what is admitted, where no kernel is
    built.  Head dims of the tensor-core kernels are left to their own
    checks (decode and paged: ROADMAP Queue 2, item 9)."""
    if regime not in REGIMES:
        raise ValueError(f"attention admission: unknown regime {regime!r}")
    kv_dtype = q_dtype if kv_dtype is None else kv_dtype
    if q_dtype in TC_TYPES.get(regime, (BF16,)):
        want = BF16_KV if regime in ("decode", "paged") else (q_dtype,)
        if kv_dtype not in want:
            raise ValueError(f"attention kernel ({regime}): q {_names((q_dtype,))} takes k/v "
                             f"of {_names(want)}, got {kv_dtype}")
        return Instantiation(_TC_LIBS[regime], q_dtype, kv_dtype, D)
    if q_dtype not in (F32, F16):
        raise ValueError(f"attention kernel ({regime}): q dtype {q_dtype}; the kernels take "
                         f"{_names((BF16, F32, F16))}")
    # q of no tensor-core type: decode and paged at float32 and float16
    if (q_dtype, kv_dtype) not in KV_PAIRS:
        raise ValueError(f"attention kernel ({regime}): q {q_dtype} with k/v {kv_dtype}; "
                         "the pairs built are " + "; ".join(
                             f"q {_names((a,))} k/v {_names((b,))}" for a, b in KV_PAIRS))
    if D not in KV_DIMS:
        raise ValueError(f"attention kernel ({regime}): head dim {D}, the kernels are built "
                         f"for {KV_DIMS} (other head dims: ROADMAP Queue 2, item 9)")
    return Instantiation(f"attention_simt_{regime}", q_dtype, kv_dtype, D,
                         DECODE_ROWS if rows <= DECODE_ROWS else CHUNK_ROWS)
