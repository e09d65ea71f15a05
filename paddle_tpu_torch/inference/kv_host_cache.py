"""Hierarchical kv tiers under the prefix cache: host RAM and disk
(counterpart of paddle_tpu/inference/kv_host_cache.py).

Eviction from the radix index (``prefix_cache.PrefixCache``) destroys a
prefix, so a capacity miss costs a re-prefill.  These are the two lower
tiers that turn that miss into a copy:

- **Host tier** (``HostKVPool``): page blocks as CPU tensors, keyed by the
  SAME chained block hashes as the radix index (so adapter-seeded: the
  tiers never cross adapters).  One entry is one kv page across every
  layer's pools (bf16 or f32 pairs, or int8 4-tuples with f32 scales:
  whatever ``models.kv_cache.gather_pages_to_host`` gave).  Bounded in
  pages; the least recently used entry overflows to disk.
- **Disk tier**: one file per entry, a JSON header line and the blocks'
  raw bytes, with a sha256 over the blob, written to a temporary file and
  moved into place with ``os.replace``.  A torn or corrupt file fails
  verification on load, is quarantined (renamed ``*.quarantined``, never
  retried) and reads as a miss: the engine re-prefills and never serves
  corrupt kv.  Every dtype travels as its raw bytes and comes back through
  ``torch.frombuffer`` under the dtype the header names (``"bfloat16"``
  included, which numpy cannot name), so a page returns bit for bit.

The pool owns no device memory and no lock: the engine serializes access
under its own lock and owns the counters.  A catalog (key -> tier and tail
tokens) spans both tiers, so chain walks and partial-tail matching never
touch the disk; only a confirmed promotion pays the read.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

__all__ = ["HostKVPool"]

_SCHEMA = 1
_SUFFIX = ".kvblk"


def _dtype(name):
    """A torch dtype from the name ``str(dtype)`` gave without its
    ``torch.`` prefix."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a kv spill")
    return dt


class _Entry:
    """One staged kv page: per-layer tuples of CPU tensors + tail tokens."""

    __slots__ = ("key", "parent", "ntok", "tokens", "blocks", "tier")

    def __init__(self, key, parent, ntok, tokens, blocks, tier="host"):
        self.key = key
        self.parent = parent
        self.ntok = int(ntok)
        self.tokens = tokens  # None for full blocks; np.int32 for partials
        self.blocks = blocks  # [(CPU tensors, one per pool element)] per layer
        self.tier = tier      # which tier served it (set on get())


class HostKVPool:
    """Host-RAM and disk staging tiers for demoted prefix-cache pages.

    ``host_pages`` bounds the RAM tier (entries, i.e. kv pages); overflow
    spills least recently used first to ``disk_dir`` when configured
    (bounded by ``disk_pages``, the oldest spill deleted first) and is
    dropped otherwise.  Keys are content addresses: an entry can never go
    stale while its key exists.
    """

    def __init__(self, host_pages=64, disk_dir=None, disk_pages=0):
        self.host_pages = max(0, int(host_pages))
        self.disk_dir = disk_dir
        self.disk_pages = max(0, int(disk_pages)) if disk_dir else 0
        self._host: dict[bytes, _Entry] = {}   # insertion order == LRU
        self._disk: dict[bytes, dict] = {}     # key -> catalog record
        self._partials: dict[bytes, set[bytes]] = {}  # parent -> tail keys
        self.host_bytes = 0
        self.demotions_to_disk = 0
        self.disk_loads = 0
        self.quarantined = 0
        self.dropped = 0
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)

    # ------------------------------------------------------------- lookup

    def __contains__(self, key):
        return key in self._host or key in self._disk

    def __len__(self):
        return len(self._host) + len(self._disk)

    def tier_of(self, key):
        if key in self._host:
            return "host"
        if key in self._disk:
            return "disk"
        return None

    def partial_candidates(self, parent):
        """``(key, ntok, tokens)`` of every partial tail staged under
        ``parent`` in either tier, from the in-memory catalog."""
        out = []
        for k in sorted(self._partials.get(parent, ())):
            if k in self._host:
                e = self._host[k]
                out.append((k, e.ntok, e.tokens))
            elif k in self._disk:
                rec = self._disk[k]
                out.append((k, rec["ntok"], rec["tokens"]))
        return out

    def get(self, key):
        """The staged entry for ``key`` or None.  A disk hit verifies the
        blob's checksum; any mismatch or parse failure quarantines the file
        and reads as a miss."""
        e = self._host.get(key)
        if e is not None:
            self._host[key] = self._host.pop(key)  # LRU touch
            e.tier = "host"
            return e
        rec = self._disk.get(key)
        if rec is None:
            return None
        e = self._load_spill(key, rec)
        if e is None:
            return None
        self.disk_loads += 1
        e.tier = "disk"
        return e

    # ----------------------------------------------------------- mutation

    def put(self, key, parent, ntok, tokens, blocks):
        """Stage one demoted page (idempotent by key); RAM overflow moves the
        pool's own least recently used entry to disk."""
        if key in self._host or key in self._disk or self.host_pages <= 0:
            return False
        tokens = None if tokens is None else np.asarray(tokens, np.int32)
        e = _Entry(key, parent, ntok, tokens, blocks)
        self._host[key] = e
        self.host_bytes += self._entry_bytes(e)
        if tokens is not None:
            self._partials.setdefault(parent, set()).add(key)
        while len(self._host) > self.host_pages:
            old_key, old = next(iter(self._host.items()))
            self._pop_host(old_key)
            if self.disk_pages > 0:
                self._spill(old)
                self.demotions_to_disk += 1
            else:
                self._drop_partial(old_key, old.parent)
                self.dropped += 1
        return True

    def discard(self, key):
        """Drop ``key`` from whichever tier holds it."""
        if key in self._host:
            e = self._pop_host(key)
            self._drop_partial(key, e.parent)
        elif key in self._disk:
            rec = self._disk.pop(key)
            self._drop_partial(key, rec["parent"])
            _remove(rec["path"])

    def _pop_host(self, key):
        e = self._host.pop(key)
        self.host_bytes -= self._entry_bytes(e)
        return e

    def _drop_partial(self, key, parent):
        sibs = self._partials.get(parent)
        if sibs is not None:
            sibs.discard(key)
            if not sibs:
                del self._partials[parent]

    @staticmethod
    def _entry_bytes(e):
        return sum(int(a.nbytes) for lt in e.blocks for a in lt)

    # ---------------------------------------------------------- disk tier

    def _spill_path(self, key):
        return os.path.join(self.disk_dir, key.hex() + _SUFFIX)

    def _spill(self, e):
        """Atomic spill: a JSON header line, then the blocks' raw bytes; a
        sha256 over the blob; a temporary file moved into place.  A writer
        killed mid-write leaves only the temporary file, or a torn final
        file that verification quarantines on load."""
        while len(self._disk) >= self.disk_pages:
            old_key = next(iter(self._disk))
            rec = self._disk.pop(old_key)
            self._drop_partial(old_key, rec["parent"])
            _remove(rec["path"])
        blob = b"".join(a.contiguous().view(torch.uint8).numpy().tobytes()
                        for lt in e.blocks for a in lt)
        header = {
            "schema": _SCHEMA,
            "parent": e.parent.hex(),
            "ntok": e.ntok,
            "tokens": None if e.tokens is None else e.tokens.tolist(),
            "layout": [[(str(a.dtype).replace("torch.", ""), list(a.shape)) for a in lt]
                       for lt in e.blocks],
            "sha256": hashlib.sha256(blob).hexdigest(),
            "blob_bytes": len(blob),
        }
        path = self._spill_path(e.key)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            # failing media or a torn write: the spill is lost (a tier
            # miss), never half visible
            _remove(tmp)
            self.dropped += 1
            self._drop_partial(e.key, e.parent)
            return
        self._disk[e.key] = {"path": path, "parent": e.parent, "ntok": e.ntok,
                             "tokens": e.tokens}

    def _load_spill(self, key, rec):
        """Read and verify one spill; a corrupt file is quarantined and its
        catalog entry dropped, so the caller sees a plain miss."""
        try:
            with open(rec["path"], "rb") as f:
                header = json.loads(f.readline())
                blob = bytearray(f.read())
            if (header.get("schema") != _SCHEMA or len(blob) != header["blob_bytes"]
                    or hashlib.sha256(blob).hexdigest() != header["sha256"]):
                raise ValueError("kv spill failed verification")
            blocks, off = [], 0
            for lt in header["layout"]:
                arrs = []
                for name, shape in lt:
                    dt = _dtype(name)
                    n = int(np.prod(shape))
                    arrs.append(torch.frombuffer(blob, dtype=dt, count=n,
                                                 offset=off).reshape(shape))
                    off += n * dt.itemsize
                blocks.append(tuple(arrs))
            return _Entry(key, rec["parent"], rec["ntok"], rec["tokens"], blocks)
        except (OSError, ValueError, KeyError, TypeError, RuntimeError,
                json.JSONDecodeError):
            self.quarantined += 1
            self._disk.pop(key, None)
            self._drop_partial(key, rec["parent"])
            try:
                os.replace(rec["path"], rec["path"] + ".quarantined")
            except OSError:
                pass
            return None

    # -------------------------------------------------------- diagnostics

    def stats(self):
        return {"host_entries": len(self._host), "host_pages": self.host_pages,
                "host_bytes": self.host_bytes, "disk_entries": len(self._disk),
                "disk_pages": self.disk_pages,
                "demotions_to_disk": self.demotions_to_disk,
                "disk_loads": self.disk_loads, "quarantined": self.quarantined,
                "dropped": self.dropped}


def _remove(path):
    try:
        os.remove(path)
    except OSError:
        pass
