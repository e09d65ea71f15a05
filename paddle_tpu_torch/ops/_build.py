"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a
-shared -Xcompiler -fPIC``), which the op wrappers load with ``ctypes``.
This builds in seconds, where a source that includes PyTorch's headers
takes minutes.  Libraries land in ``paddle_tpu_torch/build/kernels/``
(ignored by git through ``.gitignore``'s ``build/``), named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads.

Nothing here runs at import time, so every module imports on a machine
without nvcc or a card (the CPU tests rely on it).  ``build_all()`` starts
one nvcc per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_libs: dict[str, ctypes.CDLL] = {}

# while this thread captures a CUDA graph (jit/graphs.py), the tally that
# count() adds the captured launches to; None otherwise
_capture = threading.local()


def count(fn, attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel (or, with ``attr``, one event of another
    counter): adds one to ``fn.<attr>``.  A launch made while this thread's
    current stream captures a graph for ``jit/graphs.py`` runs only when
    the graph replays, so it goes into the capture's tally instead, which
    the program checks against the graph's kernel nodes and adds at each
    replay."""
    tally = getattr(_capture, "tally", None)
    if tally is not None and _capturing():
        tally[(fn, attr)] = tally.get((fn, attr), 0) + 1
    else:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _capturing() -> bool:
    import torch

    return torch.cuda.is_current_stream_capturing()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH, or /usr/local/cuda; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of paddle_tpu_torch build at first use")


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):  # .cu and shared .cuh headers
        if p.suffix == ".cuh" or p.stem == name:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None, ptxas_verbose=False) -> dict:
    """Compile every (or the named) kernel source that has no library yet,
    one nvcc process per source, all started together.  Returns
    ``{name: {"path", "seconds", "built", "log"}}``; raises RuntimeError
    with nvcc's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = _lib_path(name)
        if target.is_file() and not ptxas_verbose:
            out[name] = {"path": str(target), "seconds": 0.0, "built": False,
                         "log": ""}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half
        out[name] = {"path": str(target),
                     "seconds": time.perf_counter() - t0, "built": True,
                     "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = _libs[name] = ctypes.CDLL(path)
    return lib


def launch(name: str, argtypes, *args, entry: str | None = None) -> None:
    """Call ``<entry>_launch(*args)`` of kernel source ``name`` (``entry``
    defaults to ``name``; a source with several entry points names each,
    and all return a cudaError_t) and raise RuntimeError with the CUDA
    error string unless it returned 0.  ``argtypes`` are the ctypes types:
    c_void_p for every pointer and the stream, or ctypes would pass them as
    32-bit ints."""
    lib = load(name)
    fn = getattr(lib, f"{entry or name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        msg = getattr(lib, f"{name}_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry or name} kernel launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())
