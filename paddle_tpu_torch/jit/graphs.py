"""Programs: one captured CUDA graph per shape key, the port's counterpart of
the reference's ``jax.jit`` programs (the engine's decode, verify and
prefill programs, ``generate()``'s decode step).

A ``Program`` is a body (a function of named tensors) over STATIC inputs:
tensors that live for the program's life, so that a graph can bake their
addresses.  The small inputs are views of one packed byte buffer on the
device with a pinned host twin; a call writes its values into the twin and
uploads the whole buffer with one non-blocking copy.  Inputs that live on
the device anyway (kv buffers, carried state) are ``statics``: the caller
writes them in place, on the stream, before a call.

On a CUDA device the first call of a program runs its body eagerly on the
owner's capture stream (the warm-up: cuBLAS workspaces, the split-K
tickets of ``ops/decode_attention.py``, first launches), which gives that
call's result, then captures the body into a CUDA graph in the owner's one
memory pool (only one program of an owner runs at a time) with
``capture_error_mode="thread_local"``, so another thread's copies do not
void the capture.  Every later call uploads its inputs and replays the
graph on the current stream, and its outputs are the graph's static
outputs, valid until the next call of any program of the owner.  A capture
or a replay that fails raises: nothing falls back to eager.

The kernel wrappers count their launches (``<wrapper>.launches``, through
``ops._build.count``).  A launch made while this thread captures only
records the kernel in the graph, so it goes into the capture's tally (a
thread-local one: another thread's launches count as they run).  The
capture then reads the graph's kernel nodes through the driver, names the
wrapper of each node of the port's kernels by its mangled name, and raises
unless the nodes equal the tally; each replay adds those node counts, the
launches the replay makes.

A CPU device runs every body eagerly on the same static inputs, as the
caller asked for the CPU.  ``disable_graphs()`` runs the bodies that this
thread calls eagerly on CUDA too, through the same staging: the
counterpart of ``jax.disable_jit()`` (thread-local like it), for an eager
oracle of the graphs.  ``check_syncs()`` makes this thread's staging and
replays run under ``torch.cuda.set_sync_debug_mode("error")``, a mode that
is process-wide while it is on: a tool for one thread driving the device.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["Program", "Programs", "check_syncs", "disable_graphs"]

_flags = threading.local()


@contextmanager
def _flag(name):
    setattr(_flags, name, getattr(_flags, name, 0) + 1)
    try:
        yield
    finally:
        setattr(_flags, name, getattr(_flags, name) - 1)


def disable_graphs():
    """Within the block every program that this thread calls runs its body
    eagerly (staging included); graphs already captured are kept for
    later."""
    return _flag("disabled")


def check_syncs():
    """Within the block this thread's program staging and replays run under
    ``torch.cuda.set_sync_debug_mode("error")`` (process-wide while on)."""
    return _flag("sync_check")


def _graphs_enabled():
    return not getattr(_flags, "disabled", 0)


# The port's kernels by launch counter: a kernel node of a graph is the
# launch of the wrapper whose every part is in its mangled name.
_KERNEL_NODES = {
    "paged_attention_kernel": ("kv_", "PagedRows"),    # kv_attention.cuh, paged rows
    "decode_attention_kernel": ("kv_", "StaticRows"),  # the same kernels, static rows
    "flash_attention_kernel": ("flash_fwd_kernel",),
    "encoder_attention_kernel": ("encoder_fwd_",),
}


def _wrapper_of(name):
    for fn_name, parts in _KERNEL_NODES.items():
        if all(p in name for p in parts):
            return fn_name
    return None


_cuda_driver = None


def _driver():
    global _cuda_driver
    if _cuda_driver is None:
        import ctypes

        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        for fn, args in (("cuGraphGetNodes", [vp, vp, ctypes.POINTER(sz)]),
                         ("cuGraphNodeGetType", [vp, ctypes.POINTER(ctypes.c_int)]),
                         ("cuGraphKernelNodeGetParams_v2", [vp, vp]),
                         ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), vp]),
                         ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p), vp])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _cuda_driver = lib
    return _cuda_driver


def kernel_names(graph):
    """The mangled names of the kernel nodes of a captured, not yet
    instantiated ``torch.cuda.CUDAGraph(keep_graph=True)``, read through
    the driver API."""
    import ctypes

    cu = _driver()

    def ok(err, what):
        if err:
            raise RuntimeError(f"{what} failed with CUresult {err}")

    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(h, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    kind = ctypes.c_int()
    params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern at 56
    for node in nodes[:n.value]:
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        ok(cu.cuGraphKernelNodeGetParams_v2(node, params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            ok(cu.cuFuncGetName(ctypes.byref(name), params[0]), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), params[7]), "cuKernelGetName")
        names.append(name.value.decode())
    return names


@contextmanager
def _sync_debug(on):
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Programs:
    """The programs of one owner (an engine, or a model's ``generate()``),
    keyed like the reference's jit caches, with the capture stream and the
    graph memory pool they share.  ``captured`` lists the keys in capture
    order."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._programs: dict = {}
        self._stream = None
        self._pool = None
        self.captured: list = []
        self.capture_seconds = 0.0  # warm-ups excluded, node checks included
        self.node_seconds = 0.0     # of which reading the graphs' kernel nodes
        self.replays = 0
        # held by a caller across writing a program's statics, calling it
        # and reading its outputs (the engine holds its own lock instead)
        self.lock = threading.RLock()

    def get(self, key, build=None):
        """The program of ``key``, made by ``build()`` (which returns a
        Program) on first use; None for a missing key without ``build``."""
        prog = self._programs.get(key)
        if prog is None and build is not None:
            prog = self._programs[key] = build()
        return prog

    def keys(self):
        return list(self._programs)

    def __contains__(self, key):
        return key in self._programs

    def drop(self, key):
        """Forget a program (its graph's memory returns to the pool)."""
        self._programs.pop(key, None)
        if not self._programs:
            # the allocator frees a pool once its last graph is gone and
            # takes no new capture into it: the next capture opens another
            self._pool = None

    def clear(self):
        """Forget every program and the statics they hold."""
        self._programs.clear()
        self._pool = None

    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def pool_bytes(self):
        """Bytes the caching allocator holds for this owner's graph pool
        (None on the CPU or before a capture)."""
        if self._pool is None:
            return None
        pid = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pid)


class Program:
    """A body over static inputs.  ``inputs`` maps each name to its initial
    value, a CPU tensor (its shape and dtype are the input's), staged from
    the host; ``statics`` maps more names to tensors on the device that the
    program keeps as inputs (kv buffers, carried state), which the caller
    writes in place; ``body`` takes all of them by name and returns a
    tensor or a tuple of tensors; ``generators`` are the torch.Generators
    the body draws from (registered with the graph, so that replays draw as
    eager calls do)."""

    ALIGN = 16

    def __init__(self, owner: Programs, key, body, inputs, generators=(), statics=None):
        self.owner, self.key, self.body = owner, key, body
        self.generators = tuple(generators)
        layout, off = {}, 0
        for name, init in inputs.items():
            n = init.numel() * init.element_size()
            layout[name] = (off, n, init)
            off += -(-n // self.ALIGN) * self.ALIGN
        dev = owner.device
        pinned = owner.cuda
        self._host_buf = torch.zeros(max(off, self.ALIGN), dtype=torch.uint8, pin_memory=pinned)
        self.host = {name: self._host_buf[o:o + n].view(init.dtype).view(init.shape)
                     for name, (o, n, init) in layout.items()}
        for name, (_, _, init) in layout.items():
            self.host[name].copy_(init)
        self._staged = bool(layout)  # whether a call uploads the packed buffer
        if pinned:
            self._dev_buf = self._host_buf.to(dev)
            self.inputs = {name: self._dev_buf[o:o + n].view(init.dtype).view(init.shape)
                           for name, (o, n, init) in layout.items()}
        else:
            self._dev_buf = self._host_buf  # the CPU reads its inputs in place
            self.inputs = dict(self.host)
        self.inputs.update(statics or {})
        self._uploaded = None    # event after the last upload (CUDA)
        self._fetch_bufs = {}    # pinned host buffers of fetched outputs
        self.graph = None
        self.outputs = None
        self._delta = ()

    # ------------------------------------------------------------ staging

    def stage(self, **values):
        """Write host values (numpy arrays, Python numbers or CPU tensors)
        into the inputs' host twins; the next call uploads them."""
        with _sync_debug(self._checked()):
            self._host_ready()
            for name, v in values.items():
                h = self.host[name]
                h.copy_(torch.as_tensor(np.asarray(v)).reshape(h.shape))

    def host_view(self, name):
        """A numpy view of an input's host twin, for in-place edits before
        the next call."""
        self._host_ready()
        return self.host[name].numpy()

    def _checked(self):
        """Whether staging and replay run under the sync check: a captured
        program, graphs on, inside this thread's ``check_syncs()``."""
        return (self.owner.cuda and bool(getattr(_flags, "sync_check", 0))
                and self.graph is not None and _graphs_enabled())

    def _host_ready(self):
        # the previous upload reads the host twin asynchronously: wait for it
        # before the twin is written again
        if self._uploaded is not None:
            self._uploaded.synchronize()
            self._uploaded = None

    def _upload(self):
        if self._staged:
            self._dev_buf.copy_(self._host_buf, non_blocking=True)
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()

    # ------------------------------------------------------------ running

    def __call__(self):
        """Run the program on its static inputs, uploading the staged ones
        first: eagerly on the CPU or under ``disable_graphs()``, by warm-up
        and capture on the first CUDA call, by replay after that.  Returns
        the body's outputs."""
        owner = self.owner
        if not owner.cuda:
            return self.body(**self.inputs)
        with _sync_debug(self._checked()):
            self._upload()
            if not _graphs_enabled():
                return self.body(**self.inputs)
            if self.graph is None:
                return self._capture()
            self.graph.replay()
        for fn, attr, n in self._delta:
            setattr(fn, attr, getattr(fn, attr) + n)
        owner.replays += 1
        return self.outputs

    def _capture(self):
        from ..ops import _build
        from ..ops import decode_attention as _da

        owner = self.owner
        cur = torch.cuda.current_stream(owner.device)
        side = owner.stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            result = self.body(**self.inputs)  # the warm-up is this call's result
        # the capture stream's split-K tickets, made by the warm-up
        def tickets():
            return {k: t for k, t in _da._TICKETS.items() if k[1] == side.cuda_stream}

        before = tickets()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        tally = _build._capture.tally = {}
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=owner.pool(), capture_error_mode="thread_local")
                try:
                    outputs = self.body(**self.inputs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 - the body's error is the one to raise
                        pass
                    raise
                graph.capture_end()
        finally:
            _build._capture.tally = None
        cur.wait_stream(side)
        after = tickets()
        if after.keys() != before.keys() or any(after[k] is not t for k, t in before.items()):
            raise RuntimeError(f"program {self.key!r}: the split-K tickets of the capture "
                               "stream changed during capture (the warm-up must make them)")
        t1 = time.perf_counter()
        self._delta = self._node_counts(graph, tally)
        owner.node_seconds += time.perf_counter() - t1
        graph.instantiate()
        self.graph, self.outputs = graph, outputs
        owner.captured.append(self.key)
        owner.capture_seconds += time.perf_counter() - t0
        return result

    def _node_counts(self, graph, tally):
        """(counter owner, attribute, count) per replay: the graph's kernel
        nodes by wrapper, which must equal the wrappers' tally of the
        capture; other counters (the encoder's input copies) as tallied."""
        from ..ops import _build

        nodes = {}
        for name in kernel_names(graph):
            fn_name = _wrapper_of(name)
            if fn_name is not None:
                nodes[fn_name] = nodes.get(fn_name, 0) + 1
        launched = {fn.__name__: n for (fn, attr), n in tally.items() if attr == "launches"}
        if nodes != launched:
            raise RuntimeError(f"program {self.key!r}: the graph holds the kernels {nodes} "
                               f"but the wrappers launched {launched} during capture")
        return tuple((fn, attr, n) for (fn, attr), n in tally.items() if n)

    def fetch(self, t):
        """``t`` (an output on the device) as a numpy array on the host: one
        copy into pinned memory, then a wait on one event."""
        if t.device.type != "cuda":
            return t.numpy().copy()
        key = (tuple(t.shape), t.dtype)
        buf = self._fetch_bufs.get(key)
        if buf is None:
            buf = self._fetch_bufs[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        self.wait()
        return buf.numpy().copy()

    def wait(self):
        """Block until the program's work queued so far is done (CUDA)."""
        if self.owner.cuda:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
