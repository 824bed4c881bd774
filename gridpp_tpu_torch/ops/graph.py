"""Serving cycles as captured CUDA graphs, with a branch taken on the device.

gridpp_tpu runs each Pipeline path as one jitted executable
(gridpp_tpu/api/pipeline.py:196, :234, :301) and refreshes the general
path's weights cache under `jax.lax.cond` (:257), so a cycle is one
dispatch with no host synchronisation. Here a `Graphed` cycle is captured
once into a `torch.cuda.CUDAGraph` and replayed: a call copies its inputs
into the graph's static buffers on the device, replays the graph, and
returns a clone of the static output, so an analysis a caller keeps is not
overwritten by the next replay. A captured graph is uploaded to the device
at once (gc_upload), so its first replay costs what later ones do (without
it, the general cycle's first replay took about 1.5 ms more on an H100).
`Graphed.if_node` captures a branch as a conditional IF node of the graph
(csrc/graph_cond.cu, built with nvcc at first use): at each replay the
device reads a 0-dim bool and runs the branch or skips it, and the host
never reads the bool. (PyTorch 2.11, the card's, has no conditional nodes
of its own.) The branch's allocations go to a memory pool of its own, held
until the Graphed is closed or collected.

A replay calls no kernel wrapper, so a Graphed records the launches that
its capture counted on the wrappers (ops/stencil.py's `launches` and
`wide`, and `begin_if.launches`, the conditional's setter kernel) and adds
them at each replay. A capture launches nothing, so its own counts are
taken back. A capture that fails raises; nothing falls back to an eager
cycle. Captures and replays are counted in the tracing session
(gridpp_tpu_torch.tracing: `graph.capture`, `graph.replay`).
"""
from __future__ import annotations

import ctypes
import os
import weakref

import torch

from .._build import build_shared
from ..tracing import count
from . import stencil

__all__ = ["Graphed", "begin_if", "build_conditional", "FUNCTIONS"]

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "graph_cond.cu")
# csrc/graph_cond.cu's C functions and their pointer arguments
FUNCTIONS = {"gc_begin_if": 3, "gc_end_if": 1, "gc_upload": 2}
_FIELDS = ("launches", "wide")
_fns: dict = {}


def build_conditional() -> str:
    """Compile csrc/graph_cond.cu for sm_90a (at first use) and return the
    library's path. Raises when the build fails."""
    nvcc = stencil._nvcc()
    return build_shared(
        "graph_cond", [_SOURCE],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                     "-Xcompiler", "-fPIC", "-o", out, _SOURCE])


def _lib():
    if not _fns:
        lib = ctypes.CDLL(build_conditional())
        for name, nargs in FUNCTIONS.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * nargs
            _fns[name] = fn
    return _fns


def _call(name, *args):
    err = _lib()[name](*args)
    if err == -3:
        raise RuntimeError(f"{name}: the stream is not capturing a graph")
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def begin_if(pred: torch.Tensor, stream, body_stream) -> None:
    """While `stream` captures a graph, add the setter kernel (it reads the
    0-dim CUDA bool `pred`) and an IF node on its value, and start
    capturing `body_stream` into the node's body. Counted in
    `begin_if.launches`, one a call."""
    if not (pred.is_cuda and pred.dtype == torch.bool and pred.dim() == 0):
        raise ValueError("pred must be a 0-dim bool tensor on a card")
    _call("gc_begin_if", pred.data_ptr(), stream.cuda_stream,
          body_stream.cuda_stream)
    begin_if.launches += 1


begin_if.launches = 0


def _wrappers():
    return (stencil.neighbourhood_mean_cuda, stencil.neighbourhood_minmax_cuda,
            stencil.neighbourhood_var_cuda,
            stencil.neighbourhood_quantile_fast_cuda,
            stencil.neighbourhood_members_cuda, begin_if)


def _counts():
    return {(w, f): getattr(w, f) for w in _wrappers() for f in _FIELDS
            if hasattr(w, f)}


def _add(counts, times):
    for (w, f), n in counts.items():
        setattr(w, f, getattr(w, f) + times * n)


def _release(index, pool, refs):
    for _ in range(refs[0]):
        torch._C._cuda_releasePool(index, pool)
    refs[0] = 0


class Graphed:
    """One cycle captured on `device` into a graph whose allocations come
    from `pool` (graphs sharing a pool must not run at once; replays on one
    stream never do).

    g.warm(fn) runs fn() eagerly on g's stream (a cycle's first call, whose
    answer it returns); g.capture(fn, args) captures fn(*buffers) on static
    buffers shaped as args; g(*args) copies args into them, replays and
    returns a clone of fn's output. During capture fn may call
    g.if_node(pred, body). Any other tensor that fn writes and that is not
    in the graph's pool must live as long as the graph: g.buffer(shape)
    makes one that g holds."""

    def __init__(self, device, pool):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.launches = {}
        self._pool = pool
        self._stream = torch.cuda.Stream(device)
        self._body = torch.cuda.Stream(device)
        self._body_pool = torch.cuda.graph_pool_handle()
        self._refs = [0]   # references this Graphed holds on _body_pool
        self._held = []    # buffers the graph writes (buffer())
        self._done = weakref.finalize(self, _release, device.index,
                                      self._body_pool, self._refs)
        self._done.atexit = False

    def buffer(self, shape, dtype=torch.float32):
        """A tensor on this graph's device that lives as long as the graph
        (a static buffer its captured work writes)."""
        t = torch.empty(shape, dtype=dtype, device=self.device)
        self._held.append(t)
        return t

    def warm(self, fn):
        """fn() eagerly on this graph's stream, after the current stream's
        work; returns its output, ordered before later work on the current
        stream."""
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                out = fn()
            cur.wait_stream(self._stream)
            out.record_stream(cur)
        return out

    def capture(self, fn, args):
        """Capture fn on static buffers shaped as args. Raises when the
        capture fails."""
        with torch.cuda.device(self.device):
            self.inputs = tuple(torch.empty_like(a) for a in args)
            before = _counts()
            try:
                with torch.cuda.stream(self._stream):
                    self.graph.capture_begin(pool=self._pool)
                    try:
                        self.out = fn(*self.inputs)
                    except BaseException:
                        _abandon(self.graph)
                        raise
                    self.graph.capture_end()
                # the first replay then costs what later ones do
                _call("gc_upload", self.graph.raw_cuda_graph_exec(),
                      self._stream.cuda_stream)
            finally:
                counted = {k: n - before[k] for k, n in _counts().items()
                           if n != before[k]}
                _add(counted, -1)
        self.launches = counted
        count("graph.capture")

    def if_node(self, pred, body):
        """During capture: body()'s work as an IF node that runs at a
        replay when the 0-dim bool tensor pred is true on the device."""
        index = self.device.index
        begin_if(pred, torch.cuda.current_stream(self.device), self._body)
        try:
            with torch.cuda.stream(self._body):
                torch._C._cuda_beginAllocateToPool(index, self._body_pool)
                self._refs[0] += 1
                try:
                    body()
                finally:
                    torch._C._cuda_endAllocateToPool(index, self._body_pool)
        except BaseException:
            # end the body's capture; the error that stopped it is raised
            _lib()["gc_end_if"](self._body.cuda_stream)
            raise
        _call("gc_end_if", self._body.cuda_stream)

    def __call__(self, *args):
        if len(args) != len(self.inputs):
            raise ValueError(f"{len(args)} inputs, the graph takes "
                             f"{len(self.inputs)}")
        with torch.cuda.device(self.device):
            for buf, a in zip(self.inputs, args):
                if a.shape != buf.shape:
                    raise ValueError(f"input of shape {tuple(a.shape)}; "
                                     f"the graph takes {tuple(buf.shape)}")
                buf.copy_(a, non_blocking=True)
            self.graph.replay()
            _add(self.launches, 1)
            count("graph.replay")
            return self.out.clone()

    def close(self):
        """Drop the graph, its buffers and the branch's memory pool."""
        self.graph.reset()
        self._held.clear()
        self._done()


def _abandon(graph):
    """End a capture that failed, so the stream leaves capture mode; the
    error that stopped it is the one raised."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
