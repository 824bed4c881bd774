"""The serving stream's hand-out of fetched analyses (api/pipeline.
_hand_out), on the CPU.

On a card, serve_stream copies each analysis out of its pinned output
buffer into a host array the caller has released, where the pipeline holds
one, so that a 160 MB analysis is not written into freshly mapped memory
every cycle. These tests hold the hand-out to its contract with host
tensors standing in for the pinned buffer: each yield is a bit-for-bit
copy whose base is a lease; a released yield's buffer is handed out again;
a buffer stays out of the pool while any view of its yield lives, and is
written only after the last one dies; a buffer of another shape or type is
dropped and a fresh one allocated; the pool keeps at most _SPARE buffers;
two live yields never share memory, also when other threads release them;
and `serve.fetch.recycled` / `serve.fetch.fresh` count the yields while a
profiler session records.
"""
import sys
import threading
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch import tracing  # noqa: E402
from gridpp_tpu_torch.api import pipeline as pl  # noqa: E402

SHAPE = (6, 5, 3)


def _src(i, shape=SHAPE, dtype=torch.float32):
    """A host tensor standing in for cycle i's pinned output buffer."""
    n = int(np.prod(shape))
    return (torch.arange(n, dtype=dtype) * 0.25 + i).reshape(shape)


def _ptr(a):
    return a.__array_interface__["data"][0]


def _spare():
    return deque(maxlen=pl._SPARE)


def test_a_yield_is_a_copy_on_a_lease():
    spare = _spare()
    src = _src(1)
    a = pl._hand_out(spare, src)
    assert isinstance(a, np.ndarray) and isinstance(a.base, pl._Lease)
    assert a.shape == SHAPE and a.dtype == np.float32
    assert a.flags.writeable and a.flags.c_contiguous
    np.testing.assert_array_equal(a, src.numpy())
    assert not np.shares_memory(a, src.numpy())
    src += 7
    np.testing.assert_array_equal(a, _src(1).numpy())


def test_a_released_yield_is_handed_out_again():
    spare = _spare()
    a = pl._hand_out(spare, _src(0))
    first = _ptr(a)
    assert len(spare) == 0
    del a
    assert len(spare) == 1
    b = pl._hand_out(spare, _src(1))
    assert _ptr(b) == first and len(spare) == 0
    np.testing.assert_array_equal(b, _src(1).numpy())


@pytest.mark.parametrize("view", [
    lambda a: a[::2],
    lambda a: a.reshape(-1),
    np.asarray,
    lambda a: a[1:, :, 0].T,
    torch.from_numpy,
    memoryview,
], ids=["step", "reshape", "asarray", "transpose", "from_numpy",
        "memoryview"])
def test_a_view_keeps_the_buffer_out_of_the_pool(view):
    spare = _spare()
    a = pl._hand_out(spare, _src(0))
    first = _ptr(a)
    v = view(a)
    kept = np.array(v, copy=True)
    del a
    assert len(spare) == 0
    b = pl._hand_out(spare, _src(1))
    assert _ptr(b) != first
    np.testing.assert_array_equal(np.asarray(v), kept)
    del v
    assert len(spare) == 1
    c = pl._hand_out(spare, _src(2))
    assert _ptr(c) == first
    np.testing.assert_array_equal(c, _src(2).numpy())
    np.testing.assert_array_equal(b, _src(1).numpy())


@pytest.mark.parametrize("shape, dtype", [
    ((5, 6, 3), torch.float32),
    ((6, 5), torch.float32),
    (SHAPE, torch.float64),
])
def test_another_shape_or_type_allocates_fresh(shape, dtype):
    spare = _spare()
    a = pl._hand_out(spare, _src(0))
    first = _ptr(a)
    del a
    b = pl._hand_out(spare, _src(1, shape, dtype))
    assert _ptr(b) != first
    assert b.shape == shape and b.dtype == torch.empty(0, dtype=dtype).numpy(
        ).dtype
    np.testing.assert_array_equal(b, _src(1, shape, dtype).numpy())
    assert len(spare) == 0      # the other shape's buffer was dropped
    del b
    assert len(spare) == 1 and spare[0].shape == shape


def test_the_pool_keeps_at_most_its_cap():
    spare = _spare()
    live = [pl._hand_out(spare, _src(i)) for i in range(pl._SPARE + 3)]
    ptrs = [_ptr(a) for a in live]
    while live:
        live.pop(0)     # released in the order handed out
    assert len(spare) == pl._SPARE
    # the last released are kept
    assert sorted(b.data_ptr() for b in spare) == sorted(ptrs[-pl._SPARE:])


def test_live_yields_never_share_memory():
    spare = _spare()
    live = []
    for i in range(8):
        live.append(pl._hand_out(spare, _src(i)))
        if i % 3 == 2:
            live.pop(0)
    for j, a in enumerate(live):
        np.testing.assert_array_equal(a, _src(j + 2).numpy())
        for b in live[j + 1:]:
            assert not np.shares_memory(a, b)


def test_counts_recycled_and_fresh_while_profiled():
    spare = _spare()
    tracing.count("serve.cycles")   # off: records nothing
    held = pl._hand_out(spare, _src(0))     # not profiled: not counted
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            # each yield dropped at once: fresh, then recycled
            pl._hand_out(spare, _src(i))
        a = pl._hand_out(spare, _src(5))    # recycled
        b = pl._hand_out(spare, _src(6))    # fresh: a is held
        del held
        c = pl._hand_out(spare, _src(7))    # recycled
    assert tracing.session().counts == {"serve.fetch.fresh": 2,
                                        "serve.fetch.recycled": 6}
    for x, i in ((a, 5), (b, 6), (c, 7)):
        np.testing.assert_array_equal(x, _src(i).numpy())


def test_releases_from_other_threads_never_reach_a_live_yield():
    """16 threads release yields while the serving thread hands out more
    (a shortened switch interval): each yield still holds its own values
    when its thread drops it, and the pool never passes its cap."""
    spare = _spare()
    handed = []
    lock = threading.Lock()
    stale = []
    over = []

    def consume():
        while True:
            with lock:
                if not handed:
                    if done.is_set():
                        return
                    got = None
                else:
                    got = handed.pop()
            if got is None:
                continue
            i, a = got
            if not (a == i).all():
                stale.append(i)
            del a, got
            if len(spare) > pl._SPARE:
                over.append(len(spare))

    done = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, daemon=True)
                   for _ in range(16)]
        for t in threads:
            t.start()
        for i in range(3000):
            a = pl._hand_out(spare, torch.full((64,), float(i)))
            with lock:
                handed.append((i, a))
            del a
        done.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not handed and stale == [] and over == []
    assert 1 <= len(spare) <= pl._SPARE


@pytest.mark.parametrize("kind", ["pipeline", "ensi", "multi"])
def test_a_pipeline_keeps_one_pool(kind):
    """Every pipeline's serve_stream on a card takes its pool from
    _spare_outputs, made once, so a warm-up call and a later call share
    it."""
    lats, lons = np.meshgrid(np.linspace(55, 56, 8), np.linspace(5, 6, 8),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(np.array([55.2, 55.7]), np.array([5.3, 5.6]),
                    np.zeros(2), np.zeros(2))
    st = gt.BarnesStructure(10000.0)
    pipe = {"pipeline": lambda: gt.Pipeline(grid, pts, st, device="cpu"),
            "ensi": lambda: gt.EnsiPipeline(grid, pts, st, device="cpu"),
            "multi": lambda: gt.MultiEnsiPipeline(grid, pts, st,
                                                  variant="utem",
                                                  device="cpu")}[kind]()
    spare = pipe._spare_outputs()
    assert isinstance(spare, deque) and spare.maxlen == pl._SPARE
    assert pipe._spare_outputs() is spare
