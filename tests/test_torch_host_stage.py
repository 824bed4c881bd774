"""The serving stream's host staging pass (gridpp_tpu_torch/native/stage.py,
csrc/host_stage.cpp): one pass that copies a cycle's float32 arrays into
their pinned staging buffers and says whether every value was finite.

Held to what the pass replaces: the staged words equal
`np.asarray(a, np.float32).view(np.uint32)` and the answer equals
`np.isfinite(a).all()`. The library is built with g++ at first use; the
tests that stage skip where no g++ exists. Non-finite values
(quiet NaN, NaN with a payload, negative NaN, +Inf, -Inf) are planted at the
first element, the last, and on both sides of each thread part's boundary;
finite edge values (-0.0, subnormals, +-FLT_MAX) read finite; sizes 1, fewer
elements than threads, a size no thread count divides, and ~4e6; 1, 2, 3 and
8 threads; a buffer that starts off a 16-byte line. Arrays that are not
C-contiguous float32 (float64, a transposed view, Fortran order, a strided
view, a list) are converted first and counted.
"""
import shutil
import subprocess
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gridpp_tpu_torch import tracing  # noqa: E402
from gridpp_tpu_torch.native import stage as st  # noqa: E402

# csrc/host_stage.cpp's kMinPartWords and kLineWords
MIN_PART, LINE = 1 << 18, 16
SIZES = [1, 5, 1_000_003, 4_000_000]
THREADS = [1, 2, 3, 8]
BAD = {"nan": 0x7FC00000, "nan_payload": 0x7F800001,
       "neg_nan": 0xFFC00123, "inf": 0x7F800000, "neg_inf": 0xFF800000}
FINITE_EDGES = np.array([0x80000000, 0x00000001, 0x007FFFFF, 0x80000001,
                         0x00800000, 0x7F7FFFFF, 0xFF7FFFFF], np.uint32)


@pytest.fixture
def lib():
    """The staging library, built with g++ at first use."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the staging library")
    return st.get_lib()


@pytest.fixture
def threads(request):
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(before)


def _boundaries(n, t):
    """The first element of each part after the first (the C++ split)."""
    parts = min(t, -(-n // MIN_PART))
    if parts <= 1:
        return []
    step = -(-(-(-n // parts)) // LINE) * LINE
    return [p * step for p in range(1, parts) if p * step < n]


def _field(n, seed=0):
    return np.random.default_rng(seed).normal(280, 5, n).astype(np.float32)


def _staged(arrays):
    """(the staged buffers as uint32 words, the pass's answer)."""
    bufs = [torch.empty(np.shape(a), dtype=torch.float32) for a in arrays]
    ok = st.stage(arrays, bufs)
    return [b.numpy().view(np.uint32) for b in bufs], ok


def _counts(fn):
    """fn()'s result and the tracing counts it made under a profiler."""
    tracing.count("serve.cycles")   # profiler off: the next session is new
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("serve.cycles")   # opens it
        out = fn()
    return out, tracing.session().counts


@pytest.mark.parametrize("threads", THREADS, indirect=True)
@pytest.mark.parametrize("n", SIZES)
def test_stage_copies_bits_of_a_finite_field(lib, threads, n):
    a = _field(n)
    a.view(np.uint32)[:min(n, FINITE_EDGES.size)] = FINITE_EDGES[:n]
    (got,), ok = _staged([a])
    np.testing.assert_array_equal(got, a.view(np.uint32))
    assert ok is True and bool(np.isfinite(a).all())


@pytest.mark.parametrize("bad", sorted(BAD))
@pytest.mark.parametrize("threads", THREADS, indirect=True)
@pytest.mark.parametrize("n", SIZES)
def test_stage_finds_a_planted_non_finite(lib, threads, n, bad):
    """One non-finite word at the first element, the last, or either side
    of a thread part's boundary: the answer is False, and every word is
    still copied (the planted one too)."""
    a = _field(n, seed=n)
    places = {0, n - 1}
    for b in _boundaries(n, threads):
        places |= {b - 1, b}
    for i in sorted(places):
        x = a.copy()
        x.view(np.uint32)[i] = BAD[bad]
        (got,), ok = _staged([x])
        np.testing.assert_array_equal(got, x.view(np.uint32))
        assert ok is False and not np.isfinite(x).all(), i


@pytest.mark.parametrize("threads", [3], indirect=True)
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [37, 1_000_003])
def test_stage_into_an_unaligned_buffer(lib, threads, offset, n):
    """A staging buffer that starts off a 16-byte line (the pass's scalar
    head before its vector body): the words and the answer as ever, with a
    NaN in the head, the body or the tail."""
    a = _field(n, seed=offset)
    for i in (0, n // 2, n - 1):
        x = a.copy()
        x[i] = np.nan
        buf = torch.empty(n + offset, dtype=torch.float32)[offset:]
        assert st.stage([x], [buf]) is False
        np.testing.assert_array_equal(buf.numpy().view(np.uint32),
                                      x.view(np.uint32))
    buf = torch.empty(n + offset, dtype=torch.float32)[offset:]
    assert st.stage([a], [buf]) is True
    np.testing.assert_array_equal(buf.numpy().view(np.uint32),
                                  a.view(np.uint32))


def test_boundaries_split_the_large_sizes():
    """The planted places above do reach past the first part."""
    assert len(_boundaries(4_000_000, 8)) == 7
    assert len(_boundaries(1_000_003, 3)) == 2
    assert _boundaries(5, 8) == [] and _boundaries(4_000_000, 1) == []


@pytest.mark.parametrize("threads", [3], indirect=True)
def test_stage_several_arrays_one_answer(lib, threads):
    """A cycle's arrays (an ensemble, pobs, psigmas): one non-finite value
    in any of them makes the cycle's answer False, and all are copied."""
    arrays = [_field((200, 300, 10)).reshape(200, 300, 10), _field(400, 1),
              np.full(400, 1.5, np.float32)]
    for k in range(len(arrays) + 1):
        xs = [a.copy() for a in arrays]
        if k < len(xs):
            xs[k].reshape(-1)[7] = np.inf
        got, ok = _staged(xs)
        for g, x in zip(got, xs):
            np.testing.assert_array_equal(g, x.view(np.uint32))
        assert ok == all(np.isfinite(x).all() for x in xs)


def _f64(a):
    b = a.astype(np.float64)
    b[3] = 1e39     # past FLT_MAX: Inf in float32, as np.asarray makes it
    return b


CONVERTED = {
    "float64": _f64,
    "transposed": lambda a: a.reshape(40, 50).T,
    "fortran": lambda a: np.asfortranarray(a.reshape(40, 50)),
    "list": lambda a: a[:10].tolist(),
    "strided": lambda a: a[::2],
    "scalar": lambda a: np.float64(a[0]),
}


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
@pytest.mark.parametrize("kind", sorted(CONVERTED))
def test_as_f32_converts_other_layouts(lib, kind):
    a = _field(2000, 3)
    if kind == "strided":
        a[16] = np.nan
    x = CONVERTED[kind](a)
    want = np.asarray(x, np.float32)

    def run():
        host = st.as_f32([x])
        return host, _staged(host)
    (host, ((got,), ok)), counts = _counts(run)
    assert host[0].flags.c_contiguous and host[0].dtype == np.float32
    assert host[0].shape == want.shape
    np.testing.assert_array_equal(got.reshape(want.shape),
                                  want.view(np.uint32))
    assert ok == bool(np.isfinite(want).all())
    assert ok is (kind not in ("float64", "strided"))
    assert counts.get("serve.stage.converted") == 1
    assert counts.get("serve.stage.fused") == 1


def test_as_f32_passes_contiguous_f32_through(lib):
    a, p = _field(4000), _field(10, 1)
    (host, _), counts = _counts(lambda: (st.as_f32([a, p]),
                                         _staged([a, p])))
    assert host[0] is a and host[1] is p
    assert "serve.stage.converted" not in counts
    assert counts.get("serve.stage.fused") == 2


@pytest.mark.parametrize("case", ["strided_array", "f64_array", "short_buf",
                                  "f64_buf", "strided_buf"])
def test_stage_rejects_what_it_cannot_copy(case):
    a = _field(64)
    buf = torch.empty(64)
    if case == "strided_array":
        a = _field(128)[::2]
    elif case == "f64_array":
        a = a.astype(np.float64)
    elif case == "short_buf":
        buf = torch.empty(63)
    elif case == "f64_buf":
        buf = torch.empty(64, dtype=torch.float64)
    else:
        buf = torch.empty(128)[::2]
    with pytest.raises(ValueError):
        st.stage([a], [buf])


def test_stage_read_only_input(lib):
    """A read-only array (the benchmark's host pool) stages without a
    warning."""
    a = _field(1000)
    a.setflags(write=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (got,), ok = _staged([a])
    np.testing.assert_array_equal(got, a.view(np.uint32))
    assert ok


def test_a_failed_build_raises(monkeypatch):
    """A build that fails raises from stage(); nothing falls back."""
    def failed(name, srcs, command, timeout=600):
        raise subprocess.CalledProcessError(1, command("OUT"), "", "no")
    monkeypatch.setattr(st, "build_shared", failed)
    st.get_lib.cache_clear()
    try:
        with pytest.raises(subprocess.CalledProcessError):
            st.stage([_field(8)], [torch.empty(8)])
    finally:
        st.get_lib.cache_clear()
