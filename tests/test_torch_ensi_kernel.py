"""The EnSI transform's kernel (csrc/ensi_transform.cu) on the CPU: its
wrapper's checks and the shape dispatch of ops/oi_ensi.py::_sweep.

The kernel itself runs only on a card (tests/test_torch_cuda.py holds it to
the plain chain there). Here: `ensi_update_cuda` refuses a wrong type,
shape, layout or size, and a CPU tensor, before it loads the library;
`kernel_takes` sends f32 blocks of at most 32 members and 32 selected obs
on a CUDA device to the kernel and every other block to the chain; and the
sweep, with the kernel's route forced open and its launch replaced by the
plain version on the CPU, hands it each block's selection and writes its
results in place, bit for bit the chain's whatever the block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import ens_problem, gt, objects, tensor  # noqa: E402
from gridpp_tpu_torch.ops import oi_ensi  # noqa: E402


def _args(b=6, s=4, e=5, p=9, seed=0):
    """Valid kernel arguments on the CPU: g, rho, valid, tab, background."""
    rng = np.random.default_rng(seed)
    return dict(
        g=torch.as_tensor(rng.integers(0, p, (b, s))),
        rho=torch.as_tensor(rng.uniform(0.1, 1, (b, s)).astype(np.float32)),
        valid=torch.as_tensor(rng.random((b, s)) < 0.8),
        tab=torch.as_tensor(rng.normal(0, 1, (p, 3 + e)).astype(np.float32)),
        background=torch.as_tensor(
            rng.normal(280, 5, (b, e)).astype(np.float32)))


def _call(args, **kw):
    return oi_ensi.ensi_update_cuda(args["g"], args["rho"], args["valid"],
                                    args["tab"], args["background"], True,
                                    **kw)


@pytest.mark.parametrize("device, dtype, e, s, takes", [
    ("cuda", torch.float32, 10, 10, True),
    ("cuda", torch.float32, 1, 1, True),
    ("cuda", torch.float32, 32, 32, True),
    ("cuda:0", torch.float32, 17, 5, True),
    ("cuda", torch.float32, 33, 10, False),
    ("cuda", torch.float32, 10, 33, False),
    ("cuda", torch.float32, 10, 0, False),
    ("cuda", torch.float64, 10, 10, False),
    ("cpu", torch.float32, 10, 10, False),
    ("meta", torch.float32, 10, 10, False),
])
def test_kernel_takes_blocks_by_shape(device, dtype, e, s, takes):
    assert oi_ensi.kernel_takes(torch.device(device), dtype, e, s) is takes


def _wrong(name, value):
    def fix(args):
        args[name] = value(args[name])
        return args
    return fix


@pytest.mark.parametrize("fix, error, match", [
    (_wrong("g", lambda t: t.to(torch.int32)), TypeError, "int64"),
    (_wrong("valid", lambda t: t.float()), TypeError, "bool"),
    (_wrong("rho", lambda t: t.double()), TypeError, "float32"),
    (_wrong("tab", lambda t: t.double()), TypeError, "float32"),
    (_wrong("background", lambda t: t.half()), TypeError, "float32"),
    (_wrong("g", lambda t: t[:, :, None]), ValueError, r"\(B, S\)"),
    (_wrong("rho", lambda t: t[:, :-1]), ValueError, "rho must be"),
    (_wrong("valid", lambda t: t[:-1]), ValueError, "valid must be"),
    (_wrong("background", lambda t: t[:-1]), ValueError,
     "background must be"),
    (_wrong("tab", lambda t: t[:, :-1]), ValueError, "tab must be"),
    (_wrong("rho", lambda t: t.t().contiguous().t()), ValueError,
     "contiguous"),
    (None, ValueError, "CUDA"),
])
def test_wrapper_refuses_what_the_kernel_cannot_take(fix, error, match):
    args = _args()
    if fix is not None:
        args = fix(args)
    with pytest.raises(error, match=match):
        _call(args)


@pytest.mark.parametrize("e, s", [(33, 4), (5, 33), (40, 40)])
def test_wrapper_refuses_past_32_members_or_slots(e, s):
    with pytest.raises(ValueError, match="32 members and 1 to 32 selected"):
        _call(_args(s=s, e=e))


def test_wrapper_refuses_wrong_outputs():
    args = _args()
    with pytest.raises(ValueError, match="out must be"):
        _call(args, out=torch.empty(6, 4))
    with pytest.raises(TypeError, match="cond_bad"):
        _call(args, cond_bad=torch.empty(6))
    with pytest.raises(ValueError, match="cond_bad must be"):
        _call(args, cond_bad=torch.empty(5, dtype=torch.bool))


def _pipe_args(prob):
    return (tensor(prob["background"]), tensor(prob["pobs"]),
            tensor(prob["psig"]))


def test_sweep_on_the_cpu_runs_the_chain(monkeypatch):
    """On the CPU no block reaches the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the CPU")
    monkeypatch.setattr(oi_ensi, "ensi_update_cuda", refuse)
    prob = ens_problem(2, nan_obs=0.2)
    pipe = gt.EnsiPipeline(*objects(gt, prob), max_points=5, device="cpu")
    out, n_bad = pipe.run_device(*_pipe_args(prob))
    assert out.shape == prob["background"].shape and int(n_bad) == 0


@pytest.mark.parametrize("block", [37, 1 << 20])
@pytest.mark.parametrize("assume_valid", [True, False])
@pytest.mark.parametrize("allow", [True, False])
def test_sweep_hands_each_block_to_the_kernel(monkeypatch, block,
                                              assume_valid, allow):
    """With the route forced open and the launch replaced by the plain
    version, each block reaches the wrapper once, with contiguous (B, S)
    selections, the whole table, the block's background rows and views of
    the results to write, which then hold the chain's bits."""
    prob = ens_problem(4, nan_obs=0.0 if assume_valid else 0.2)
    kw = dict(max_points=5, allow_extrapolation=allow, block=block,
              device="cpu")
    pipe = gt.EnsiPipeline(*objects(gt, prob), **kw)
    args = _pipe_args(prob)
    want = pipe.run_device(*args, assume_valid=assume_valid)
    calls = []

    def launch(g, rho, valid, tab, background, allow_extrapolation, out,
               cond_bad):
        b, s = g.shape
        e = background.shape[1]
        assert g.dtype == torch.int64 and valid.dtype == torch.bool
        assert tuple(rho.shape) == tuple(valid.shape) == (b, s)
        assert tuple(out.shape) == (b, e) and tuple(cond_bad.shape) == (b,)
        assert tab.shape[1] == 3 + e and allow_extrapolation == allow
        assert all(t.is_contiguous() for t in (g, rho, valid, tab,
                                               background, out, cond_bad))
        calls.append(b)
        out[:], cond_bad[:] = oi_ensi.ensi_update_plain(
            g, rho, valid, tab, background, allow_extrapolation)
        return out, cond_bad

    monkeypatch.setattr(oi_ensi, "kernel_takes", lambda *a: True)
    monkeypatch.setattr(oi_ensi, "ensi_update_cuda", launch)
    got = pipe.run_device(*args, assume_valid=assume_valid)
    n = prob["background"].shape[0] * prob["background"].shape[1]
    assert calls == [min(block, n - i) for i in range(0, n, block)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_prefix_selection_reads_rho_on_valid_slots_alone():
    """The prefix path hands the shortlist's rho as it is (views): rho on
    invalid slots, whatever it holds, leaves the result's bits."""
    prob = ens_problem(6, nan_obs=0.0)
    # a short correlation range: gridpoints far from the stations keep
    # fewer than max_points candidates, and padded slots
    grid, pts, st = objects(gt, prob, gt.BarnesStructure(8000.0))
    pipe = gt.EnsiPipeline(grid, pts, st, max_points=5, device="cpu")
    args = _pipe_args(prob)
    want = pipe.run_device(*args, assume_valid=True)
    sel, rho, valid = pipe._cand_fast
    assert not bool(valid.all())
    pipe._cand_fast = (sel, torch.where(valid, rho, torch.nan), valid)
    got = pipe.run_device(*args, assume_valid=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
