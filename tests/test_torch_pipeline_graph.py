"""The general path's guard on the device and the cycle's buffers, on the
CPU (gridpp_tpu_torch/api/pipeline.py, ops/oi_tiled.py, ops/graph.py).

On a card a tiled Pipeline's fast and general cycles are captured CUDA
graphs and the guard branches under a conditional node; on the CPU the
same functions run eagerly and the guard branches on the host, so these
tests hold the guard's state machine, its buffers, the `rebuilds` counter
and the `out=` paths. A tiled Pipeline at 300 x 256 with 200 obs,
max_points 8, Mean h=3 serves 8 cycles: cold; hit; hit; a third of the obs
missing (rebuild); hit; back to all valid (rebuild); hit; ratios 0.05
(rebuild), each cycle's obs shifted by its number. Bars: general == resolve
bit for bit (tests/test_pipeline_consistency.py:286); the port's general
path within 1e-3 of gridpp_tpu's guarded path with halfwidth 3, the bar of
tests/test_torch_pipeline.py::test_port_matches_gridpp_tpu.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, tensor  # noqa: E402

from gridpp_tpu_torch.ops import graph  # noqa: E402
from gridpp_tpu_torch.ops import oi_tiled  # noqa: E402

SHAPE = (300, 256)
N_OBS = 200
MAX_POINTS = 8
HALFWIDTH = 3
TOL = 1e-3          # tests/test_torch_pipeline.py, halfwidth 3
REBUILT = {0, 3, 5, 7}
_CACHE = {}


def _problem():
    rng = np.random.default_rng(41)
    lats, lons = np.meshgrid(np.linspace(55, 58, SHAPE[0]),
                             np.linspace(5, 8, SHAPE[1]), indexing="ij")
    plats = rng.uniform(55, 58, N_OBS)
    plons = rng.uniform(5, 8, N_OBS)
    background = rng.normal(280, 5, SHAPE).astype(np.float32)
    noise = rng.normal(0, 2, N_OBS)
    return lats, lons, plats, plons, background, noise


def _objects(pkg, lats, lons, plats, plons):
    return (pkg.Grid(lats, lons),
            pkg.Points(plats, plons, np.zeros(N_OBS), np.zeros(N_OBS)),
            pkg.BarnesStructure(30000.0))


def _setup():
    """(port Pipeline, gridpp_tpu Pipeline, the 8 cycles as (background,
    pobs, ratios) numpy), built once."""
    if "setup" not in _CACHE:
        lats, lons, plats, plons, background, noise = _problem()
        ratios = np.full(N_OBS, 0.2, np.float32)
        kw = dict(halfwidth=HALFWIDTH, statistic=gt.Mean,
                  max_points=MAX_POINTS, tiled=True, ratios=ratios)
        g2, p2, s2 = _objects(gt, lats, lons, plats, plons)
        port = gt.Pipeline(g2, p2, s2, device="cpu", **kw)
        gj_kw = dict(kw, statistic=gj.Mean)
        ref = gj.Pipeline(*_objects(gj, lats, lons, plats, plons), **gj_kw)
        idx = g2.nearest_map(plats, plons)
        pobs = (background.reshape(-1)[idx] + noise).astype(np.float32)
        gap = pobs.copy()
        gap[::3] = np.nan
        cycles = []
        for i in range(8):
            po = gap if i in (3, 4) else pobs
            ra = np.full(N_OBS, 0.05, np.float32) if i == 7 else ratios
            cycles.append((background + np.float32(0.5 * i),
                           (po + np.float32(i)).astype(np.float32), ra))
        _CACHE["setup"] = (port, ref, cycles)
    return _CACHE["setup"]


def _fresh(port):
    """Reset the port's guard as load_state does."""
    port.load_state(port.state())
    return port


def _sequence():
    """The 8 cycles through the port's general and resolve paths and
    gridpp_tpu's guarded path: {general, kept, resolve, ref, rebuilds},
    kept being each cycle's general output as it was when returned."""
    if "sequence" not in _CACHE:
        port, ref, cycles = _setup()
        _fresh(port)
        out = {"general": [], "kept": [], "resolve": [], "ref": [],
               "rebuilds": []}
        for bg, po, ra in cycles:
            g = port.run_device(tensor(bg), tensor(po), ra, path="general")
            out["general"].append(g)
            out["kept"].append(g.clone())
            out["rebuilds"].append(int(port.rebuilds))
            out["resolve"].append(port.run_device(tensor(bg), tensor(po), ra,
                                                  path="resolve"))
            out["ref"].append(np.asarray(ref.run_device(
                jnp.asarray(bg), jnp.asarray(po), ra, path="general")))
        _CACHE["sequence"] = out
    return _CACHE["sequence"]


@pytest.mark.parametrize("cycle", range(8))
def test_general_equals_resolve_bitwise(cycle):
    seq = _sequence()
    assert torch.equal(seq["general"][cycle], seq["resolve"][cycle])
    assert torch.isfinite(seq["general"][cycle]).all()
    assert tuple(seq["general"][cycle].shape) == SHAPE


@pytest.mark.parametrize("cycle", range(8))
def test_general_matches_gridpp_tpu_guarded_path(cycle):
    seq = _sequence()
    np.testing.assert_allclose(seq["general"][cycle].numpy(),
                               seq["ref"][cycle], rtol=0, atol=TOL)


def test_rebuilds_count_exactly_the_changed_cycles():
    counts = _sequence()["rebuilds"]
    rebuilt = {i for i, n in enumerate(counts)
               if n != (counts[i - 1] if i else 0)}
    assert rebuilt == REBUILT
    assert counts[-1] == len(REBUILT)


@pytest.mark.parametrize("cycle", range(7))
def test_returned_analysis_outlives_the_next_cycle(cycle):
    seq = _sequence()
    assert torch.equal(seq["general"][cycle], seq["kept"][cycle])
    assert not torch.equal(seq["general"][cycle], seq["general"][cycle + 1])


def test_load_state_resets_the_guard():
    port, _, cycles = _setup()
    bg, po, ra = (tensor(a) for a in cycles[1])
    _fresh(port)
    port.run_device(bg, po, ra, path="general")
    port.run_device(bg, po + 1.0, ra, path="general")
    assert int(port.rebuilds) == 1
    guard = port._guard
    port.load_state(port.state())
    assert port._guard is not guard
    assert int(port.rebuilds) == 0 and int(port._guard["init"]) == 0
    assert not port._guard["weights"].any()
    got = port.run_device(bg, po, ra, path="general")
    assert int(port.rebuilds) == 1
    assert torch.equal(got, port.run_device(bg, po, ra, path="resolve"))


def test_guard_buffers_are_allocated_once():
    """The guard's state is written in place: the same tensors after a
    rebuild, a hit and a second rebuild, shaped as gridpp_tpu's
    zero_state() (gridpp_tpu/api/pipeline.py:271-280)."""
    port, _, cycles = _setup()
    _fresh(port)
    guard = dict(port._guard)
    ptrs = {k: v.data_ptr() for k, v in guard.items()}
    for i in (0, 1, 3):
        bg, po, ra = (tensor(a) for a in cycles[i])
        port.run_device(bg, po, ra, path="general")
    assert {k: v.data_ptr() for k, v in port._guard.items()} == ptrs
    t_count, tb, _ = port._geom_dev["local_idx"].shape
    want = {"local_s": ((t_count, tb, MAX_POINTS), torch.int32),
            "valid_s": ((t_count, tb, MAX_POINTS), torch.bool),
            "weights": ((t_count, tb, MAX_POINTS), torch.float32),
            "a_scalar": ((t_count, tb), torch.float32),
            "init": ((), torch.int32), "valid": ((N_OBS,), torch.float32),
            "ratios": ((N_OBS,), torch.float32),
            "rebuilds": ((), torch.int64)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in guard.items()} == want
    assert int(port.rebuilds) == 2 and int(port._guard["init"]) == 1
    np.testing.assert_array_equal(port._guard["ratios"].numpy(), cycles[3][2])


_FORMS = ["none", "numpy static", "numpy other", "tensor static",
          "tensor other"]


def _pratios(form, static):
    other = np.full_like(static, 0.05)
    host = static if "static" in form or form == "none" else other
    if form == "none":
        return None, host
    return (tensor(host) if form.startswith("tensor") else host.copy()), host


@pytest.mark.parametrize("form", _FORMS)
def test_pratios_forms_give_the_general_answer(form):
    """pratios None, numpy and tensor, equal to the static ratios or not:
    the general path's answer is the re-solve's with those ratios."""
    port, _, cycles = _setup()
    bg, po, static = cycles[1]
    pr, host = _pratios(form, static)
    got = port.run_device(tensor(bg), tensor(po), pr, path="general")
    want = port.run_device(tensor(bg), tensor(po), tensor(host),
                           path="resolve")
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", _FORMS)
def test_pratios_forms_pick_the_path_on_auto(form):
    """On path "auto" an all-valid cycle with the static ratios (None,
    numpy or tensor) takes the fast path, other ratios the general one."""
    port, _, cycles = _setup()
    bg, po, static = cycles[1]
    pr, host = _pratios(form, static)
    got = port.run_device(tensor(bg), tensor(po), pr, assume_valid=True)
    if np.array_equal(host, static):
        want = port.run_device(tensor(bg), tensor(po), path="fast",
                               assume_valid=True)
    else:
        want = port.run_device(tensor(bg), tensor(po), tensor(host),
                               path="resolve")
    assert torch.equal(got, want)


def test_ratios_copy_of_the_static_ratios_is_shared():
    port, _, cycles = _setup()
    static = cycles[1][2]
    assert port._ratios(None) is port._init_dev
    assert port._ratios(static.copy()) is port._init_dev
    other = port._ratios(np.full_like(static, 0.05))
    assert other is not port._init_dev and other.dtype == torch.float32
    np.testing.assert_array_equal(port._init_dev.numpy(), static)


def test_build_weights_dynamic_out_gives_the_same_bits():
    port, _, cycles = _setup()
    ratios = tensor(cycles[0][2])
    valid = tensor((np.arange(N_OBS) % 4 != 0).astype(np.float32))
    args = (port.structure, port._geom_dev, port._static_keys, ratios, valid,
            MAX_POINTS)
    want = oi_tiled.build_weights_dynamic(*args)
    out = {k: torch.full_like(v, 7) for k, v in want.items()}
    out["extra"] = torch.full((3,), 5.0)
    got = oi_tiled.build_weights_dynamic(*args, out=out)
    assert got is out
    for key, v in want.items():
        assert torch.equal(out[key], v), key
    assert torch.equal(out["extra"], torch.full((3,), 5.0))


def test_apply_weights_out_gives_the_same_bits():
    port, _, cycles = _setup()
    bg_t = oi_tiled.tile_fields(tensor(cycles[0][0]), port._geom)
    innov = tensor(np.random.default_rng(3).normal(0, 1, N_OBS)
                   .astype(np.float32))
    args = (port._static_w, port._geom_dev["tile_table"], bg_t, innov, True)
    want = oi_tiled.oi_tiled_apply_weights(*args)
    out = torch.full_like(bg_t, 9.0)
    got = oi_tiled.oi_tiled_apply_weights(*args, out=out)
    assert got is out
    # the tiles' padding cells are NaN in both
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)


def test_rebuilds_needs_a_tiled_pipeline():
    lats, lons, plats, plons, _, _ = _problem()
    pipe = gt.Pipeline(*_objects(gt, lats[:20, :20], lons[:20, :20], plats,
                                 plons), halfwidth=1, max_points=4,
                       device="cpu")
    assert not pipe.tiled
    with pytest.raises(ValueError, match="tiled"):
        pipe.rebuilds


def test_conditional_node_takes_only_a_card_bool():
    """The IF node's setter reads a 0-dim bool on a card; anything else is
    refused before any CUDA call, and nothing is counted."""
    before = graph.begin_if.launches
    for pred in (torch.tensor(True), torch.tensor([True]),
                 torch.tensor(1)):
        with pytest.raises(ValueError, match="0-dim bool"):
            graph.begin_if(pred, None, None)
    assert graph.begin_if.launches == before
