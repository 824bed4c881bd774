"""gridpp_tpu_torch.tools.roofline on the CPU: its rows against the
reference tool's, its counts against hand counts and against the
operations the port's code issues, its OI blocks against gridpp_tpu's, and
the --device cpu run end to end. Its card run is chip_smoke.py phase 15."""
import ast
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import gridpp_tpu as gridpp  # noqa: E402
import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402
from gridpp_tpu_torch.tools import roofline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Row = roofline.Row
OI_TOL = 1e-4                    # tests/test_torch_pipeline.py, unsmoothed
ENSI_RTOL, ENSI_ATOL = 2e-4, 2e-3


def _reference_labels():
    """The labels of tools/roofline.py's characterize( calls, read from its
    source: f-strings filled from main()'s constant assignments, the
    Pallas tag empty, each [xla] row the port's [plain] row."""
    with open(os.path.join(ROOT, "tools", "roofline.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    env = {"tag": ""}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            names = ([target] if isinstance(target, ast.Name)
                     else list(getattr(target, "elts", [])))
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            values = value if isinstance(value, tuple) else (value,)
            for name, v in zip(names, values):
                if isinstance(name, ast.Name):
                    env[name.id] = v
    labels = []
    calls = sorted((node for node in ast.walk(main)
                    if isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "characterize"),
                   key=lambda node: node.lineno)
    for node in calls:
        arg = node.args[0]
        if isinstance(arg, ast.Constant):
            label = arg.value
        else:
            label = "".join(v.value if isinstance(v, ast.Constant)
                            else str(env[v.value.id]) for v in arg.values)
        labels.append(label.replace(" [xla]", " [plain]"))
    return labels


def test_rows_cover_the_reference_tools_rows():
    want = _reference_labels()
    assert len(want) == 8
    labels = [r.label for r in roofline.rows(1.0)]
    assert labels[:8] == want
    assert len(set(labels)) == len(labels)


def test_rows_launch_every_kernel_source():
    """Every ops.stencil.KERNELS source has a card row, by the routes
    stencil_plan picks; every kernel K1-K5 has a row of its own."""
    specs = roofline.rows(1.0)
    assert set().union(*(roofline.sources(r) for r in specs)) \
        == set(stencil.KERNELS)
    assert {r.kind for r in specs if not r.plain} >= {"K1", "K2", "K3", "K4",
                                                       "K5"}
    wide = {r.kind for r in specs
            if roofline.sources(r) == {"neighbourhood_wide"}}
    assert wide == {"K1", "K2", "K3", "K4", "K5"}


@pytest.mark.parametrize("row, want", [
    (Row("", "K1", (6, 9), 2), (432, 1080, "f32")),
    # 2h+1 = 19 >= 16 rows: the fold's (32 + 18) / 16 terms
    (Row("", "K1", (2, 40, 50), 9), (32000, 50000, "f32")),
    (Row("", "K2", (10, 10), 3), (800, 1400, "f32")),
    (Row("", "K3", (10, 10), 3), (800, 4200, "f32")),
    # a 25-cell window: 8-bit lanes, 12 lanes in 3 words
    (Row("", "K4", (10, 12), 2, 11), (1004, 120 * (24 + 12 + 33), "int32")),
    (Row("", "K5", (10, 12, 3), 1, stat=int(gt.Mean)), (2880, 4320, "f32")),
    (Row("", "K5", (10, 12, 3), 1, stat=int(gt.Max)), (2880, 2160, "f32")),
    # products 9328, elementwise 2356, reductions 134; bytes: background
    # and output 64, validity 6, rho 24, g 48, a table of 5 obs 140
    (Row("", "ensi", (2, 3, 4, 5)), (282, 11818, "f32")),
    # the sort path (P <= 128), and the top-k path
    (Row("", "oi", (3, 5, 2)), (256, 1403, "f32")),
    (Row("", "oi", (2, 130, 1)), (4224, 12897, "f32")),
    (Row("", "tiled", (4, 5, 6, 2, 3, 1, 8, 4, 5)), (568, 2236, "f32")),
])
def test_count_equals_a_hand_count(row, want):
    assert roofline.count(row) == want


def test_terms_fold_past_the_run():
    assert roofline.terms(7) == 15
    assert roofline.terms(8) == (32 + 16) / 16
    assert roofline.terms(100) == 14.5


# -- the counts against the code -------------------------------------------
_EW = {"add", "sub", "mul", "div", "truediv", "rdiv", "rsub", "exp", "sqrt",
       "abs", "where", "isfinite", "eq", "ne", "lt", "le", "gt", "ge", "and",
       "or", "xor", "invert", "bitwise_or", "bitwise_left_shift"}
_CAST = {"to", "long"}
_RED = {"sum", "amax", "amin", "any", "all", "mean", "topk", "sort"}


class _Ops(TorchFunctionMode):
    """Operations as the code issues them: an elementwise call (or a cast
    that changes the type) one an element it writes, a reduction, sort
    or top-k one an element it reads."""

    def __init__(self):
        super().__init__()
        self.elementwise = self.reductions = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "").strip("_").rstrip("_")
        if name.startswith("i") and name[1:] in _EW:
            name = name[1:]
        first = args[0] if args else None
        if name in _CAST:
            if out.dtype != first.dtype:
                self.elementwise += out.numel()
        elif name in _EW and isinstance(out, torch.Tensor):
            self.elementwise += out.numel()
        elif name in _RED:
            self.reductions += first.numel()
        return out


def _nbytes(a):
    return roofline._nbytes(a)


@pytest.mark.parametrize("row", [
    Row("", "ensi", (7, 3, 4, 9)), Row("", "ensi", (5, 10, 10, 30)),
    Row("", "oi", (7, 200, 3)), Row("", "oi", (6, 50, 10)),
    Row("", "tiled", (10, 10, 81, 10)), Row("", "tiled", (33, 20, 50, 4))])
def test_parts_are_the_codes_operations(row):
    """count's bytes are the inputs' and the output's; its matrix products
    are FlopCounterMode's count, its elementwise and reduction operations
    those the port's code issues on these shapes."""
    made = roofline.make(row, "cpu", np.random.default_rng(3))
    with _Ops() as ops, FlopCounterMode(display=False) as flops:
        out = made.fn(*made.args)
    work = roofline.parts(made.row)
    assert work.products == flops.get_total_flops()
    assert (work.elementwise, work.reductions) == (ops.elementwise,
                                                   ops.reductions)
    assert work.bytes == _nbytes(made.args) + _nbytes(out)


@pytest.mark.parametrize("row", roofline.rows(0.02),
                         ids=lambda r: r.label)
def test_bytes_are_the_inputs_and_output(row):
    made = roofline.make(row, "cpu", np.random.default_rng(4))
    out = made.fn(*made.args)
    assert roofline.count(made.row)[0] == _nbytes(made.args) + _nbytes(out)


# -- the OI blocks against gridpp_tpu ------------------------------------------
def _fields(pts, structure, origin, resolved):
    return {k: np.asarray(v, np.float32)
            for k, v in resolved(pts, structure, origin).items()}


@pytest.mark.parametrize("b, p", [(64, 40), (50, 300)])
def test_oi_dense_block_matches_gridpp_tpu(b, p):
    from gridpp_tpu.api.oi import _origin as j_origin
    from gridpp_tpu.api.oi import _resolved_fields as j_fields
    from gridpp_tpu.ops.oi import oi_block_dense as j_block
    made = roofline.make(Row("", "oi", (b, p, 10)), "cpu",
                         np.random.default_rng(5))
    bg, bvar, p1, of, obs, obs_y, ratios = made.args
    js = gridpp.BarnesStructure(10000.0)
    want, _ = j_block(js, {k: jnp.asarray(v.numpy()) for k, v in p1.items()},
                      {k: jnp.asarray(v.numpy()) for k, v in of.items()},
                      jnp.asarray(bg.numpy()), jnp.asarray(bvar.numpy()),
                      jnp.asarray(obs.numpy()), jnp.asarray(obs_y.numpy()),
                      jnp.asarray(ratios.numpy()), 10, True)
    got = made.fn(*made.args).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=OI_TOL)
    # the row's point fields are gridpp_tpu's
    rng = np.random.default_rng(6)
    lats, lons = rng.uniform(55, 62, 30), rng.uniform(5, 12, 30)
    tp = gt.Points(lats, lons, np.zeros(30), np.zeros(30))
    jp = gridpp.Points(lats, lons, np.zeros(30), np.zeros(30))
    from gridpp_tpu_torch.api.oi import _origin, _resolved_fields
    mine = _fields(tp, gt.BarnesStructure(1e4), _origin(tp), _resolved_fields)
    ref = _fields(jp, js, j_origin(jp), j_fields)
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k])


def test_ensi_update_matches_gridpp_tpu():
    from gridpp_tpu.ops.oi_ensi import _ensi_update as j_update
    made = roofline.make(Row("", "ensi", (300, 10, 10, 500)), "cpu",
                         np.random.default_rng(7))
    bg, sel_valid, rho, g, tab = (a.numpy() for a in made.args)
    f = tab[g]
    want, _ = j_update(None, jnp.asarray(sel_valid), jnp.asarray(rho),
                       jnp.asarray(f[:, :, 0]), jnp.asarray(f[:, :, 1]),
                       jnp.asarray(f[:, :, 3:]), jnp.asarray(f[:, :, 2]),
                       jnp.asarray(bg), True)
    got = made.fn(*made.args).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=ENSI_RTOL,
                               atol=ENSI_ATOL)


def test_tiled_sweep_matches_gridpp_tpu():
    """The tiled row's function against tools/roofline.py's make_tiled on
    gridpp_tpu's Pipeline(tiled=True) over the same grid, obs and
    inputs."""
    from gridpp_tpu.ops import oi_tiled as j_tiled
    n, p = 48, 300
    rng = np.random.default_rng(8)
    lats, lons = np.meshgrid(np.linspace(55, 60, n), np.linspace(5, 10, n),
                             indexing="ij")
    plat, plon = rng.uniform(55, 60, p), rng.uniform(5, 10, p)
    bg = rng.normal(280, 5, (n, n)).astype(np.float32)
    pobs = rng.normal(280, 5, p).astype(np.float32)
    pobs[::7] = np.nan
    rat = np.full(p, 0.1, np.float32)

    jp = gridpp.Pipeline(gridpp.Grid(lats, lons),
                         gridpp.Points(plat, plon, np.zeros(p), np.zeros(p)),
                         gridpp.BarnesStructure(20000.0), halfwidth=0,
                         max_points=10, tiled=True)
    geom, keys = jp._geom, tuple(jp._geom.static_keys)
    flat = jnp.asarray(bg).reshape(-1)
    pback = jnp.take(flat, jnp.asarray(jp._obs_nn))
    valid01 = (jnp.isfinite(pobs) & jnp.isfinite(pback)).astype(jnp.float32)
    packed = jnp.stack([jnp.where(valid01 > 0, pobs, 0.0),
                        jnp.where(valid01 > 0, pback, 0.0), rat, valid01],
                       axis=1)
    bg_t = j_tiled.tile_fields(jnp.asarray(bg), geom)
    out_t, _ = j_tiled.oi_tiled_sweep(jp.structure, dict(jp._geom_dev), keys,
                                      bg_t, jnp.ones_like(bg_t), packed, 10,
                                      True)
    want = np.asarray(j_tiled.untile_fields(out_t, geom)).reshape(n, n)

    tp = gt.Pipeline(gt.Grid(lats, lons),
                     gt.Points(plat, plon, np.zeros(p), np.zeros(p)),
                     gt.BarnesStructure(20000.0), halfwidth=0, max_points=10,
                     tiled=True, device="cpu")
    fn = roofline.tiled_fn(tp.structure, tp._geom, tp._static_keys, 10)
    got = fn(torch.as_tensor(bg), torch.as_tensor(pobs), torch.as_tensor(rat),
             tp._geom_dev, tp._obs_nn).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=OI_TOL)


# -- the tool ------------------------------------------------------------------
def test_peaks_by_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", 3.35e12),
                       ("NVIDIA H100 PCIe", 2.0e12),
                       ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA A100", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        found = roofline.peaks()
        assert (found and found[1]["bytes"]) == want, name
    rates = roofline.PEAKS[-1][1]
    assert roofline.bound((3.35e9, 0, "f32"), rates) == (1.0, "bytes")
    ms, by = roofline.bound((0, 33.5e9, "int32"), rates)
    assert (round(ms, 9), by) == (1.0, "operations")


def test_cuda_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.main([]) != 0
    assert "no CUDA card" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA card"):
        roofline.run(0.02, "cuda")


def test_cpu_run_end_to_end(capsys):
    """--device cpu --scale 0.02: every row, in order, with counts and CPU
    times; the last line is JSON and no device column holds a number."""
    assert roofline.main(["--device", "cpu", "--scale", "0.02"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = json.loads(out[-1])
    assert [r["kernel"] for r in rows] == [
        r.label for r in roofline.rows(0.02)]
    for r in rows:
        assert r["device"] == "cpu"
        assert all(r[k] == roofline.NOT_MEASURED
                   for k in roofline.DEVICE_KEYS), r["kernel"]
        assert r["cpu_warm_ms"] > 0 and r["cpu_cold_ms"] > 0
        assert r["bytes"] > 0 and r["ops"] > 0
        assert any(line.startswith(f"| {r['kernel']} |") for line in out)
