"""The benchmark's plain utem reference (gpbench/reference/utem.py) on the
CPU at a small size: 64 x 64 gridpoints, 300 stations, 10 members and a
correlation ensemble of its own, cycles drawn by the benchmark's traffic
generator (gpbench/systems/utem.py adds the correlation ensemble and the
ratios).

The reference is held to gridpp's loop in double (the native host route of
`optimal_interpolation_ensi_multi_utem`) and to `MultiEnsiPipeline(
variant="utem")` served through `serve_stream`, with every station valid
and with 5% missing; each comparison takes the nearer of the two
selections where a gridpoint's 10th and 11th stations lie within 1e-4 in
rho (gpbench/harness/compare.py). Faults planted in the program's answer,
and the reference computed a precision step below the program's, read as
failures at the same bars; the reference imports neither JAX nor either
package.

Bars, on analyses of ~280 K:
- NATIVE_BAR 1e-4 K: the native route solves in double but takes its
  inputs (y_hat, Zc) and writes its analysis as float32 (about 3e-5 K at
  280 K), and ranks by float32 rho.
- PROGRAM_BAR 2e-3 K: the program's float32 chain, its Newton-Schulz
  inverse square root good to ~1e-5 relative, and w's one refinement step
  (ROADMAP F6); the bar of the benchmark's own EnSI test
  (gpbench/tests/test_gpbench_reference.py). The program read 3.7e-4 to
  6.8e-4 K here, the TF32 control 1.1e-2 to 1.5e-2 K and the native route
  under 4e-5 K.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch import native  # noqa: E402
from _torch_helpers import spy  # noqa: E402

from gpbench.harness import compare, manifest  # noqa: E402
from gpbench.harness.traffic import POOL, Traffic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE = {"grid": {"ny": 64, "nx": 64, "lat": [55.0, 55.6],
                 "lon": [5.0, 6.0]}, "stations": 300}
BRATIO = 0.7        # not 1, so that a dropped bratio shows
NATIVE_BAR = 1e-4
PROGRAM_BAR = 2e-3
SEEDS = [3, 2 ** 31 + 17, 2 ** 33 + 5]
_CACHE = {}


def _setup(seed, mix="static"):
    """(config, traffic, the utem system, its Check, its served program)
    at SIZE for the seed and mix, built once."""
    key = (seed, mix)
    if key not in _CACHE:
        cell = manifest.load("utem2k_10k_m10.static")
        config = dict(cell.config, **SIZE, bratios=BRATIO)
        traffic = manifest.read_json(manifest.path("traffic", mix + ".json"))
        t = Traffic(config, traffic, seed, CPU)
        system = manifest.system(config)
        _CACHE[key] = (config, t, system, system.Check(config, t, CPU),
                       system.build(config, t, CPU))
    return _CACHE[key]


def _native(config, t, system, i):
    """Cycle i through gridpp's loop in double (the native host route)."""
    field, pobs = t.inputs(i)
    corr = system.corr_pool(config, t, CPU)[i % POOL]
    p = len(t.plats)
    e = field.shape[2]
    return gt.optimal_interpolation_ensi_multi_utem(
        gt.Grid(t.lats, t.lons),
        np.full((t.ny, t.nx), BRATIO, np.float32), field, corr,
        gt.Points(t.plats, t.plons, np.zeros(p), np.zeros(p)), pobs,
        np.full(p, config["pratios"], np.float32),
        field.reshape(-1, e)[t.nn], corr.reshape(-1, e)[t.nn],
        gt.BarnesStructure(config["structure"]["h"]),
        config["max_points"], True)


def _served(program, t, i):
    """Cycle i served by the program through serve_stream."""
    return next(iter(program.serve_stream([t.make(i)])))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_gridpps_loop_in_double(monkeypatch, seed):
    config, t, system, check, _ = _setup(seed)
    calls = spy(monkeypatch, native, "oi_utem_host_solve")
    for i in range(2):
        err = check.errors(i, _native(config, t, system, i))
        assert float(err.max()) < NATIVE_BAR, (i, float(err.max()))
    assert len(calls) == 2


@pytest.mark.parametrize("mix", ["static", "churn5"])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_the_served_pipeline(seed, mix):
    _, t, _, check, program = _setup(seed, mix)
    assert bool(t.missing) == (mix == "churn5")
    for i in range(3):
        err = check.errors(i, _served(program, t, i))
        assert float(err.max()) < PROGRAM_BAR, (i, float(err.max()))


def test_analysis_moves_the_members():
    """The comparison is not won by handing the background back: the
    analysis moves most gridpoints by far more than either bar."""
    _, t, _, check, program = _setup(SEEDS[0])
    field = t.inputs(0)[0]
    moved = np.abs(_served(program, t, 0) - field).max(axis=2)
    assert np.median(moved) > 50 * PROGRAM_BAR


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_control_fails_the_program_bar(seed):
    """The reference in float32 with TF32 products, the step below the
    program's precision, misses PROGRAM_BAR."""
    _, _, _, check, _ = _setup(seed)
    assert float(check.control_errors(0).max()) > 2 * PROGRAM_BAR


def _w_unscaled(with_br, without_br, field):
    """The program's analysis rebuilt with W short of its sqrt(E - 1): the
    sigma W^T xc part (the analysis at bratio 0, less the mean) divided by
    sqrt(E - 1), the bratio part (the difference of the two analyses)
    kept."""
    mean = field.mean(axis=2, keepdims=True)
    e = field.shape[2]
    return (mean + (without_br - mean) / math.sqrt(e - 1)
            + (with_br - without_br))


@pytest.mark.parametrize("fault", ["corr_is_background", "bratio_dropped",
                                   "w_unscaled"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_planted_faults_fail(seed, fault):
    config, t, system, check, program = _setup(seed)
    field, pobs = t.inputs(0)
    pr, corr = program.pratios, program.pool[0]

    def serve(bratio, corr):
        pipe = system.build(dict(config, bratios=bratio), t, CPU).pipe
        return next(iter(pipe.serve_stream([(field, pobs, pr, corr)])))

    if fault == "corr_is_background":
        out = serve(BRATIO, field)
    elif fault == "bratio_dropped":
        out = serve(1.0, corr)
    else:
        out = _w_unscaled(serve(BRATIO, corr), serve(0.0, corr), field)
    err = check.errors(0, out)
    assert float(err.max()) > 10 * PROGRAM_BAR, float(err.max())
    readings = compare.readings([err])
    assert not compare.passed(compare.judged(
        dict(readings, failed_cycles=0),
        manifest.load("utem2k_10k_m10.static").check["limits"]))


def test_reference_imports_neither_jax_nor_the_packages():
    code = ("import json, sys\n"
            "import gpbench.reference.utem\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "gridpp_tpu",
                        "gridpp_tpu_torch"}
