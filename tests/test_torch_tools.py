"""gridpp_tpu_torch.tools on the CPU, at small sizes: the all-API smoke
gate, the parity sweep, the per-operator table and the scaling harness.

The card routes of these tools run on the card only (chip_smoke.py phase
14); here the smoke runs route (a) and the entry points with
--device cpu, and its device-route set is held to the API modules' code.
"""
import ast
import importlib
import inspect
import json
import os
import pkgutil
import re
import types

import pytest

pytest.importorskip("torch")

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch import api  # noqa: E402
from gridpp_tpu_torch.tools import (benchmark_ops, scaling,  # noqa: E402
                                    smoke, sweep_parity)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds the spawned scaling ranks may take before they are killed
TIMEOUT = 120


@pytest.fixture(scope="module")
def registry():
    d = smoke.problem(gt)
    return smoke.registry(gt, d), smoke.entry_points(gt, d, "cpu")


@pytest.fixture(scope="module")
def smoke_cpu():
    return smoke.run("cpu")


def test_smoke_registry_covers_every_public_name(registry):
    reg, entries = registry
    public = smoke.public_names(gt)
    assert public - set(reg) - set(entries) == smoke.WAIVED
    assert smoke.WAIVED <= public
    assert all(reg[name] for name in reg)


def test_smoke_waives_what_tpu_smoke_waives():
    """The same WAIVED set as tools/tpu_smoke.py, read from its source."""
    with open(os.path.join(ROOT, "tools", "tpu_smoke.py")) as f:
        tree = ast.parse(f.read())
    waived = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "WAIVED")
    assert smoke.WAIVED == waived


def test_smoke_cpu_run_passes(smoke_cpu, registry):
    """Every call of route (a) and of the entry points passes on the CPU;
    route (b) needs the card."""
    reg, entries = registry
    failed = [(name, k, route) for name, k, route, _ in smoke_cpu["failures"]]
    assert not failed, smoke_cpu["failures"][0][3]
    assert not smoke_cpu["uncovered"]
    assert smoke_cpu["counts"] == {
        "host": sum(len(c) for c in reg.values()), "device": 0,
        "entry": sum(len(t) for t in entries.values())}
    assert smoke_cpu["passed"] == smoke_cpu["calls"]
    assert smoke.report(smoke_cpu, log=lambda *a, **k: None)


def _device_reading_functions():
    """"<module>.<name>" of every public function of the API modules whose
    source calls api_device() or on_host(), itself or through a function
    of its module that it calls by name: read from the source text."""
    found = set()
    for info in pkgutil.iter_modules(api.__path__):
        if info.name.startswith("_"):
            continue
        module = importlib.import_module(f"{api.__name__}.{info.name}")
        src = {n: inspect.getsource(f) for n, f in vars(module).items()
               if isinstance(f, types.FunctionType)
               and f.__module__ == module.__name__}
        reads = {n for n, s in src.items()
                 if re.search(r"(?<![.\w])(api_device|on_host)\(\)", s)}
        grew = True
        while grew:
            more = {n for n, s in src.items() if n not in reads and any(
                re.search(rf"(?<![.\w]){r}\(", s) for r in reads)}
            reads |= more
            grew = bool(more)
        found |= {f"{info.name}.{n}" for n in reads if not n.startswith("_")}
    return found


def test_smoke_device_routes_are_the_api_functions_that_read_the_device(
        registry):
    """The smoke calls the device route of exactly the API functions whose
    code reads api_device() / on_host(), each at least once: a device
    route added later without a smoke entry fails here."""
    reg, _ = registry
    cases = smoke.device_cases(reg)
    assert set(cases) == _device_reading_functions()
    assert {"neighbourhood.neighbourhood",
            "neighbourhood.neighbourhood_quantile_fast",
            "diagnostics.dewpoint", "downscaling.bilinear",
            "oi.optimal_interpolation", "window_api.window"} <= set(cases)
    assert all(cases.values()), [k for k, v in cases.items() if not v]
    # the neighbourhood functions' card route takes the stencil statistics
    stats = {int(c.args[2]) for c in cases["neighbourhood.neighbourhood"]}
    assert int(gt.Median) not in stats and int(gt.Std) in stats


def test_sweep_parity_seed_0_on_the_cpu():
    rows = sweep_parity.run_seed(0, "cpu")
    assert set(rows) == set(sweep_parity.PIPELINES)
    assert all(max(v) < sweep_parity.TOL for v in rows.values()), rows


def test_benchmark_ops_rows_are_the_references(capsys):
    """At -s 0.02 -n 1 on the host route, every row of tests/benchmark.py,
    by the labels of its add("<name>", "<detail>", ...) calls (read from
    its source as text), is printed and in the JSON line."""
    with open(os.path.join(ROOT, "tests", "benchmark.py")) as f:
        want = [f"{name} {detail}" for name, detail in
                re.findall(r'add\("([^"]+)", "([^"]+)"', f.read())]
    assert len(want) == 28
    assert benchmark_ops.main(["-s", "0.02", "-n", "1", "--device",
                               "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = json.loads(out[-1])["benchmarks"]
    assert [r["name"] for r in rows] == want
    assert all(r["host_s"] > 0 and r["card_s"] is None for r in rows)
    for label in want:
        assert any(line.startswith(label + " ") for line in out), label


def test_scaling_two_ranks_match_one(tmp_path):
    """Two gloo CPU ranks at n=64: the gathered analysis equals one
    process's bit for bit, and the report lands in --out."""
    out = tmp_path / "scaling.json"
    assert scaling.main(["--hosts", "2", "--n", "64", "--iters", "1",
                         "--timeout", str(TIMEOUT), "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["bit_parity"] and report["max_abs_diff"] == 0.0
    assert report["hosts"] == 2 and report["shape"] == [64, 64]
    assert report["device"] == "cpu" and report["backend"] == "gloo"
    assert report["efficiency"] > 0
