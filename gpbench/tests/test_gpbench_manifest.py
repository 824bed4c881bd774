"""BENCHMARK.json against the benchmark's contract, the files its names
lead to, and what the harness and the reference import."""
import json
import os
import re
import shutil
import subprocess
import sys


from gpbench.harness import manifest

ROOT = manifest.ROOT
BENCH = manifest.read_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FOREIGN = {"jax", "jaxlib", "flax", "gridpp_tpu"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    """run.py and everything it reaches: the harness, every system,
    count and reader BENCHMARK.json names, and the program they build."""
    code = (
        "import json, sys\n"
        "import gpbench.run, gpbench.calibrate\n"
        "from gpbench.harness import manifest, runner\n"
        "b = manifest.read_json('BENCHMARK.json')\n"
        "for c in b['configs']:\n"
        "    manifest.system(manifest.read_json(c['file']))\n"
        "    manifest.counts(c['name'])\n"
        "for m in b['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "import gridpp_tpu_torch, gridpp_tpu_torch.api.pipeline\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    names = _top_level_modules(code)
    assert "gridpp_tpu_torch" in names
    assert not names & FOREIGN


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            "import gpbench.reference.geometry, gpbench.reference.stencil\n"
            "import gpbench.reference.oi, gpbench.reference.ensi\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    names = _top_level_modules(code)
    assert not names & (FOREIGN | {"gridpp_tpu_torch"})


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpbench/run.py"]
    assert BENCH["paths"] == ["gpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and TEXT.match(w["why"])
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(("metric", m["name"]))
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        names.append(("metric", m["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_every_cell_reports_what_it_must():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    for w in BENCH["workloads"]:
        got = {m["name"] for m in manifest.reported(e2e, w["name"])}
        assert "setup_s" in got and len(got) >= 2
        assert manifest.reported(layer, w["name"])
    for m in layer:
        for cell in m.get("workloads", [w["name"] for w in
                                        BENCH["workloads"]]):
            moved = {x["name"] for x in manifest.reported(e2e, cell)}
            assert m["moves"] in moved, (m["name"], cell)


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("gpbench/")
        cfg = manifest.read_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(manifest.path("systems", cfg["system"] + ".py"))
        assert os.path.isfile(manifest.path("counts", c["name"] + ".py"))
    for w in BENCH["workloads"]:
        assert os.path.isfile(manifest.path("traffic", w["traffic"]
                                            + ".json"))
        assert os.path.isfile(manifest.path("cells", w["name"] + ".json"))
        manifest.load(w["name"])
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_file_names_are_made_of_name_characters():
    for d, _, files in os.walk(manifest.HERE):
        if "__pycache__" in d:
            continue
        for f in files:
            assert NAME.match(f), os.path.join(d, f)


def test_test_names_unused_under_tests():
    ours = {f for f in os.listdir(os.path.dirname(__file__))
            if f.startswith("test_")}
    theirs = set(os.listdir(os.path.join(ROOT, "tests")))
    assert ours and not ours & theirs


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "gpbench/run.py", "--workload", "det2k_10k.static",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_without_the_program_prints_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_without_a_card_prints_nothing():
    out = _run(ROOT)
    assert out.returncode == 2 and not out.stdout.strip()
    assert "CUDA" in out.stderr
