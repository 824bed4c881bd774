"""gridpp_tpu_torch imports without jax and exposes the slice's names."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = ("import sys, gridpp_tpu_torch\n"
            "import gridpp_tpu_torch.ops.oi_ensi\n"
            "import gridpp_tpu_torch.ops.oi_ensi_multi\n"
            "import gridpp_tpu_torch.api.oi\n"
            "import gridpp_tpu_torch.api.oi_ensi\n"
            "import gridpp_tpu_torch.api.oi_ensi_multi\n"
            "import gridpp_tpu_torch.api.downscaling\n"
            "import gridpp_tpu_torch.api.gradients\n"
            "import gridpp_tpu_torch.api.curves\n"
            "import gridpp_tpu_torch.api.transform\n"
            "import gridpp_tpu_torch.api.ldc, gridpp_tpu_torch.api.search\n"
            "import gridpp_tpu_torch.api.window_api\n"
            "import gridpp_tpu_torch.api.gridding, gridpp_tpu_torch.api.fill\n"
            "import gridpp_tpu_torch.api.masking, gridpp_tpu_torch.api.verif\n"
            "import gridpp_tpu_torch.api.diagnostics\n"
            "import gridpp_tpu_torch.client, gridpp_tpu_torch.parallel\n"
            "import gridpp_tpu_torch.parallel.distributed\n"
            "import gridpp_tpu_torch.parallel.dryrun\n"
            "import gridpp_tpu_torch.client.schemes\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
            "                                            'gridpp_tpu.')))\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_public_names_are_gridpp_tpus():
    """The port's public names are gridpp_tpu's, each package imported
    alone in a fresh process (a test worker may have imported submodules
    that add names)."""
    code = ("import json, {0}\n"
            "print(json.dumps([n for n in dir({0}) if not n.startswith('_')]))"
            "\n")
    names = {}
    for pkg in ("gridpp_tpu", "gridpp_tpu_torch"):
        res = subprocess.run([sys.executable, "-c", code.format(pkg)],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr
        names[pkg] = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert len(names["gridpp_tpu"]) > 150
    assert names["gridpp_tpu"] - names["gridpp_tpu_torch"] == set()
    assert names["gridpp_tpu_torch"] - names["gridpp_tpu"] == set()


@pytest.mark.parametrize("sub", ["parallel", "client"])
def test_subpackage_names_are_gridpp_tpus(sub):
    """gridpp_tpu_torch.parallel and .client give every public name of
    gridpp_tpu's, and so do their modules' `__all__`, each imported alone
    in a fresh process."""
    code = ("import json, importlib, pkgutil\n"
            "pkg = importlib.import_module('{0}.{1}')\n"
            "out = {{'': [n for n in dir(pkg) if not n.startswith('_')]}}\n"
            "for m in pkgutil.iter_modules(pkg.__path__):\n"
            "    mod = importlib.import_module(f'{0}.{1}.{{m.name}}')\n"
            "    out[m.name] = sorted(getattr(mod, '__all__', []))\n"
            "print(json.dumps(out))\n")
    names = {}
    for pkg in ("gridpp_tpu", "gridpp_tpu_torch"):
        res = subprocess.run([sys.executable, "-c", code.format(pkg, sub)],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr
        names[pkg] = json.loads(res.stdout.strip().splitlines()[-1])
    ref, port = names["gridpp_tpu"], names["gridpp_tpu_torch"]
    assert set(ref[""]) == set(port[""])
    for mod, public in ref.items():
        assert set(public) <= set(port[mod]), mod


@pytest.mark.parametrize("name", [
    "Grid", "Points", "Point", "BarnesStructure", "CressmanStructure",
    "SoarStructure", "ToarStructure", "PowerlawStructure",
    "LinearStructure", "MultipleStructure", "CrossValidation",
    "StructureFunction", "Statistic", "Mean", "Sum", "Count", "Min", "Max",
    "Std", "Variance", "Median", "Pipeline", "EnsiPipeline",
    "MultiEnsiPipeline", "neighbourhood",
    "neighbourhood_brute_force", "neighbourhood_quantile",
    "neighbourhood_quantile_fast", "get_neighbourhood_thresholds",
    "neighbourhood_ens", "neighbourhood_quantile_ens",
    "neighbourhood_quantile_ens_fast", "calc_statistic",
    "calc_even_quantiles", "optimal_interpolation",
    "optimal_interpolation_full", "optimal_interpolation_ensi",
    "optimal_interpolation_ensi_multi_ebe",
    "optimal_interpolation_ensi_multi_ebesc",
    "optimal_interpolation_ensi_multi_utem", "warning",
    # downscaling, gradients and KDTree
    "KDTree", "KDTree_calc_distance", "KDTree_calc_distance_fast",
    "KDTree_calc_straight_distance", "KDTree_deg2rad", "KDTree_rad2deg",
    "nearest", "bilinear", "downscaling", "simple_gradient",
    "full_gradient", "full_gradient_debug", "calc_gradient",
    # calibration, transforms and util.cpp's helpers
    "apply_curve", "monotonize_curve", "quantile_mapping_curve",
    "calc_score", "get_optimal_threshold", "metric_optimizer_curve",
    "Transform", "Identity", "Log", "BoxCox", "StartedBoxCox", "Gamma",
    "calc_quantile", "compatible_size", "convert_coordinates",
    "get_lower_index", "get_upper_index", "init_vec2", "init_vec3",
    "init_ivec2", "init_ivec3", "interpolate", "is_valid_lat",
    "is_valid_lon", "num_missing_values", "point_in_rectangle"])
def test_public_names(name):
    import gridpp_tpu_torch
    assert hasattr(gridpp_tpu_torch, name)


def test_no_jax_import_in_sources():
    pkg = os.path.join(ROOT, "gridpp_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    s = line.strip()
                    assert not s.startswith(("import jax", "from jax",
                                             "import gridpp_tpu.",
                                             "from gridpp_tpu.",
                                             "from gridpp_tpu ")), (f, s)
