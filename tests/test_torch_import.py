"""gridpp_tpu_torch imports without jax and exposes the slice's names."""
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
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
            "                                            'gridpp_tpu.')))\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


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
    "optimal_interpolation_ensi_multi_utem", "warning"])
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
