"""The repo's behavioural tests of downscaling, gradients, calibration, the
util helpers, KDTree, LDC, the spatial ops (search, smart, gridding, fill,
doping, verification), the window, the diagnostics and the masking
downscalers, run against gridpp_tpu_torch's namespace.

Each test module (tests/test_downscaling.py, test_gradients.py,
test_calibration.py, test_util.py, test_grid_points.py's TestKDTree,
test_ldc.py, test_spatial_ops.py, test_window.py, test_diagnostics.py and
test_downscale_masking.py; TEST_MAP.md maps them to the reference's tests)
is compiled once more from its file under another module name, with its
one `import gridpp_tpu as gridpp` read as `import gridpp_tpu_torch as
gridpp` (so its module-level grids and points are the port's too) and its
in-test `from gridpp_tpu.` imports as `from gridpp_tpu_torch.` (so a test
that patches or calls a module's helper reaches the port's), and its test
classes are exposed here under a `TestTorch` prefix. The files themselves
are not edited and still run against gridpp_tpu.
"""
import os
import types

import pytest

pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
IMPORT = "import gridpp_tpu as gridpp\n"
# module -> the test classes to expose (None: all of them)
MODULES = {
    "test_downscaling": None, "test_gradients": None,
    "test_calibration": None, "test_util": None,
    "test_grid_points": ("TestKDTree",), "test_ldc": None,
    "test_spatial_ops": None, "test_window": None, "test_diagnostics": None,
    "test_downscale_masking": None,
}


def _against_port(name):
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as fh:
        src = fh.read()
    assert src.count(IMPORT) == 1, path
    mod = types.ModuleType(f"torch_behaviour_{name}")
    mod.__file__ = path
    src = src.replace(IMPORT, "import gridpp_tpu_torch as gridpp\n")
    code = compile(src.replace("from gridpp_tpu.", "from gridpp_tpu_torch."),
                   path, "exec")
    exec(code, mod.__dict__)
    return mod


def _is_fixture(obj):
    # pytest >= 8.4 wraps a fixture in a FixtureFunctionDefinition, earlier
    # versions mark the function
    return hasattr(obj, "_fixture_function_marker") \
        or hasattr(obj, "_pytestfixturefunction")


for _name, _classes in MODULES.items():
    _mod = _against_port(_name)
    # the module's own fixtures (test_window.py's), which its classes ask for
    for _fix, _obj in vars(_mod).items():
        if _is_fixture(_obj):
            assert _fix not in globals(), _fix
            globals()[_fix] = _obj
    for _cls in _classes or [c for c in vars(_mod) if c.startswith("Test")]:
        _base = getattr(_mod, _cls)
        globals()[f"TestTorch{_cls[4:]}"] = type(
            f"TestTorch{_cls[4:]}", (_base,), {"__module__": __name__})
del _name, _classes, _mod, _cls, _base, _fix, _obj
