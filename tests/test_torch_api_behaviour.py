"""The repo's behavioural tests of downscaling, gradients, calibration, the
util helpers and KDTree, run against gridpp_tpu_torch's namespace.

Each test module (tests/test_downscaling.py, test_gradients.py,
test_calibration.py, test_util.py and test_grid_points.py's TestKDTree;
TEST_MAP.md maps them to the reference's tests) is compiled once more from
its file under another module name, with its one `import gridpp_tpu as
gridpp` read as `import gridpp_tpu_torch as gridpp` (so its module-level
grids and points are the port's too), and its test classes are exposed
here under a `TestTorch` prefix. The files themselves are not edited and
still run against gridpp_tpu.
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
    "test_grid_points": ("TestKDTree",),
}


def _against_port(name):
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as fh:
        src = fh.read()
    assert src.count(IMPORT) == 1, path
    mod = types.ModuleType(f"torch_behaviour_{name}")
    mod.__file__ = path
    code = compile(src.replace(IMPORT, "import gridpp_tpu_torch as gridpp\n"),
                   path, "exec")
    exec(code, mod.__dict__)
    return mod


for _name, _classes in MODULES.items():
    _mod = _against_port(_name)
    for _cls in _classes or [c for c in vars(_mod) if c.startswith("Test")]:
        _base = getattr(_mod, _cls)
        globals()[f"TestTorch{_cls[4:]}"] = type(
            f"TestTorch{_cls[4:]}", (_base,), {"__module__": __name__})
del _name, _classes, _mod, _cls, _base
