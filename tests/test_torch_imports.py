"""The port needs nothing of jax, flax, optax, tqdm or the JAX package
``alignnet3d_tpu``: every module of the port (the training modules
included), and every module that ``chip_smoke.py`` imports, imports in a
process where they cannot be imported, and no source names them. The port
keeps its own copies of the numpy host code it shares with the JAX
package."""

import os
import re
import subprocess
import sys

import alignnet3d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(alignnet3d_tpu_torch.__file__)
BLOCKED = ("jax", "flax", "optax", "tqdm", "alignnet3d_tpu")

_BLOCK = """
import importlib, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of them raises ImportError
""".format(blocked=BLOCKED)

_PROBE = _BLOCK + """
import pkgutil
import alignnet3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_with_jax_blocked():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    # every .py file is one module, the package's own __init__ aside
    expected = sum(f.endswith(".py") for _, _, fs in os.walk(PKG_DIR)
                   for f in fs) - 1
    assert int(proc.stdout.strip().splitlines()[-1]) == expected


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|tqdm)\b",
                         re.M)
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f


def _imports(path):
    with open(path) as fh:
        return re.findall(r"^\s*(?:import|from)\s+([\w.]+)", fh.read(), re.M)


def test_only_host_module_imports_the_jax_package():
    """No module of the port imports the JAX package, with no exemption:
    the host code it needs is copied into the port."""
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                mods = _imports(os.path.join(root, f))
                assert not any(m.split(".")[0] == "alignnet3d_tpu"
                               for m in mods), f


def test_chip_smoke_imports_the_port_only():
    mods = _imports(os.path.join(REPO, "chip_smoke.py"))
    roots = {m.split(".")[0] for m in mods}
    assert "alignnet3d_tpu_torch" in roots
    assert not roots & set(BLOCKED)


def test_chip_smoke_and_its_imports_load_with_the_jax_package_blocked():
    """Every module chip_smoke.py names, at the top or inside a function,
    and chip_smoke.py itself, import with jax and the JAX package blocked."""
    mods = sorted(set(_imports(os.path.join(REPO, "chip_smoke.py"))))
    code = _BLOCK + f"""
for name in {mods!r}:
    importlib.import_module(name)
import chip_smoke
print(len({mods!r}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) == len(mods)


def test_the_training_slice_is_among_the_modules():
    """The training path's modules are part of the package the probes
    above walk."""
    import pkgutil

    names = {m.name for m in pkgutil.walk_packages(
        alignnet3d_tpu_torch.__path__, "alignnet3d_tpu_torch.")}
    assert {"alignnet3d_tpu_torch.training.trainer",
            "alignnet3d_tpu_torch.training.schedules",
            "alignnet3d_tpu_torch.models.losses",
            "alignnet3d_tpu_torch.ops.stable_max",
            "alignnet3d_tpu_torch.ops.edge_train_kernels",
            "alignnet3d_tpu_torch.evaluation.metrics"} <= names
