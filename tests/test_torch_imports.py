"""The port never needs jax, flax or optax: every module imports in a
process where they cannot be imported, and no source names them. Only
``host.py`` reaches into the JAX package (its jax-free host modules), and
``chip_smoke.py`` imports the port alone."""

import os
import re
import subprocess
import sys

import alignnet3d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(alignnet3d_tpu_torch.__file__)

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax"):
    sys.modules[name] = None  # any import of them raises ImportError
import alignnet3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every .py file is one module, the package's own __init__ aside
    expected = sum(f.endswith(".py") for _, _, fs in os.walk(PKG_DIR)
                   for f in fs) - 1
    assert int(proc.stdout.strip().splitlines()[-1]) == expected


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f


def _imports(path):
    with open(path) as fh:
        return re.findall(r"^\s*(?:import|from)\s+([\w.]+)", fh.read(), re.M)


def test_only_host_module_imports_the_jax_package():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py") and f != "host.py":
                mods = _imports(os.path.join(root, f))
                assert not any(m.split(".")[0] == "alignnet3d_tpu"
                               for m in mods), f


def test_chip_smoke_imports_the_port_only():
    mods = _imports(os.path.join(REPO, "chip_smoke.py"))
    roots = {m.split(".")[0] for m in mods}
    assert "alignnet3d_tpu_torch" in roots
    assert not roots & {"alignnet3d_tpu", "jax", "flax", "optax"}
