"""The port needs nothing of jax, flax, optax, tqdm, msgpack or the JAX
package ``alignnet3d_tpu``: every module of the port (the training modules
included), and every module that ``chip_smoke.py`` imports, imports in a
process where they cannot be imported, and no source names them. The port
keeps its own copies of the numpy host code it shares with the JAX
package, and of its native batch assembler: it never loads the JAX
package's ``native/libalignnet_loader.so``."""

import os
import re
import subprocess
import sys

import pytest

import alignnet3d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(alignnet3d_tpu_torch.__file__)
BLOCKED = ("jax", "flax", "optax", "tqdm", "msgpack", "alignnet3d_tpu")

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
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|tqdm|msgpack)\b",
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
            "alignnet3d_tpu_torch.evaluation.metrics",
            "alignnet3d_tpu_torch.cli",
            "alignnet3d_tpu_torch.icp.p2plane",
            "alignnet3d_tpu_torch.checkpoint",
            "alignnet3d_tpu_torch.data.residual",
            "alignnet3d_tpu_torch.icp.fpfh",
            "alignnet3d_tpu_torch.icp.fgr",
            "alignnet3d_tpu_torch.icp.runner",
            "alignnet3d_tpu_torch.data.native_loader",
            "alignnet3d_tpu_torch.data.kitti",
            "alignnet3d_tpu_torch.data.kitti_generate",
            "alignnet3d_tpu_torch.data.held"} <= names


@pytest.mark.parametrize("module", ["native_loader", "kitti",
                                    "kitti_generate", "held"])
def test_data_modules_load_alone_with_jax_blocked(module):
    """The native batch assembler's binding and the KITTI/Held toolchain
    import on their own with jax and the JAX package blocked, and their
    sources name none of them."""
    proc = _run(_BLOCK + f"""
importlib.import_module("alignnet3d_tpu_torch.data.{module}")
print("ok")
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert not {m.split(".")[0] for m in _imports(
        os.path.join(PKG_DIR, "data", f"{module}.py"))} & set(BLOCKED)


def test_the_port_never_loads_the_jax_packages_native_library(tmp_path):
    """Every port module imported and a batch assembled by the native
    path, in a process with the JAX package blocked: the process maps the
    port's own loader library and not native/libalignnet_loader.so."""
    proc = _run(_BLOCK + f"""
import pkgutil
import numpy as np
import alignnet3d_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from alignnet3d_tpu_torch.data import native_loader, provider, synthetic
base = {str(tmp_path / "ds")!r}
synthetic.generate_dataset(base, 4, 2, seed=0, vres=8, hres=60)
batch = provider.PackedDataset(base).sample_batch(
    [0, 1], 16, np.random.default_rng(0))
assert batch[0].shape == (2, 16, 3)
with open("/proc/self/maps") as f:
    maps = f.read()
print("port" if str(native_loader.library_path()) in maps else "no-port")
print("jax" if "libalignnet_loader.so" in maps else "no-jax")
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-2:] == ["port", "no-jax"]


@pytest.mark.parametrize("module", ["fpfh", "fgr", "runner"])
def test_classical_baseline_modules_load_alone_with_jax_blocked(module):
    """The classical baselines (FPFH + RANSAC, FGR, the standalone runner)
    import on their own with jax, flax, optax and the JAX package blocked,
    and their sources name none of them."""
    proc = _run(_BLOCK + f"""
importlib.import_module("alignnet3d_tpu_torch.icp.{module}")
print("ok")
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert not {m.split(".")[0] for m in _imports(
        os.path.join(PKG_DIR, "icp", f"{module}.py"))} & set(BLOCKED)


def test_kernel_bench_and_its_imports_load_with_the_jax_package_blocked():
    """kernel_bench.py, the kernels' timing script for the card, imports the
    port and chip_smoke.py only, and loads with jax and the JAX package
    blocked."""
    mods = sorted(set(_imports(os.path.join(REPO, "kernel_bench.py"))))
    roots = {m.split(".")[0] for m in mods}
    assert {"alignnet3d_tpu_torch", "chip_smoke"} <= roots
    assert not roots & set(BLOCKED)
    proc = _run(_BLOCK + f"""
for name in {mods!r}:
    importlib.import_module(name)
import kernel_bench
print(len({mods!r}))
""")
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) == len(mods)


def test_the_deployment_and_dataset_modules_are_among_the_modules():
    """The modules of the export, generation and host-tail slice are part
    of the package the probes above walk."""
    import pkgutil

    names = {m.name for m in pkgutil.walk_packages(
        alignnet3d_tpu_torch.__path__, "alignnet3d_tpu_torch.")}
    assert {"alignnet3d_tpu_torch.export",
            "alignnet3d_tpu_torch.data.generate",
            "alignnet3d_tpu_torch.data.mesh_raycast",
            "alignnet3d_tpu_torch.evaluation.quickscore",
            "alignnet3d_tpu_torch.utils.runs",
            "alignnet3d_tpu_torch.utils.euler",
            "alignnet3d_tpu_torch.utils.ply",
            "alignnet3d_tpu_torch.utils.pc_util"} <= names


@pytest.mark.parametrize("module", [
    "export", "data.generate", "data.mesh_raycast", "evaluation.quickscore",
    "utils.runs", "utils.euler", "utils.ply", "utils.pc_util"])
def test_new_modules_load_alone_in_a_fresh_process_with_jax_blocked(module):
    """Each module of the slice imports first and alone in a fresh process
    with jax, flax, optax and the JAX package blocked, and its source
    names none of them; ``export`` registers the three custom ops."""
    proc = _run(_BLOCK + f"""
importlib.import_module("alignnet3d_tpu_torch.{module}")
import torch
ops = [n for n in ("fused_pointnet", "knn_points", "fused_edge_stage")
       if hasattr(torch.ops.alignnet3d_torch, n)]
print(ops)
""")
    assert proc.returncode == 0, proc.stderr
    if module == "export":
        assert proc.stdout.strip().splitlines()[-1] == \
            "['fused_pointnet', 'knn_points', 'fused_edge_stage']"
    path = os.path.join(PKG_DIR, *module.split(".")) + ".py"
    assert not {m.split(".")[0] for m in _imports(path)} & set(BLOCKED)


def test_the_port_never_loads_the_jax_packages_raycaster(tmp_path):
    """A mesh dataset generated by the port's CLI, in a process with the
    JAX package blocked, maps the port's g++ build of ``csrc/raycast.cpp``
    and not native/libalignnet_raycast.so."""
    proc = _run(_BLOCK + f"""
from alignnet3d_tpu_torch.data import generate, mesh_raycast, native_loader
generate.main(["SynthCarsMesh", "--out", {str(tmp_path / "mesh")!r},
               "--num_train", "2", "--num_val", "1", "--vres", "8",
               "--hres", "90"])
assert mesh_raycast.get_lib() is not None
with open("/proc/self/maps") as f:
    maps = f.read()
path = native_loader.host_library_path(mesh_raycast.SOURCE, "raycast")
print("port" if str(path) in maps else "no-port")
print("jax" if "libalignnet_raycast.so" in maps else "no-jax")
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-2:] == ["port", "no-jax"]
