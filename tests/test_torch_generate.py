"""The port's dataset-generation CLI (``python -m
alignnet3d_tpu_torch.data.generate``) against the JAX package's, variant by
variant at small sensor sizes: the four box variants file for file, the
mesh variant within the raycast tolerance of
``tests/test_torch_mesh_raycast.py``."""

import filecmp
import os
import subprocess
import sys

import pytest

from test_torch_mesh_raycast import _dataset_files, assert_mesh_datasets_agree

from alignnet3d_tpu.data import generate as jgen
from alignnet3d_tpu_torch.data import generate as gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--num_train", "4", "--num_val", "2", "--vres", "12", "--hres", "120"]


def test_same_variants():
    assert gen.VARIANTS == jgen.VARIANTS


@pytest.mark.parametrize("variant,seed", [
    ("SynthCars", 0), ("SynthCarsPersons", 9), ("Synth20", 3),
    ("Synth20others", 5),
])
def test_box_variants_are_file_equal(tmp_path, variant, seed, capsys):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    gen.main([variant, "--out", port, "--seed", str(seed), *SMALL])
    port_said = capsys.readouterr().out
    jgen.main([variant, "--out", ref, "--seed", str(seed), *SMALL])
    assert port_said == capsys.readouterr().out.replace(ref, port)
    files = _dataset_files(ref)
    assert _dataset_files(port) == files and len(files) == 3 * 6 + 2
    match, mismatch, errors = filecmp.cmpfiles(ref, port, files,
                                               shallow=False)
    assert mismatch == [] and errors == []


def test_mesh_variant_within_the_raycast_tolerance(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--seed", "2", *SMALL]
    gen.main(["SynthCarsMesh", "--out", port, *argv])
    jgen.main(["SynthCarsMesh", "--out", ref, *argv])
    assert_mesh_datasets_agree(port, ref)


def test_defaults_are_the_jax_clis():
    """Flags and defaults: the same parser in both packages."""
    import argparse

    seen = {}
    for name, mod in (("port", gen), ("jax", jgen)):
        captured = {}

        def fake(self, args=None, namespace=None, _c=captured):
            ns = real(self, args, namespace)
            _c.update(vars(ns))
            raise SystemExit(0)

        real = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = fake
        try:
            with pytest.raises(SystemExit):
                mod.main(["SynthCars", "--out", "d"])
        finally:
            argparse.ArgumentParser.parse_args = real
        seen[name] = captured
    assert seen["port"] == seen["jax"] == {
        "variant": "SynthCars", "out": "d", "num_train": 8000,
        "num_val": 1200, "seed": 0, "vres": 64, "hres": 1500}


def test_cli_module_runs_as_a_program(tmp_path):
    """``python -m alignnet3d_tpu_torch.data.generate`` in a process that
    cannot import jax or the JAX package."""
    out = str(tmp_path / "mesh")
    code = ("import runpy, sys\n"
            "for name in ('jax', 'flax', 'optax', 'alignnet3d_tpu'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['generate', 'SynthCarsMesh', '--out', %r, %s]\n"
            "runpy.run_module('alignnet3d_tpu_torch.data.generate',\n"
            "                 run_name='__main__')\n"
            % (out, ", ".join(repr(a) for a in SMALL)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == \
        f"SynthCarsMesh: wrote 4 train / 2 val scenes to {out}"
    assert len(_dataset_files(out)) == 3 * 6 + 2
