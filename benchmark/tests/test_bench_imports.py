"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from benchmark import harness

BLOCK = """
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "alignnet3d_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
"""

ALL = BLOCK + """
import pathlib, importlib
from benchmark import harness
root = harness.BENCH_DIR
for path in sorted(root.rglob("*.py")):
    rel = path.relative_to(root.parent)
    if "tests" in rel.parts or ".cache" in rel.parts:
        continue
    if rel.parts[1] == "layer_metrics" and not path.stem.startswith("_") \\
            and path.stem != "__init__":
        harness.reader(path.stem)
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts))
import alignnet3d_tpu_torch.api, alignnet3d_tpu_torch.training.trainer
top = {m.split(".", 1)[0] for m in sys.modules}
print(sorted(top & BLOCKED | ({"alignnet3d_tpu_torch"} - top)))
"""

REFERENCE = BLOCK + """
import benchmark.reference.model, benchmark.reference.serve
import benchmark.reference.train
print(sorted({m.split(".", 1)[0] for m in sys.modules}
             & {"alignnet3d_tpu_torch", "jax", "alignnet3d_tpu"}))
"""


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_no_module_of_the_benchmark_loads_jax():
    assert _run(ALL) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    assert _run(REFERENCE) == "[]"
