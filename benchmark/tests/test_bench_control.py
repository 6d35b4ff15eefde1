"""The comparison's control at a size a test run holds: the reference with
TF32 products in the program's place fails one of the cell's numbers, and
so do TF32 in the DGCNN's dense products alone and the training step on
half of each batch."""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark.tests.conftest import cpu_run, tiny


def _fails(cell, readings):
    return any(readings[name] > limit for name, limit in cell.limits.items())


@pytest.mark.parametrize("name", ["pointnet-track", "pointnet-offline",
                                  "dgcnn-offline"])
def test_tf32_control_fails_a_serving_cell(name):
    cell = tiny(name)
    assert _fails(cell, control.serve_readings(cpu_run(cell)))


def test_dense_tf32_with_a_float32_graph_fails_dgcnn_offline():
    cell = tiny("dgcnn-offline")
    assert _fails(cell, control.serve_readings(cpu_run(cell), "tf32_dense"))


@pytest.mark.parametrize("fault", ["tf32", "half_batch"])
def test_control_and_half_batch_fail_the_training_cell(fault):
    cell = tiny("dgcnn-train")
    assert _fails(cell, control.train_readings(cpu_run(cell), fault))
