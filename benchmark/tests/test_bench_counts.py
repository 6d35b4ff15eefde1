"""The yardstick's operation and byte counts, worked by hand at the main
path's shapes."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.counts import (alignnet, fused_edge_stage,
                              fused_edge_stage_train, fused_pointnet,
                              knn_points, nn_argmin, peaks)


def _model(config):
    return json.loads((harness.BENCH_DIR / "configs" /
                       f"{config}.json").read_text())["model"]


def test_edge_stage_at_the_stacked_batch():
    # 256 clouds x 512 points x 20 edges x 64 x 128 x 2 = 42.9 GFLOP
    assert fused_edge_stage.count(256, 512, 20, 64, 128)["dot_flops"] \
        == 2 * 256 * 512 * 20 * 64 * 128 == 42_949_672_960
    train = fused_edge_stage_train.count(256, 512, 20, 3, 64, 128)
    assert train["dot_flops"] == 3 * (42_949_672_960
                                      + 2 * 2 * 256 * 512 * 3 * 64)


def test_nearest_neighbour_counts_the_valid_pairs():
    w = nn_argmin.count(2, 4096, 4096, 3000 + 4096)
    assert w["lane_ops"] == 4096 * 7096
    assert w["dot_flops"] == 6 * 4096 * 7096
    assert knn_points.count(256, 512, 20)["lane_ops"] == 256 * 512 * 512


def test_pointnet_chain():
    w = fused_pointnet.count(256, 512, (3, 64, 128, 1024))
    assert w["dot_flops"] == 2 * 256 * 512 * (3 * 64 + 64 * 128 + 128 * 1024)
    assert w["lane_ops"] == 256 * 512 * (64 + 128 + 1024 + 1024)


def test_model_flops():
    # PointNet: 0.526 GFLOP a pair; DGCNN training step at 128 pairs
    assert alignnet.flops(_model("pointnet-synthcars"), 1) == \
        pytest.approx(0.52641536e9)
    assert alignnet.flops(_model("dgcnn-synthcars40k"), 128, train=True) \
        == pytest.approx(571.024146432e9)
    calls = alignnet.kernel_calls(_model("dgcnn-synthcars40k"), 128, True)
    assert calls["fused_edge_stage_train"][0] == (256, 512, 20, 3, 64, 128)
    assert len(alignnet.kernel_calls(_model("pointnet-synthcars"),
                                     128)["fused_pointnet"]) == 3


def test_least_time_takes_the_largest_bound():
    w = {"bytes": 3.35e12, "dot_flops": 495e12 * 2, "lane_ops": 33.5e12}
    assert peaks.least_seconds(w) == pytest.approx(2.0)
