"""Dot-product FLOPs of the AlignNet model, and the kernel calls its
forward makes, from a config's ``model`` section.

A cloud runs three backbones (transformer1, transformer2, the embedding)
and two heads; a pair adds the remaining head on both embeddings. The
backbone's own counts come from ``benchmark/backbones/<backbone>.py``
(``flops``: its dense products and its graph's, ``kernel_calls``). A
training step counts 3 x the forward (forward, input and weight
gradients) but the graph once.
"""

from benchmark import harness


def _head(widths):
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def flops(model: dict, pairs: int, train: bool = False,
          bench_dir=harness.BENCH_DIR) -> float:
    opts = model["options"]
    n = model["num_points"]
    backbone = harness.backbone(model["backbone"], bench_dir)
    bins = model["angles"]["num_bins"]
    dense, graph = 0, 0
    for sizes, head_out in ((opts["s1transformer"], 3),
                            (opts["s2transformer"], 3 + 2 * bins)):
        d, g = backbone.flops(n, sizes[0])
        dense += d + _head((sizes[0][-1], *sizes[1][0], head_out))
        graph += g
    d, g = backbone.flops(n, opts["embedding"])
    dense, graph = 2 * (dense + d), 2 * (graph + g)  # two clouds a pair
    rem = opts["remaining_transform_prediction"][0]
    dense += _head((2 * opts["embedding"][-1], *rem, 3 + 2 * bins))
    return pairs * ((3 if train else 1) * dense + graph)


def kernel_calls(model: dict, batch_pairs: int, train: bool = False,
                 bench_dir=harness.BENCH_DIR) -> dict:
    """{kernel: [shape args of count()]} of one forward (or training step)
    at ``batch_pairs`` pairs: both clouds run stacked, 2 x batch_pairs."""
    opts = model["options"]
    stacks = [opts["s1transformer"][0], opts["s2transformer"][0],
              opts["embedding"]]
    return harness.backbone(model["backbone"], bench_dir).kernel_calls(
        2 * batch_pairs, model["num_points"], stacks, train)
