"""Ahead-of-time serialized deployment artifacts via ``torch.export``.

Counterpart of ``alignnet3d_tpu/export.py``. The BN-folded serving forward
(``serving.FoldedAlignNet``) is traced once with a *symbolic batch
dimension*; its folded weights are embedded in the program, and the saved
bytes can be stored, shipped, reloaded and executed without the model
code, the checkpoint or ``serving.py``:

    blob = export_alignment_model(spec, state_dict, "model.pt2")
    infer = load_exported("model.pt2")   # fn(pcs1, pcs2) -> end_points
    out = infer(pcs1, pcs2)              # any batch size, N fixed

The program calls the port's hand-written kernels as ``torch.library``
custom ops (``alignnet3d_torch::fused_pointnet``, ``::knn_points``,
``::fused_edge_stage``), which this module imports, so a loaded artifact
launches the same kernels on the card as the eager forward, and their
plain twins on the CPU. A loader needs those op registrations and nothing
else of the package.

Across devices, the counterpart of the JAX package's ``platforms=("tpu",
"cpu")``: an artifact exported on one device serves on another;
``load_exported`` moves its weights and every device the graph records
(``torch.export.passes.move_to_device_pass``) to the device asked for.
"""

from __future__ import annotations

import io

import torch
from torch.export.passes import move_to_device_pass

# the ops the exported program calls: importing registers them
from alignnet3d_tpu_torch.ops import edge_conv_kernels  # noqa: F401
from alignnet3d_tpu_torch.ops import knn_kernels  # noqa: F401
from alignnet3d_tpu_torch.ops import pointnet_kernels  # noqa: F401

# end_points keys in a fixed order so the exported flat outputs can be
# rebuilt into the dict by a loader that never imports the model code
OUTPUT_KEYS = (
    "pred_s1_pc1centers",
    "pred_s1_pc2centers",
    "pred_s2_pc1centers",
    "pred_s2_pc2centers",
    "pred_pc1angle_logits",
    "pred_pc2angle_logits",
    "pred_translations",
    "pred_remaining_angle_logits",
)


def export_alignment_model(spec, state_dict, path: str | None = None, *,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           device: torch.device | str = "cuda") -> bytes:
    """Serialize the folded serving forward of ``state_dict`` (the port's
    ``AlignNet`` state dict) to a ``torch.export`` artifact traced on
    ``device``.

    The batch dimension is exported symbolically (``b``), so one artifact
    serves every batch size; ``spec.num_points`` stays static. Weights are
    folded (BN into dense, ``serving.py``) and embedded. Returns the
    serialized bytes; also writes them to ``path`` when given.
    """
    from alignnet3d_tpu_torch.serving import FoldedAlignNet

    module = FoldedAlignNet(spec, state_dict, compute_dtype, device=device)
    # traced at b = 2 so that the batch is not specialised to 0 or 1; two
    # tensors, as one passed twice would be traced as one input
    args = tuple(torch.zeros((2, spec.num_points, 3), dtype=torch.float32,
                             device=device) for _ in range(2))
    batch = torch.export.Dim("b", min=1)
    with torch.no_grad():
        exported = torch.export.export(
            module, args, dynamic_shapes=({0: batch}, {0: batch}))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def load_exported(path_or_bytes, device: torch.device | str = "cuda"):
    """Rehydrate an exported artifact into ``fn(pcs1, pcs2) -> dict`` that
    runs on ``device``.

    Needs only this module and the port's op registrations: no ModelSpec,
    no checkpoint, no model code. ``pcs1``, ``pcs2`` are (B, N, 3) arrays
    or tensors; they are moved to ``device`` as float32.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = io.BytesIO(bytes(path_or_bytes))
    else:
        src = path_or_bytes
    exported = torch.export.load(src)
    exported = move_to_device_pass(exported, device)
    call = exported.module()

    def infer(pcs1, pcs2):
        args = (torch.as_tensor(p, dtype=torch.float32, device=device)
                for p in (pcs1, pcs2))
        with torch.no_grad():
            return dict(zip(OUTPUT_KEYS, call(*args)))

    return infer
