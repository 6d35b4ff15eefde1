"""The host-side code the port shares with the JAX package.

These modules of ``alignnet3d_tpu`` are numpy only and import no jax
(config, rigid-motion geometry, the synthetic LiDAR scenes and the input
filters), so the port reuses them rather than copying them. This module is
the one place that names them.
"""

from alignnet3d_tpu.config import config_from_dict, load_config  # noqa: F401
from alignnet3d_tpu.data.denoise import component_filter_indices  # noqa: F401
from alignnet3d_tpu.data.provider import voxel_dedup_indices  # noqa: F401
from alignnet3d_tpu.data.synthetic import SyntheticBoxScene  # noqa: F401
from alignnet3d_tpu.geometry import (  # noqa: F401
    compose_gated_refinement,
    get_mat_angle,
    get_mat_angle_batch,
    transform_points,
)
