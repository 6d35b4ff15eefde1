from alignnet3d_tpu_torch.icp.p2point import (  # noqa: F401
    icp_p2point_batch,
    multistart_global_registration,
    refine_predictions,
)
from alignnet3d_tpu_torch.icp.p2plane import (  # noqa: F401
    estimate_normals_batch,
    icp_p2plane_batch,
)
from alignnet3d_tpu_torch.icp.runner import evaluate  # noqa: F401
