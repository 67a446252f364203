"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions and the device dispatch (see ``publish_gather.py`` and
``scatter_max.py``); the ``nvcc`` build lives in ``build.py``."""

from sidecar_tpu_torch.ops.kernels.publish_gather import (  # noqa: F401
    board_row_gather,
    board_row_gather_cuda,
    board_row_gather_torch,
    eligible_lines,
    fused_publish_gather,
    fused_publish_gather_cuda,
    fused_publish_gather_torch,
    publish_board,
    publish_board_cuda,
    publish_board_torch,
)
from sidecar_tpu_torch.ops.kernels.scatter_max import (  # noqa: F401
    rmw_max,
    rmw_max_cuda,
    rmw_max_torch,
    scatter_max_apply,
    scatter_max_apply_cuda,
    scatter_max_apply_torch,
)
