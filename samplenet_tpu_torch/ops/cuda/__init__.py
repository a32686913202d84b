"""Hand-written Hopper kernels (CUDA C++ for sm_90a in ../../csrc), each with
its wrapper and plain PyTorch version; the counterpart of
samplenet_tpu/ops/pallas/. Importing builds and loads nothing: the kernel
library is compiled and loaded at the first launch (_build.py)."""

from samplenet_tpu_torch.ops.cuda.chamfer_kernel import (  # noqa: F401
    nn_direction,
    nn_direction_plain,
    nn_distance_pallas,
    nn_snap,
    nn_snap_plain,
)
from samplenet_tpu_torch.ops.cuda.emd_kernel import (  # noqa: F401
    emd_cost,
    emd_cost_plain,
)
from samplenet_tpu_torch.ops.cuda.fps_kernel import fps, fps_plain  # noqa: F401
from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (  # noqa: F401
    point_mlp_exact_bwd_plain,
    point_mlp_exact_fwd_plain,
    point_mlp_exact_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (  # noqa: F401
    auto_block_b,
    point_mlp_train_bwd_plain,
    point_mlp_train_fwd_plain,
    point_mlp_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import (  # noqa: F401
    fold_bn_affine,
    point_mlp_max,
    point_mlp_max_plain,
)
from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import (  # noqa: F401
    soft_project,
    soft_project_bwd_plain,
    soft_project_fwd_plain,
)
