"""Point-cloud ops of the port: FPS, hard matching, and the CUDA kernels
under ops/cuda (counterpart of samplenet_tpu/ops/__init__.py)."""

from samplenet_tpu_torch.ops.cuda import (  # noqa: F401
    fold_bn_affine,
    nn_direction,
    point_mlp_max,
)
from samplenet_tpu_torch.ops.fps import (  # noqa: F401
    farthest_point_sample,
    farthest_point_sample_with_points,
    fps_from_given,
    fps_from_given_with_points,
    gather_point,
)
from samplenet_tpu_torch.ops.matching import (  # noqa: F401
    first_occurrence_mask,
    nn_match_from_clouds,
    nn_match_indices,
    nn_matching,
)
