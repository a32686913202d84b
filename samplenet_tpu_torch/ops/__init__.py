"""Point-cloud ops of the port: pairwise distances, Chamfer, k-NN and
grouping, FPS, matching, and the CUDA kernels under ops/cuda (counterpart
of samplenet_tpu/ops/__init__.py)."""

# ops.cuda first: its soft projection imports ops.chamfer, which imports
# ops.cuda's 1-NN wrapper
from samplenet_tpu_torch.ops.cuda import (  # noqa: F401
    fold_bn_affine,
    nn_direction,
    point_mlp_max,
)
from samplenet_tpu_torch.ops.chamfer import (  # noqa: F401
    chamfer_distance,
    chamfer_loss,
    nn_distance,
)
from samplenet_tpu_torch.ops.fps import (  # noqa: F401
    farthest_point_sample,
    farthest_point_sample_with_points,
    fps_from_given,
    fps_from_given_with_points,
    gather_point,
    non_sampled,
    prob_sample,
)
from samplenet_tpu_torch.ops.knn import (  # noqa: F401
    group_point,
    knn_point,
    query_ball_point,
    select_top_k,
)
from samplenet_tpu_torch.ops.matching import (  # noqa: F401
    approx_match,
    emd_loss,
    emd_matching,
    first_occurrence_mask,
    match_cost,
    nn_match_from_clouds,
    nn_match_indices,
    nn_matching,
)
from samplenet_tpu_torch.ops.pairwise import (  # noqa: F401
    chunked_min_argmin,
    chunked_topk_neg,
    pairwise_sqdist,
)
