"""samplenet-tpu, PyTorch/CUDA port: the SampleNet serving path, the
classification track (the PointNet classifier, the sampler trained
against it, the evaluation protocols), the reconstruction track (the
autoencoder and the sampler against it, with approximate EMD), the
registration track (PCRNet and the sampler against it) and the
progressive track on PyTorch with hand-written Hopper kernels, the
serving daemon and its torch.export artifacts, the AE analysis ops and
the JAX package's public ops library.

The counterpart of samplenet_tpu/__init__.py. The JAX package stays the
reference; this package imports torch and never jax or samplenet_tpu, and
mirrors its layout: ops/ (ops/cuda for ops/pallas, CUDA sources in csrc/),
nn/, models/, geometry/, data/, train/, interop/, serving.py and serve.py.
Importing builds and loads no kernel. A CPU tensor runs each kernel's plain PyTorch
version, a CUDA tensor the kernel (ops/dispatch.py).
"""

__version__ = "0.1.0"

from samplenet_tpu_torch.models import SampleNet, SimplificationNet  # noqa: F401
from samplenet_tpu_torch.ops import (  # noqa: F401
    approx_match,
    chamfer_distance,
    chamfer_loss,
    emd_loss,
    emd_matching,
    farthest_point_sample,
    fps_from_given,
    gather_point,
    group_point,
    knn_point,
    match_cost,
    nn_direction,
    nn_distance,
    nn_match_from_clouds,
    nn_match_indices,
    nn_matching,
    prob_sample,
    query_ball_point,
)
