"""Soft projection (k-NN softmax mixture), forward and backward: the CUDA
kernels' wrappers, their plain PyTorch versions and the autograd Function
that joins them.

Mirrors samplenet_tpu/ops/pallas/soft_projection_kernel.py: the forward
body `_soft_projection_kernel` (:35-80) and the VJP of `soft_project`
(:150-193), which the JAX package recomputes in XLA from the saved
indices; here the backward is a kernel too. For each query, the k <= 16
nearest points of its cloud, ascending, ties to the lowest index, weigh
w_i = exp(-(d_i - d_0) / sigma2) and the output is sum w_i p_i / sum w_i.
The argument `sigma` is already sigma^2 (:45, :74), and is read from
device memory, so no step syncs the host for it.

Distances are ((dx*dx + dy*dy) + dz*dz) as separate ops in the plain
version and with __fmul_rn/__fadd_rn in csrc/soft_projection.cu, and a NaN
distance counts as +inf in both, so on the card `idx` is bit-equal; the
weighted sums run in another order, so `out` and the gradients agree to
f32 round-off. The backward's scatter into the points is a one-hot bmm
here and a fixed-order sum in shared memory in the kernel: no atomics.
The kernels take f32; the plain versions also take f64 (a reference).
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.chamfer import scatter_rows
from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel
from samplenet_tpu_torch.ops.knn import group_point

KERNEL_FWD = "soft_projection_fwd"
KERNEL_BWD = "soft_projection_bwd"
MAX_GROUP = 16           # csrc/soft_projection.cu kMaxK
_QUERY_TILE = 8          # csrc/soft_projection.cu kQueryTile
_MAX_GRID_Y = 65535


def _check_args(points, queries, sigma, k: int) -> None:
    if points.dim() != 3 or queries.dim() != 3 or points.shape[-1] != 3 \
            or queries.shape[-1] != 3 or points.shape[0] != queries.shape[0]:
        raise ValueError(
            f"soft_project takes points [B, N, 3] and queries [B, M, 3], got "
            f"{tuple(points.shape)} and {tuple(queries.shape)}")
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"group size k={k} must be in [1, N={points.shape[1]}]")
    if queries.shape[1] == 0:
        raise ValueError("soft_project needs M >= 1 queries")
    for t in (points, queries, sigma):
        if t.dtype != points.dtype or t.dtype not in (torch.float32,
                                                      torch.float64):
            raise TypeError(f"soft_project takes float32 (or float64 on the "
                            f"plain path), got {t.dtype}")
        if t.device != points.device:
            raise ValueError("points, queries and sigma must share a device")
    if sigma.numel() != 1:
        raise ValueError(f"sigma is one value (sigma^2), got {tuple(sigma.shape)}")


def _sqdist(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, M, 3] x [B, N, 3] -> [B, M, N], ((dx*dx + dy*dy) + dz*dz)."""
    dx = queries[:, :, None, 0] - points[:, None, :, 0]
    dy = queries[:, :, None, 1] - points[:, None, :, 1]
    dz = queries[:, :, None, 2] - points[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _weights(d: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Normalised exp(-(d_i - d_0) / sigma2) over the last axis."""
    w = torch.exp(-(d - d[..., :1]) / sigma)
    return w / w.sum(-1, keepdim=True)


def soft_project_fwd_plain(points, queries, sigma, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, M, 3], idx [B, M, k] int32)."""
    d = _sqdist(queries, points)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    vals, idx = torch.sort(d, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    w = _weights(vals, sigma.reshape(()))
    out = (w[..., None] * group_point(points, idx)).sum(2)
    return out, idx.to(torch.int32)


def soft_project_bwd_plain(points, queries, sigma, idx, grad_out):
    """(d points [B, N, 3], d queries [B, M, 3], d sigma [1]) for the
    cotangent grad_out [B, M, 3] of the forward's output."""
    b, m, k = idx.shape
    s = sigma.reshape(())
    g = group_point(points, idx)                         # [B, M, k, 3]
    delta = g - queries[:, :, None, :]
    d = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]) \
        + delta[..., 2] * delta[..., 2]
    w = _weights(d, s)
    out = (w[..., None] * g).sum(2)
    u = (grad_out[:, :, None, :] * g).sum(-1)            # dL/dw_i
    e = w * (u - (grad_out * out).sum(-1, keepdim=True))  # dL/d(-d_i/s)
    dsigma = (e * (d - d[..., :1])).sum() / (s * s)
    two_dd = (-2.0 * e / s)[..., None]                   # 2 dL/dd_i
    dg = w[..., None] * grad_out[:, :, None, :] + two_dd * delta
    dqueries = -(two_dd * delta).sum(2)
    dpoints = scatter_rows(idx.reshape(b, m * k), dg.reshape(b, m * k, 3),
                           points.shape[1])
    return dpoints, dqueries, dsigma.reshape(1)


def _cuda_checks(*tensors) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"the soft_projection kernels take CUDA tensors, "
                         f"got {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the soft_projection kernels take contiguous tensors")
    if tensors[0].dtype != torch.float32:
        raise TypeError(f"the soft_projection kernels take float32, got "
                        f"{tensors[0].dtype}")


def soft_project_fwd_cuda(points, queries, sigma, k: int):
    _cuda_checks(points, queries, sigma)
    b, n, _ = points.shape
    m = queries.shape[1]
    if k > MAX_GROUP:
        raise ValueError(f"the soft_projection kernel takes k <= {MAX_GROUP}, "
                         f"got {k}")
    if -(-m // _QUERY_TILE) > _MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    out = torch.empty((b, m, 3), dtype=torch.float32, device=points.device)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=points.device)
    lib = library()
    with torch.cuda.device(points.device):
        err = lib.snt_soft_project_fwd(
            points.data_ptr(), queries.data_ptr(), sigma.data_ptr(),
            out.data_ptr(), idx.data_ptr(), b, n, m, k, stream_handle(points))
    check(err, KERNEL_FWD)
    count_launch(KERNEL_FWD)
    return out, idx


def soft_project_bwd_cuda(points, queries, sigma, idx, grad_out):
    _cuda_checks(points, queries, sigma, idx, grad_out)
    b, n, _ = points.shape
    m, k = idx.shape[1], idx.shape[2]
    lib = library()
    smem = lib.snt_soft_project_bwd_smem(n, k)
    if smem > max_dynamic_smem(points.device):
        raise ValueError(f"N={n}, k={k} need {smem} bytes of shared memory "
                         f"per block, more than the card offers")
    dpoints = torch.empty_like(points)
    dqueries = torch.empty_like(queries)
    dsig = torch.empty((b,), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = lib.snt_soft_project_bwd(
            points.data_ptr(), queries.data_ptr(), sigma.data_ptr(),
            idx.data_ptr(), grad_out.data_ptr(), dpoints.data_ptr(),
            dqueries.data_ptr(), dsig.data_ptr(), b, n, m, k,
            stream_handle(points))
    check(err, KERNEL_BWD)
    count_launch(KERNEL_BWD)
    # per-cloud partials of d sigma, summed in a fixed order
    return dpoints, dqueries, dsig.sum().reshape(1)


class _SoftProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, queries, sigma, k):
        # the device decides once, at the forward: the backward runs on
        # autograd's own thread, outside any plain_on_cuda() block
        ctx.kernel = use_kernel(points)
        ctx.sigma_shape = sigma.shape
        points, queries = points.contiguous(), queries.contiguous()
        sigma = sigma.reshape(1).contiguous()
        if ctx.kernel:
            out, idx = soft_project_fwd_cuda(points, queries, sigma, k)
        else:
            out, idx = soft_project_fwd_plain(points, queries, sigma, k)
        ctx.save_for_backward(points, queries, sigma, idx)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, grad_out, _grad_idx):
        points, queries, sigma, idx = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        if ctx.kernel:
            dp, dq, ds = soft_project_bwd_cuda(points, queries, sigma, idx,
                                               grad_out)
        else:
            dp, dq, ds = soft_project_bwd_plain(points, queries, sigma, idx,
                                                grad_out)
        return dp, dq, ds.reshape(ctx.sigma_shape), None


def soft_project(points: torch.Tensor, queries: torch.Tensor,
                 sigma: torch.Tensor, k: int = 7
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(projected [B, M, 3], idx [B, M, k] int32) of queries [B, M, 3] onto
    points [B, N, 3], with sigma = sigma^2 a one-element tensor.
    Differentiable in points, queries and sigma. CPU tensors take the
    plain versions, CUDA tensors the kernels (ops/dispatch.py)."""
    _check_args(points, queries, sigma, k)
    return _SoftProject.apply(points, queries, sigma, k)
