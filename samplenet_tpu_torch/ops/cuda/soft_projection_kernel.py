"""Soft projection (k-NN softmax mixture), forward and backward: the CUDA
kernels' wrappers, their plain PyTorch versions and the autograd Function
that joins them.

Mirrors samplenet_tpu/ops/pallas/soft_projection_kernel.py: the forward
body `_soft_projection_kernel` (:35-80) and the VJP of `soft_project`
(:150-193), which the JAX package recomputes in XLA from the saved
indices; here the backward is a kernel too. For each query, the k
nearest points of its cloud, ascending, ties to the lowest index, weigh
w_i = exp(-(d_i - d_0) / sigma2) and the output is sum w_i p_i / sum w_i.
The argument `sigma` is already sigma^2 (:45, :74), and is read from
device memory, so no step syncs the host for it.

Distances are ((dx*dx + dy*dy) + dz*dz) as separate ops in the plain
version and with __fmul_rn/__fadd_rn in csrc/soft_projection.cu, and a NaN
distance counts as +inf in both, so on the card `idx` is bit-equal; the
weighted sums run in another order, so `out` and the gradients agree to
f32 round-off. The forward kernel's launch (lanes a query, block width,
points staged at a time) and the backward's (queries a block, threads
and points a block) come from soft_projection_plan.py; their
outputs do not depend on them. The backward's scatter into the points is a
one-hot bmm here, and in the kernels each point's entries summed in entry
order (query, rank): no float atomics, and no cap on N. Above k = 16 the
backward's kernels are the wide ones (plan `plan_bwd_wide`).
The kernels take f32; the plain versions also take f64 (a reference).

Any 1 <= k <= N runs a kernel: k <= 16 the register kernels, as the JAX
package runs its Pallas kernel there, and above that the wide ones
(csrc/soft_projection.cu, launch names KERNEL_FWD_WIDE and
KERNEL_BWD_WIDE), where the JAX package runs its XLA path
(samplenet_tpu/models/soft_projection.py:108); a cloud of more queries
than the register forward's grid holds (16,776,960) takes the wide
forward at any k. The wide forward's idx is bit-equal to the plain
version's too.
"""

from __future__ import annotations

import functools

import torch

from samplenet_tpu_torch.ops.chamfer import scatter_rows
from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
from samplenet_tpu_torch.ops.cuda._build import check, library, stream_handle
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel
from samplenet_tpu_torch.ops.knn import group_point

KERNEL_FWD = "soft_projection_fwd"
KERNEL_BWD = "soft_projection_bwd"
KERNEL_FWD_WIDE = "soft_projection_fwd_wide"   # k > spp.MAX_REGISTER_K
KERNEL_BWD_WIDE = "soft_projection_bwd_wide"


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


@functools.lru_cache(maxsize=256)
def fwd_plan(device: int, b: int, n: int, m: int) -> spp.FwdPlan:
    """The forward kernel's launch plan on CUDA device `device`; checks that
    the kernel counts shared memory, block widths and slices as the plan
    does."""
    lib = library()
    chunk = spp.fwd_chunk(n)
    if (lib.snt_soft_project_fwd_max_warps() != spp.MAX_WARPS
            or lib.snt_soft_project_fwd_max_slices() != spp.MAX_SLICES
            or lib.snt_soft_project_fwd_smem(chunk) != spp.fwd_smem(chunk)):
        raise RuntimeError("csrc/soft_projection.cu and soft_projection_plan"
                           ".py disagree on block widths, slices or shared "
                           "memory")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return spp.plan_fwd(b, n, m, sms=sms)


@functools.lru_cache(maxsize=256)
def fwd_wide_plan(device: int, b: int, n: int, m: int, k: int
                  ) -> spp.WideFwdPlan:
    """The wide forward's plan on CUDA device `device`; checks that the
    kernels count their register k, their limits and shared memory as the
    plan does."""
    lib = library()
    limits = [lib.snt_soft_project_fwd_wide_limit(i) for i in range(8)]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = spp.plan_fwd_wide(b, n, m, k, sms=sms)
    if (lib.snt_soft_project_max_register_k() != spp.MAX_REGISTER_K
            or limits != [spp.WIDE_WARPS, spp.PRUNE_WARPS, spp.SLOTS,
                          spp.MAX_GROUPS, spp.MAX_CAP, spp.MAX_CLUSTER,
                          spp.MAX_VISITS, spp.PRUNE_CHUNK]
            or not plan.radix and lib.snt_soft_project_fwd_pruned_smem(
                plan.ws, plan.cap, plan.chunk, plan.span) != plan.smem):
        raise RuntimeError("csrc/soft_projection.cu and soft_projection_plan"
                           ".py disagree on the register k, the wide "
                           "kernels' limits or shared memory")
    return plan


@functools.lru_cache(maxsize=256)
def _takes_register_fwd(device: int, b: int, m: int, k: int) -> bool:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return spp.takes_register_fwd(b, m, k, sms=sms)


def soft_project_fwd_cuda(points, queries, sigma, k: int):
    _cuda_checks(points, queries, sigma)
    b, n, _ = points.shape
    m = queries.shape[1]
    if not _takes_register_fwd(points.device.index, b, m, k):
        return launch_fwd_wide(points, queries, sigma, k,
                               fwd_wide_plan(points.device.index, b, n, m, k))
    plan = fwd_plan(points.device.index, b, n, m)
    return launch_fwd(points, queries, sigma, k, plan)


def launch_fwd(points, queries, sigma, k: int, plan: spp.FwdPlan):
    """The forward kernel on checked arguments under `plan`; the outputs do
    not depend on the plan (the card tests run others)."""
    b, n, _ = points.shape
    m = queries.shape[1]
    out = torch.empty((b, m, 3), dtype=torch.float32, device=points.device)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=points.device)
    lib = library()
    with torch.cuda.device(points.device):
        err = lib.snt_soft_project_fwd(
            points.data_ptr(), queries.data_ptr(), sigma.data_ptr(),
            out.data_ptr(), idx.data_ptr(), b, n, m, k, plan.chunk,
            plan.warps, plan.slices, stream_handle(points))
    check(err, KERNEL_FWD)
    count_launch(KERNEL_FWD)
    return out, idx


def launch_fwd_wide(points, queries, sigma, k: int, plan: spp.WideFwdPlan):
    """The wide forward on checked arguments under `plan`, any 1 <= k <= N
    (the card tests also run it at k <= 16, and under other plans); the
    outputs do not depend on the plan."""
    b, n, _ = points.shape
    m = queries.shape[1]
    out = torch.empty((b, m, 3), dtype=torch.float32, device=points.device)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=points.device)
    lib = library()
    with torch.cuda.device(points.device):
        err = lib.snt_soft_project_fwd_wide(
            points.data_ptr(), queries.data_ptr(), sigma.data_ptr(),
            out.data_ptr(), idx.data_ptr(), b, n, m, k, plan.ws, plan.cs,
            plan.groups, plan.cap, plan.chunk, stream_handle(points))
    check(err, KERNEL_FWD_WIDE)
    count_launch(KERNEL_FWD_WIDE)
    return out, idx


@functools.lru_cache(maxsize=256)
def bwd_plan(device: int, b: int, n: int, m: int, k: int
             ) -> spp.BwdPlan | spp.WideBwdPlan:
    """The backward kernels' launch plan on CUDA device `device` (above
    MAX_REGISTER_K the wide kernels'); checks that the kernels count their
    limits and shared memory as the plan does."""
    lib = library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if k > spp.MAX_REGISTER_K:
        plan = spp.plan_bwd_wide(b, n, m, k, sms=sms)
        limits = [lib.snt_soft_project_bwd_wide_limit(i) for i in range(9)]
        if (limits != [spp.WIDE_BWD_WARPS, spp.WIDE_RANKS,
                       spp.WIDE_POINT_THREADS, spp.WIDE_SPAN, spp.WINDOW_PER,
                       spp.STRIPES, spp.WIDE_GROUP, spp.WIDE_POINTS_PER,
                       spp.FUSED_ENTRIES]
                or lib.snt_soft_project_bwd_wide_smem(plan.threads, plan.span)
                != plan.smem
                or lib.snt_soft_project_bwd_fused_smem(n, m, k)
                != spp.fused_bwd_smem(n, m, k)):
            raise RuntimeError("csrc/soft_projection.cu and soft_projection_"
                               "plan.py disagree on the wide backward's "
                               "limits or shared memory")
        return plan
    plan = spp.plan_bwd(b, n, m, k, sms=sms)
    limits = [lib.snt_soft_project_bwd_limit(i) for i in range(5)]
    if (limits != [spp.MAX_TILE, spp.MAX_POINT_THREADS, spp.MAX_PER,
                   spp.UNROLL, spp.STRIPES]
            or lib.snt_soft_project_max_register_k() != spp.MAX_REGISTER_K
            or lib.snt_soft_project_bwd_smem(plan.threads, plan.span, m * k)
            != spp.bwd_smem(plan.threads, plan.span, m * k)):
        raise RuntimeError("csrc/soft_projection.cu and soft_projection_plan"
                           ".py disagree on the backward's limits or shared "
                           "memory")
    return plan


def soft_project_bwd_cuda(points, queries, sigma, idx, grad_out):
    _cuda_checks(points, queries, sigma, idx, grad_out)
    b, n, _ = points.shape
    m, k = idx.shape[1], idx.shape[2]
    if idx.dtype != torch.int32 or idx.shape[0] != b \
            or queries.shape != (b, m, 3) or grad_out.shape != (b, m, 3):
        raise ValueError(f"the soft_projection backward takes idx [B, M, k] "
                         f"int32 and queries, grad_out [B, M, 3], got "
                         f"{tuple(idx.shape)} {idx.dtype}, "
                         f"{tuple(queries.shape)}, {tuple(grad_out.shape)}")
    plan = bwd_plan(points.device.index, b, n, m, k)
    return launch_bwd(points, queries, sigma, idx, grad_out, plan)


def launch_bwd(points, queries, sigma, idx, grad_out,
               plan: spp.BwdPlan | spp.WideBwdPlan):
    """The backward kernels on checked arguments under `plan` (a
    WideBwdPlan: the wide kernels, which take any k; a BwdPlan: the
    register kernels, k up to MAX_REGISTER_K); the outputs do not depend
    on the plan (the card tests run others)."""
    b, n, _ = points.shape
    m, k = idx.shape[1], idx.shape[2]
    dpoints = torch.empty_like(points)
    dqueries = torch.empty_like(queries)
    if isinstance(plan, spp.WideBwdPlan):
        # contrib [B, M, k] of float4, dsq [B, M] of float64, then the
        # per-cloud partials of d sigma (the fused kernel: the partials)
        entries = 0 if plan.fused else b * m * k
        bm = 0 if plan.fused else b * m
        ws = torch.empty((4 * entries + 2 * bm + b,), dtype=torch.float32,
                         device=points.device)
        base = ws.data_ptr()
        with torch.cuda.device(points.device):
            err = library().snt_soft_project_bwd_wide(
                points.data_ptr(), queries.data_ptr(), sigma.data_ptr(),
                idx.data_ptr(), grad_out.data_ptr(), dpoints.data_ptr(),
                dqueries.data_ptr(), base + 16 * entries + 8 * bm, base,
                base + 16 * entries, b, n, m, k, plan.warps, plan.threads,
                plan.span, int(plan.fused), stream_handle(points))
        check(err, KERNEL_BWD_WIDE)
        count_launch(KERNEL_BWD_WIDE)
        return dpoints, dqueries, ws[4 * entries + 2 * bm:].sum().reshape(1)
    # one allocation: the kernels' workspace, contrib [B, k, M] of float4
    # then esd [B, k, M] of float2, and the per-cloud partials of d sigma
    entries = b * k * m
    ws = torch.empty((6 * entries + b,), dtype=torch.float32,
                     device=points.device)
    base = ws.data_ptr()
    lib = library()
    with torch.cuda.device(points.device):
        err = lib.snt_soft_project_bwd(
            points.data_ptr(), queries.data_ptr(), sigma.data_ptr(),
            idx.data_ptr(), grad_out.data_ptr(), dpoints.data_ptr(),
            dqueries.data_ptr(), base + 24 * entries, base,
            base + 16 * entries, b, n, m, k, plan.tile, plan.threads,
            plan.span, int(plan.count64), stream_handle(points))
    check(err, KERNEL_BWD)
    count_launch(KERNEL_BWD)
    # the partials summed in a fixed order
    return dpoints, dqueries, ws[6 * entries:].sum().reshape(1)


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
