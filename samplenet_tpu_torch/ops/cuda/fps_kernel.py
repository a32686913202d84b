"""Seeded farthest point sampling emitting indices and points: the CUDA
kernel's wrapper and its plain PyTorch version.

Mirrors samplenet_tpu/ops/pallas/fps_kernel.py:27-88 (the Pallas body) and
:173-248, whose four entry points are all this one kernel: the plain FPS is
count = 1 with given[:, 0] = start (ops/fps.py builds those arguments). The
kernel is csrc/fps.cu; its note says what bounds it and how it is laid out,
and its launch (warps a cloud, points a thread) comes from fps_plan.py.
Both versions compute (dx*dx + dy*dy) + dz*dz without FMA contraction,
keep the running minimum with NaN propagated (torch.minimum) and take the
first index of the maximum, NaN ranked above every number (torch.argmax),
so on the card they agree bit for bit; a picked point with a NaN
coordinate makes every distance NaN, and the next pick is index 0, as in
the JAX package.

Clouds the block kernel cannot take (N above 16,384, or the cloud and the
picks beyond a block's shared memory) run its cluster variant, counted
as KERNEL_CLUSTER: any N up to int32 indexing and any k, with the same
bits, C blocks a cloud as the plan picks from what the card runs at once
(`cluster_active`). Off the TPU the JAX package runs these through its XLA scan
(samplenet_tpu/ops/fps.py:36-43).

Precondition, as in the JAX package: given[b, :count[b]] lie in [0, N).
"""

from __future__ import annotations

import functools

import torch

from samplenet_tpu_torch.ops.cuda import fps_plan as fp
from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "fps"
KERNEL_CLUSTER = "fps_cluster"


def _check_args(points, given, count, npoint) -> None:
    if points.dim() != 3 or points.shape[-1] != 3 or points.shape[1] == 0:
        raise ValueError(f"fps takes points [B, N>=1, 3], got "
                         f"{tuple(points.shape)}")
    b = points.shape[0]
    if npoint < 1 or tuple(given.shape) != (b, npoint) \
            or tuple(count.shape) != (b,):
        raise ValueError(
            f"fps takes given [B, npoint] and count [B] with npoint >= 1; got "
            f"given {tuple(given.shape)}, count {tuple(count.shape)}, "
            f"npoint {npoint}, B {b}")
    if points.dtype != torch.float32:
        raise TypeError(f"fps takes float32 points, got {points.dtype}")
    if given.dtype != torch.int32 or count.dtype != torch.int32:
        raise TypeError(f"fps takes int32 given and count, got "
                        f"{given.dtype}, {count.dtype}")
    if not (points.device == given.device == count.device):
        raise ValueError("points, given and count must share a device")


def fps_plain(points: torch.Tensor, given: torch.Tensor, count: torch.Tensor,
              npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx [B, npoint] int32, xyz [B, npoint, 3]): the loop of
    samplenet_tpu/ops/fps.py:130-141, one step per output point; NaN
    propagates through torch.minimum and ranks first in torch.argmax."""
    b, n, _ = points.shape
    px, py, pz = points.unbind(-1)                      # [B, N] each
    rows = torch.arange(b, device=points.device)
    dist = torch.full((b, n), float("inf"), dtype=torch.float32,
                      device=points.device)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    xyz = torch.empty((b, npoint, 3), dtype=torch.float32,
                      device=points.device)
    for t in range(npoint):
        far = torch.argmax(dist, dim=1)
        sel = torch.where(t < count, given[:, t].long(), far)
        s = points[rows, sel]                           # [B, 3]
        idx[:, t] = sel.to(torch.int32)
        xyz[:, t] = s
        dx = px - s[:, 0:1]
        dy = py - s[:, 1:2]
        dz = pz - s[:, 2:3]
        d = dx * dx
        d = d + dy * dy
        d = d + dz * dz
        dist = torch.minimum(dist, d)
    return idx, xyz


def fps(points: torch.Tensor, given: torch.Tensor, count: torch.Tensor,
        npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded FPS: (idx [B, npoint] int32, xyz [B, npoint, 3]) with
    xyz[b, t] == points[b, idx[b, t]] bit for bit, through the op
    samplenet::fps: `fps_plain` on CPU tensors, the kernel on CUDA tensors
    (ops/dispatch.py); under `plain_on_cuda()` the plain version on the
    card. xyz is differentiable in points; a strided cloud is copied
    whole first, as the JAX package takes any array."""
    _check_args(points, given, count, npoint)
    if not points.is_contiguous():
        points = points.contiguous()
    if use_kernel(points):  # checked here too: tracing runs no CUDA impl
        _check_cuda(points, given, count)
    elif points.device.type == "cuda":             # under plain_on_cuda()
        return fps_plain(points, given, count, npoint)
    return fps_op(points, given, count, npoint)


@torch.library.custom_op("samplenet::fps", mutates_args=(),
                         device_types="cpu")
def fps_op(points: torch.Tensor, given: torch.Tensor, count: torch.Tensor,
           npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op a torch.export program carries; on the CPU the plain
    version."""
    return fps_plain(points, given, count, npoint)


@fps_op.register_fake
def _fps_fake(points, given, count, npoint):
    b = points.shape[0]
    return (points.new_empty((b, npoint), dtype=torch.int32),
            points.new_empty((b, npoint, 3)))


def _fps_setup(ctx, inputs, output):
    ctx.save_for_backward(output[0])
    ctx.n = inputs[0].shape[1]


def _fps_bwd(ctx, _g_idx, g_xyz):
    """xyz's gradient summed into points by a one-hot bmm (no float
    atomics), as the plain version's gather gives it."""
    from samplenet_tpu_torch.ops.chamfer import scatter_rows

    (idx,) = ctx.saved_tensors
    return scatter_rows(idx, g_xyz, ctx.n), None, None, None


fps_op.register_autograd(_fps_bwd, setup_context=_fps_setup)


@functools.lru_cache(maxsize=8)
def cluster_active(device: int) -> dict[tuple[int, int], int]:
    """{(C, R): clouds the card runs at once} of every cluster build, from
    the CUDA occupancy API on CUDA device `device`."""
    lib = library()
    builds = [(c, r) for c in fp.CLUSTER_SIZES for r in fp.CLUSTER_POINTS]
    builds.append((fp.STREAM_CLUSTER, 0))
    with torch.cuda.device(device):
        active = {cr: lib.snt_fps_cluster_active(*cr) for cr in builds}
    if min(active.values()) < 0:
        raise RuntimeError(f"fps_cluster: the occupancy query failed: "
                           f"{active}")
    return active


@functools.lru_cache(maxsize=256)
def kernel_plan(device: int, b: int, n: int, k: int) -> fp.FpsPlan:
    """The kernel's launch plan on CUDA device `device`; checks that the
    kernel counts shared memory and block widths as the plan does."""
    lib = library()
    widths = [(r, False) for r in fp.REG_POINTS] + [(fp.SHARED_POINTS, True)]
    if (lib.snt_fps_smem(n, k) != fp.fps_smem(n, k)
            or lib.snt_fps_shared_points() != fp.SHARED_POINTS
            or any(lib.snt_fps_max_threads(r, s) != fp.max_threads(r, s)
                   for r, s in widths)
            or [lib.snt_fps_cluster_limit(i) for i in range(5)]
            != [fp.CLUSTER_SIZES[-1], fp.CLUSTER_THREADS, fp.GIVEN_CHUNK,
                fp.CLUSTER_POINTS[-1], fp.STREAM_CLUSTER]
            or any(lib.snt_fps_cluster_smem(r) != fp.cluster_smem(r)
                   for r in (0, *fp.CLUSTER_POINTS))):
        raise RuntimeError("csrc/fps.cu and fps_plan.py disagree on shared "
                           "memory or block widths")
    props = torch.cuda.get_device_properties(device)
    return fp.plan_fps(b, n, k, sms=props.multi_processor_count,
                       smem_limit=max_dynamic_smem(torch.device("cuda",
                                                                device)),
                       active=lambda c, r: cluster_active(device)[c, r])


def _check_cuda(points, given, count) -> None:
    if points.device.type != "cuda":
        raise ValueError(f"the fps kernel takes CUDA tensors, got "
                         f"{points.device}")
    if not (points.is_contiguous() and given.is_contiguous()
            and count.is_contiguous()):
        raise ValueError("the fps kernel takes contiguous tensors")


@fps_op.register_kernel("cuda")
def _fps_cuda(points, given, count, npoint):
    _check_cuda(points, given, count)
    b, n, _ = points.shape
    plan = kernel_plan(points.device.index, b, n, npoint)
    return launch(points, given, count, npoint, plan)


def launch(points, given, count, npoint: int, plan: fp.FpsPlan):
    """The kernel on checked arguments under `plan`; the outputs do not
    depend on the plan (the card tests run others)."""
    b, n, _ = points.shape
    idx = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    xyz = torch.empty((b, npoint, 3), dtype=torch.float32,
                      device=points.device)
    lib = library()
    if plan.cluster:
        # the streamed running distances: the kernel's workspace
        dist = (torch.empty((b, n), dtype=torch.float32, device=points.device)
                if plan.stream else None)
        with torch.cuda.device(points.device):
            err = lib.snt_fps_cluster(
                points.data_ptr(), given.data_ptr(), count.data_ptr(),
                idx.data_ptr(), xyz.data_ptr(),
                None if dist is None else dist.data_ptr(), b, n, npoint,
                plan.cluster, plan.points, stream_handle(points))
        check(err, KERNEL_CLUSTER)
        count_launch(KERNEL_CLUSTER)
        return idx, xyz
    with torch.cuda.device(points.device):
        err = lib.snt_fps(points.data_ptr(), given.data_ptr(),
                          count.data_ptr(), idx.data_ptr(), xyz.data_ptr(),
                          b, n, npoint, plan.warps, plan.points,
                          int(plan.shared), stream_handle(points))
    check(err, KERNEL)
    count_launch(KERNEL)
    return idx, xyz
