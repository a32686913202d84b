"""Approximate EMD transport cost with its analytic gradients: the CUDA
kernel's wrapper, its plain PyTorch version and the autograd Function
that joins them.

Mirrors samplenet_tpu/ops/pallas/emd_kernel.py::emd_cost_pallas (:269,
body `_emd_kernel` :52-183) and the custom VJP around it in
samplenet_tpu/ops/matching.py:134-153 (`_emd_cost_fused`): the 11-level
auction match of the reference ApproxMatch, reduced at once into the cost
sum match * d and into the closed-form MatchCostGrad (the match held
fixed), so the [B, n, m] match is never kept. The kernel is csrc/emd.cu;
its note says how the column sums of a level cross blocks and how it
skips the pairs whose weights underflow. Every CUDA call runs it on both
clouds sorted by Morton code (`in_morton_order`), the gradients put back
in the callers' order.

Both versions compute d2 as ((dx*dx + dy*dy) + dz*dz) in broadcast-
difference form, as the TPU kernel does (emd_kernel.py:106-109), not by
the |x|^2 + |y|^2 - 2xy identity: at |level| = 65536 the exp multiplies
d2's error by 65536. The column update is satr - colsum * ratio, as in
the TPU kernel (:129-133). The sums run in other orders in the two
versions, and the kernel takes d and 1/d from one rsqrt (2 ulp) where the
plain version takes an IEEE sqrt and divide; d enters only the cost and
the gradients, not the match. So the two agree to f32 round-off amplified
by the steep levels. The kernel takes f32; the plain version also takes
f64, the reference the on-card checks hold both against.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "emd"
# -4^j for j = 8..-1, then 0 (emd_kernel.py:49; tf_approxmatch.cpp:29-33)
LEVELS = tuple(-(4.0 ** j) for j in range(8, -2, -1)) + (0.0,)
MAX_CLOUDS = 65535   # clouds a launch: the grid's y axis (csrc/emd.cu)
# csrc/emd.cu's block: kWarps warps, kRows rows of xyz1 of kRowVals values
# each, the reduction rows kRed = 6 row sums x kGroup rows + 1
_WARPS, _ROWS, _ROW_VALS, _RED = 8, 64, 8, 6 * 8 + 1


def emd_smem(m: int) -> int:
    """Shared memory of an EMD block for m columns, as csrc/emd.cu counts
    it (snt_emd_smem): 11 floats a column, the warps' and the block's
    reduction rows, the block's rows, and 7 floats a 32-column chunk. The
    whole of xyz2's state stays in one block, which caps m."""
    return 4 * (11 * m + _WARPS * _RED + _RED + _ROW_VALS * _ROWS
                + 7 * -(-m // 32))


def max_columns(limit: int) -> int:
    """The most columns m (points of xyz2) a block of `limit` bytes takes."""
    m = (limit // 4 - _WARPS * _RED - _RED - _ROW_VALS * _ROWS) * 32 // 359
    while emd_smem(m + 1) <= limit:
        m += 1
    while m > 0 and emd_smem(m) > limit:
        m -= 1
    return m


def cloud_chunks(b: int) -> list[tuple[int, int]]:
    """[start, stop) of the clouds of each launch: at most MAX_CLOUDS a
    launch, in order. Each cloud is independent, so the bits do not depend
    on the chunks."""
    return [(c0, min(c0 + MAX_CLOUDS, b)) for c0 in range(0, b, MAX_CLOUDS)]


def saturations(n: int, m: int) -> tuple[float, float]:
    """(factorl, factorr): the integer quotients max(n,m)//n and
    max(n,m)//m that the rows and the columns start with."""
    big = max(n, m)
    return float(big // n), float(big // m)


def _check_args(xyz1: torch.Tensor, xyz2: torch.Tensor) -> None:
    if xyz1.dim() != 3 or xyz2.dim() != 3 or xyz1.shape[-1] != 3 \
            or xyz2.shape[-1] != 3 or xyz1.shape[0] != xyz2.shape[0]:
        raise ValueError(f"emd_cost takes xyz1 [B, n, 3] and xyz2 [B, m, 3], "
                         f"got {tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    if xyz1.shape[0] == 0 or xyz1.shape[1] == 0 or xyz2.shape[1] == 0:
        raise ValueError("emd_cost needs B, n, m >= 1")
    if xyz1.dtype != xyz2.dtype or xyz1.dtype not in (torch.float32,
                                                      torch.float64):
        raise TypeError(f"emd_cost takes float32 (or float64 on the plain "
                        f"path), got {xyz1.dtype}, {xyz2.dtype}")
    if xyz1.device != xyz2.device:
        raise ValueError(f"xyz1 on {xyz1.device} but xyz2 on {xyz2.device}")


def sqdist_broadcast(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """[B, n, 3] x [B, m, 3] -> [B, n, m], ((dx*dx + dy*dy) + dz*dz)."""
    dx = xyz1[:, :, None, 0] - xyz2[:, None, :, 0]
    dy = xyz1[:, :, None, 1] - xyz2[:, None, :, 1]
    dz = xyz1[:, :, None, 2] - xyz2[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


# ------------------------------------------------------------ plain version

def emd_cost_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                   with_grads: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cost [B], g1 [B, n, 3], g2 [B, m, 3]); g1 and g2 are zeros
    without `with_grads`. The TPU kernel's passes on [B, n, m] tensors."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    factorl, factorr = saturations(n, m)
    d2 = sqdist_broadcast(xyz1, xyz2)
    d = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=1e-20)
    satl = torch.full((b, n), factorl, dtype=d2.dtype, device=d2.device)
    satr = torch.full((b, m), factorr, dtype=d2.dtype, device=d2.device)
    cost = torch.zeros((b,), dtype=d2.dtype, device=d2.device)
    g1, g2 = torch.zeros_like(xyz1), torch.zeros_like(xyz2)

    def weights(level, satr, satl):
        w = torch.exp(level * d2) * satr[:, None, :]
        rowsum = 1e-9 + w.sum(2)
        return w * (satl / rowsum)[:, :, None]

    colsum = weights(LEVELS[0], satr, satl).sum(1)
    for li, level in enumerate(LEVELS):
        ratio = torch.clamp(satr / (1e-9 + colsum), max=1.0)
        satr_next = torch.clamp(satr - colsum * ratio, min=0.0)
        wr = weights(level, satr, satl) * ratio[:, None, :]
        satl = torch.clamp(satl - wr.sum(2), min=0.0)
        cost = cost + (wr * d).sum((1, 2))
        if with_grads:
            u = wr / d
            with full_f32_matmul():
                g1 = g1 + xyz1 * u.sum(2)[..., None] - torch.bmm(u, xyz2)
                g2 = g2 + xyz2 * u.sum(1)[..., None] \
                    - torch.bmm(u.transpose(1, 2), xyz1)
        if li + 1 < len(LEVELS):
            colsum = weights(LEVELS[li + 1], satr_next, satl).sum(1)
        satr = satr_next
    return cost, g1, g2


# ------------------------------------------------------ the clouds' order

MORTON_BITS = 10   # per axis: 1024 cells along the cloud's longest side


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of each int64 of v moved to every third bit."""
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


_spread_tables: dict[torch.device, torch.Tensor] = {}


def _spread_table(device: torch.device) -> torch.Tensor:
    """_spread_bits of 0 .. 2^MORTON_BITS - 1 on `device`, as int32, made at
    first use (one gather then spreads all three axes)."""
    table = _spread_tables.get(device)
    if table is None:
        table = _spread_bits(torch.arange(1 << MORTON_BITS, device=device))
        table = _spread_tables[device] = table.to(torch.int32)
    return table


def morton_codes(xyz: torch.Tensor) -> torch.Tensor:
    """[B, n, 3] -> [B, n] int32: the Z-order code of each point's cell on
    a grid of 2^MORTON_BITS cells a side over the cloud's bounding cube
    (non-finite coordinates count as 0; they only move a point in the
    order)."""
    x = torch.nan_to_num(xyz.detach(), nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = torch.aminmax(x, dim=1, keepdim=True)
    side = (hi - lo).amax(dim=2, keepdim=True).clamp_min_(1e-30)
    cells = (1 << MORTON_BITS) - 1
    q = (x - lo).mul_(cells / side).clamp_(0, cells).to(torch.int64)
    spread = _spread_table(x.device)[q]
    return spread[..., 0] * 4 + spread[..., 1] * 2 + spread[..., 2]


def morton_order(xyz: torch.Tensor) -> torch.Tensor:
    """[B, n] int64: each cloud's points sorted by Morton code, ties in
    index order (a stable sort)."""
    return torch.sort(morton_codes(xyz), dim=1, stable=True).indices


def take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x[b, order[b, i]] for [B, n, 3] x."""
    return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[2]))


def put_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The inverse of take_rows: y with y[b, order[b, i]] = x[b, i]."""
    return torch.empty_like(x).scatter_(
        1, order[..., None].expand(-1, -1, x.shape[2]), x)


def in_morton_order(fn, xyz1: torch.Tensor, xyz2: torch.Tensor,
                    with_grads: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fn(xyz1, xyz2, with_grads) run on both clouds in Morton order, its
    gradients put back in the callers' order. The order makes a warp's 8
    rows and 32 columns neighbours in space, so at the steep levels whole
    warp units underflow and the kernel skips them; the transport cost and
    the gradients are the same function of the clouds in any order, up to
    f32 summation order. Clouds of one shape are ordered as one batch."""
    if xyz1.shape == xyz2.shape:    # both clouds in one batch: half the ops
        b = xyz1.shape[0]
        both = torch.cat([xyz1, xyz2])
        order = morton_order(both)
        taken = take_rows(both, order)
        o1, o2 = order[:b], order[b:]
        cost, g1, g2 = fn(taken[:b], taken[b:], with_grads)
    else:
        o1, o2 = morton_order(xyz1), morton_order(xyz2)
        cost, g1, g2 = fn(take_rows(xyz1, o1), take_rows(xyz2, o2), with_grads)
    if not with_grads:          # zeros in any order
        return cost, g1, g2
    return cost, put_rows(g1, o1), put_rows(g2, o2)


# --------------------------------------------------------------- CUDA kernel

def emd_cost_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor,
                  with_grads: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on both clouds in Morton order (`in_morton_order`)."""
    if xyz1.device.type != "cuda":
        raise ValueError(f"the emd kernel takes CUDA tensors, got "
                         f"{xyz1.device}")
    if xyz1.dtype != torch.float32:
        raise TypeError(f"the emd kernel takes float32, got {xyz1.dtype}")
    if not (xyz1.is_contiguous() and xyz2.is_contiguous()):
        raise ValueError("the emd kernel takes contiguous xyz1 and xyz2")
    m = xyz2.shape[1]
    smem, limit = emd_smem(m), max_dynamic_smem(xyz1.device)
    if (library().snt_emd_smem(m) != smem
            or library().snt_emd_max_clouds() != MAX_CLOUDS):
        raise RuntimeError("emd_kernel.py and csrc/emd.cu count shared "
                           "memory or clouds a launch apart")
    if smem > limit:
        raise ValueError(f"m={m} needs {smem} bytes of shared memory per "
                         f"block, more than the card offers ({limit}: at "
                         f"most m={max_columns(limit)})")
    return in_morton_order(_launch, xyz1, xyz2, with_grads)


def _launch(xyz1: torch.Tensor, xyz2: torch.Tensor, with_grads: bool
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on the clouds in the order they are given, one launch a
    chunk of at most MAX_CLOUDS clouds (`cloud_chunks`)."""
    chunks = cloud_chunks(xyz1.shape[0])
    if len(chunks) == 1:
        return _launch_clouds(xyz1, xyz2, with_grads)
    parts = [_launch_clouds(xyz1[c0:c1], xyz2[c0:c1], with_grads)
             for c0, c1 in chunks]
    return tuple(torch.cat(t) for t in zip(*parts))


def _launch_clouds(xyz1: torch.Tensor, xyz2: torch.Tensor, with_grads: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch on at most MAX_CLOUDS clouds."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    lib = library()
    tiles = -(-n // lib.snt_emd_rows_per_block())
    factorl, factorr = saturations(n, m)
    f32 = dict(dtype=torch.float32, device=xyz1.device)
    satl = torch.full((b, n), factorl, **f32)
    satr_a = torch.full((b, m), factorr, **f32)
    satr_b, ratio = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
    rowsum = torch.empty((b, n), **f32)
    colsum_part = torch.empty((b, tiles, m), **f32)
    g2_part = torch.zeros((b, tiles, 3, m) if with_grads else (1,), **f32)
    cost_part = torch.zeros((b, tiles), **f32)
    g1 = torch.zeros((b, n, 3), **f32)
    g2 = torch.empty((b, m, 3), **f32)
    cost = torch.empty((b,), **f32)
    with torch.cuda.device(xyz1.device):
        err = lib.snt_emd_cost(
            xyz1.data_ptr(), xyz2.data_ptr(), b, n, m, int(with_grads),
            satl.data_ptr(), rowsum.data_ptr(), satr_a.data_ptr(),
            satr_b.data_ptr(), ratio.data_ptr(), colsum_part.data_ptr(),
            g2_part.data_ptr(), cost_part.data_ptr(), g1.data_ptr(),
            cost.data_ptr(), g2.data_ptr(), stream_handle(xyz1))
    check(err, KERNEL)
    count_launch(KERNEL)
    return cost, g1, g2


def expf_underflow_violations(device: torch.device) -> tuple[float, int]:
    """(kUnderflow, count): the constant below which the kernel skips a
    warp's pairs as adding exact zeros, and how many f32 x from it down to
    -inf get an expf(x), called as the kernel calls it, other than +0 on
    `device` (one launch over about 1e9 values)."""
    lib = library()
    bad = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        check(lib.snt_emd_underflow_check(bad.data_ptr(),
                                          stream_handle(bad)), KERNEL)
    return float(lib.snt_emd_underflow()), int(bad.item())


def emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, *,
             with_grads: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cost [B], g1 [B, n, 3], g2 [B, m, 3]): the approximate-EMD
    transport cost and d cost / d xyz1, d cost / d xyz2 with the match held
    fixed (zeros without `with_grads`). CPU tensors take `emd_cost_plain`,
    CUDA tensors the kernel (ops/dispatch.py)."""
    _check_args(xyz1, xyz2)
    if not use_kernel(xyz1):
        return emd_cost_plain(xyz1, xyz2, with_grads)
    return emd_cost_cuda(xyz1.contiguous(), xyz2.contiguous(), with_grads)


# ------------------------------------------------------------ the Function

class _EmdCost(torch.autograd.Function):
    """The cost, differentiable in both clouds: the forward keeps the
    analytic gradients and the backward scales them by the cotangent
    (matching.py:141-150)."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, with_grads):
        cost, g1, g2 = emd_cost(xyz1, xyz2, with_grads=with_grads)
        ctx.save_for_backward(g1, g2)
        return cost

    @staticmethod
    def backward(ctx, ct):
        g1, g2 = ctx.saved_tensors
        return ct[:, None, None] * g1, ct[:, None, None] * g2, None


def emd_cost_autograd(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """[B] transport cost whose gradient is the kernel's analytic one; the
    gradients are only accumulated where autograd will ask for them."""
    _check_args(xyz1, xyz2)
    with_grads = torch.is_grad_enabled() and (xyz1.requires_grad
                                              or xyz2.requires_grad)
    return _EmdCost.apply(xyz1, xyz2, with_grads)
