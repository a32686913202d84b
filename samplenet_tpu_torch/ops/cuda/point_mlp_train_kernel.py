"""Train-mode per-point MLP chain with ghost BatchNorm + global max, forward
and backward: the CUDA kernels' wrappers, their plain PyTorch versions and
the autograd Function that joins them.

Mirrors samplenet_tpu/ops/pallas/point_mlp_train_kernel.py:57-432
(`auto_block_b`, `point_mlp_train_max`), the chain behind `--fused-train`.
It takes x [B, N, C_in] and per layer the Dense kernel W [C_in, C_out],
its bias, and BN's gamma and beta, and returns (pooled [B, C_out], means,
vars). Normalisation uses ghost statistics: the clouds fall into blocks of
`block_b` (block p holds clouds p*block_b .. p*block_b + block_b - 1) and
each layer normalises each block with the block's own mean and biased
variance E[z^2] - E[z]^2, not clamped (:81-85). means and vars are the
exact global statistics that the EMA takes, from the per-block rows
(`_stats_from_rows`, :336-349): the mean over blocks plus the dense bias,
and E[z^2] - E[z]^2 of the block averages, again not clamped. The dense
bias never enters z, so its gradient is exactly zero (:391).

With `bf16` each matmul rounds both operands to bf16 and sums in f32, as
`jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)`,
and the backward stores xhat in bf16. The backward is the TPU kernel's
own VJP (:120-196), not the gradient of the forward: the ReLU mask comes
from gamma * xhat_stored + beta, h_prev is rebuilt from the layer below's
stored xhat, rstd from z recomputed on that h_prev, and the max-pool
cotangent goes to the f32 chain's first argmax. With bf16 off these are
the forward's own values.

`auto_block_b` is the TPU's VMEM-budget formula, copied as it is: the block
size sets the statistics, so it is part of the result, not a tiling
choice. The kernels are csrc/point_mlp_train.cu, which also run the exact
chain (point_mlp_exact_kernel.py) as one block: this module holds the
helpers both wrappers share and the backward driver both call
(`bwd_cuda`, launched by the plan of point_mlp_plan.py). The plain
versions follow the TPU kernel's lines (the backward recomputes the chain
from x) and also take float64, which the on-card checks use, with bf16
off, as the reference both paths are held against.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any

import torch
import torch.nn.functional as F

from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import (
    full_f32_matmul,
    round_op,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_plan import (
    DensePlan,
    LayerPlan,
    plan_bwd,
    plan_dense,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL_FWD = "point_mlp_train_fwd"
KERNEL_BWD = "point_mlp_train_bwd"
_TILE = 64                          # csrc/point_mlp_train.cu kTileP
_VMEM_BUDGET = 10 * 1024 * 1024     # the TPU kernel's (:54)


def auto_block_b(batch: int, n: int, widths: tuple[int, ...],
                 bf16: bool = True) -> int | None:
    """Largest power-of-two batch block that (a) divides `batch` (ghost
    stats must not mix padding into a block) and (b) fits the TPU backward
    kernel's VMEM plan: per-layer x_hat stores + 3 live [C_max, bb*N] f32
    temporaries. None when no block fits (the exact chain runs instead).
    point_mlp_train_kernel.py:57-73, unchanged."""
    store_bytes = sum(widths) * (2 if bf16 else 4)
    temp_bytes = 3 * max(widths) * 4
    per_lane = n * (store_bytes + temp_bytes)
    bb_max = _VMEM_BUDGET // max(per_lane, 1)
    bb = 1
    while bb * 2 <= min(bb_max, 64) and batch % (bb * 2) == 0:
        bb *= 2
    if bb > bb_max or batch % bb:
        return None
    return bb


def check_args(x, weights, biases, gammas, betas) -> list[int]:
    if x.dim() != 3 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"point_mlp_exact takes x [B>=1, N>=1, C], got "
                         f"{tuple(x.shape)}")
    n = len(weights)
    if n < 1 or not len(biases) == len(gammas) == len(betas) == n:
        raise ValueError("point_mlp_exact takes one weight, bias, gamma and "
                         "beta per layer")
    widths = [x.shape[-1]]
    for w, *vs in zip(weights, biases, gammas, betas):
        if w.dim() != 2 or w.shape[0] != widths[-1] \
                or any(tuple(v.shape) != (w.shape[1],) for v in vs):
            raise ValueError(f"layer {len(widths) - 1}: shapes do not follow "
                             f"width {widths[-1]}")
        widths.append(w.shape[1])
    for t in (x, *weights, *biases, *gammas, *betas):
        if t.dtype != x.dtype or t.dtype not in (torch.float32,
                                                 torch.float64):
            raise TypeError(f"point_mlp_exact takes float32 (or float64 on "
                            f"the plain path), got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and the parameters must share a device")
    return widths


def _ghost_stats(z: torch.Tensor, eps: float, blocks=None):
    """(mu, msq, rstd) per block of z [P, M, C], each [P, 1, C]; under
    `blocks`, per block of the global batch."""
    mu = z.mean(1, keepdim=True)
    msq = (z * z).mean(1, keepdim=True)
    if blocks is not None:
        mu, msq = blocks.means(torch.cat([mu, msq], 1)).split(1, 1)
    return mu, msq, torch.rsqrt(msq - mu * mu + eps)


# ------------------------------------------------------------ plain version

def point_mlp_train_fwd_plain(x, weights, gammas, betas, eps, block_b, bf16,
                              blocks=None):
    """(pooled [B, C_out], block means [P, C] and block E[z^2] [P, C] per
    layer): the forward kernel's lines (:102-117). Under `blocks`, block_b
    is its sub-block and the statistics are its blocks'."""
    b, n, c0 = x.shape
    h = x.reshape(b // block_b, block_b * n, c0)
    mus, msqs = [], []
    with full_f32_matmul():
        for w, gamma, beta in zip(weights, gammas, betas):
            z = torch.matmul(round_op(h, bf16), round_op(w, bf16))
            mu, msq, rstd = _ghost_stats(z, eps, blocks)
            h = torch.relu(gamma * ((z - mu) * rstd) + beta)
            mus.append(mu[:, 0])
            msqs.append(msq[:, 0])
    return h.reshape(b, n, -1).amax(dim=1), mus, msqs


def _stored_chain(x, weights, gammas, betas, eps, block_b, bf16,
                  blocks=None):
    """(xhat per layer as the backward stores it, [P, M, C], and the f32
    chain's first argmax [B, C_out]): the backward kernel's recompute of
    the chain from x (:130-148)."""
    b, n, c0 = x.shape
    h = x.reshape(b // block_b, block_b * n, c0)
    xhats = []
    with full_f32_matmul():
        for w, gamma, beta in zip(weights, gammas, betas):
            z = torch.matmul(round_op(h, bf16), round_op(w, bf16))
            mu, _, rstd = _ghost_stats(z, eps, blocks)
            xhat = (z - mu) * rstd
            h = torch.relu(gamma * xhat + beta)
            xhats.append(round_op(xhat, bf16))
    return xhats, torch.argmax(h.reshape(b, n, -1), dim=1)


def point_mlp_train_vjp_plain(x, weights, gammas, betas, eps, block_b, bf16,
                              xhats, argmax, g, blocks=None):
    """(dx, dWs, dgammas, dbetas) for the pooled cotangent g [B, C_out],
    from the stored xhats [P, M, C] and the argmax [B, C_out] of a forward:
    the backward kernel's lines (:150-196). Under `blocks` the means over
    a block are its block's in the global batch; dgammas and dbetas stay
    this rank's sums."""
    b, n, c0 = x.shape
    p = b // block_b
    h0 = x.reshape(p, block_b * n, c0)
    nl = len(weights)
    dws, dgammas, dbetas = [None] * nl, [None] * nl, [None] * nl
    top = xhats[-1]
    dh = torch.zeros((b, n, top.shape[-1]), dtype=top.dtype,
                     device=top.device)
    dh = dh.scatter_(1, argmax[:, None, :], g[:, None, :].to(top.dtype))
    dh = dh.reshape(p, block_b * n, -1)
    with full_f32_matmul():
        for i in range(nl - 1, -1, -1):
            xh = xhats[i]
            y = gammas[i] * xh + betas[i]
            dy = torch.where(y > 0, dh, torch.zeros_like(dh))
            dgammas[i] = (dy * xh).sum(1).sum(0)
            dbetas[i] = dy.sum(1).sum(0)
            dxhat = dy * gammas[i]
            m1 = dxhat.mean(1, keepdim=True)
            m2 = (dxhat * xh).mean(1, keepdim=True)
            if blocks is not None:
                m1, m2 = blocks.means(torch.cat([m1, m2], 1)).split(1, 1)
            dz = dxhat - m1 - xh * m2
            h_prev = h0 if i == 0 else torch.relu(
                gammas[i - 1] * xhats[i - 1] + betas[i - 1])
            z = torch.matmul(round_op(h_prev, bf16),
                             round_op(weights[i], bf16))
            _, _, rstd = _ghost_stats(z, eps, blocks)
            dz = round_op(rstd * dz, bf16)
            dws[i] = torch.matmul(round_op(h_prev, bf16).transpose(1, 2),
                                  dz).sum(0)
            dh = torch.matmul(dz, round_op(weights[i], bf16).t())
    return dh.reshape(b, n, c0), dws, dgammas, dbetas


def point_mlp_train_bwd_plain(x, weights, gammas, betas, eps, block_b, bf16,
                              g, blocks=None):
    """(dx, dWs, dgammas, dbetas) for the pooled cotangent g [B, C_out]:
    the backward kernel's lines (:130-196), the chain recomputed from x."""
    xhats, argmax = _stored_chain(x, weights, gammas, betas, eps, block_b,
                                  bf16, blocks)
    return point_mlp_train_vjp_plain(x, weights, gammas, betas, eps, block_b,
                                     bf16, xhats, argmax, g, blocks)


def stats_from_rows(mus, msqs, blocks=None):
    """Per layer the exact global (mean, var) of z from the per-block rows
    [P, C] (:336-349, before the dense bias): block rows are averages over
    equal blocks, so the global mean is their mean, and the variance is
    E[z^2] - E[z]^2, not clamped. Under `blocks` the mean is over the rows
    of every rank."""
    if blocks is not None:
        rows = blocks.global_means([*mus, *msqs])
        means = rows[:len(mus)]
        return means, [msq - mu * mu for mu, msq in zip(means,
                                                         rows[len(mus):])]
    means, vars_ = [], []
    for mu_b, msq_b in zip(mus, msqs):
        mu, msq = mu_b.mean(0), msq_b.mean(0)
        means.append(mu)
        vars_.append(msq - mu * mu)
    return means, vars_


# -------------------------------------------------------------- CUDA kernels

def launch_grid(work: int, device, per_sm: int, n_blocks: int = 1) -> int:
    """Blocks per batch block for a pass over its `work` tiles that keeps
    its partial sums in shared memory: about `per_sm` per SM over all
    `n_blocks` batch blocks (what fits at the train widths), a number fixed
    by the shape and the card, so the partial sums (and their order)
    repeat from run to run."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(work, -(-per_sm * sms // n_blocks)))


_MAX_ROW_BLOCKS = 65535


def _rows_grid(work: int) -> int:
    """Blocks for the BN-rows pass: one per tile or cloud (each block
    strides over the rest beyond the cap); the partials are f64 rows."""
    return max(1, min(work, _MAX_ROW_BLOCKS))


def ptrs(*tensors) -> ctypes.Array:
    """The C array of the tensors' device pointers (a BN's mu, rstd, gamma,
    beta) that the kernels take."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check_cuda(x, widths, name: str, block_b: int | None = None
               ) -> tuple[list[LayerPlan], list[DensePlan]]:
    """Checks what the kernels take, for ghost blocks of `block_b` clouds
    (all B: the exact chain); returns each layer's backward plan and
    pmt_dense plan."""
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the {name} kernels take float32, got {x.dtype}")
    if any(c % 4 for c in widths[1:]):
        raise ValueError(f"the {name} kernels take output widths divisible "
                         f"by 4, got {widths}")
    b, n, _ = x.shape
    bb = b if block_b is None else block_b
    lib = library()
    limit = max_dynamic_smem(x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    pairs = list(zip(widths[:-1], widths[1:]))
    dense = [plan_dense(ci, co, limit) for ci, co in pairs]
    plans = plan_bwd(widths, b // bb, bb * n, sms, limit)
    if None in dense or plans is None:
        raise ValueError(f"widths {widths} need more shared memory per block "
                         f"than the card offers")
    for pl, dp in zip(plans, dense):  # the planner counts what they count
        if (lib.snt_pmt_bwd_dz_smem(pl.cin_pad, pl.cout, pl.dz_kc,
                                    int(pl.dz_stage)) != pl.dz_smem
                or lib.snt_pmt_bwd_dw_smem(pl.dw_ri) != pl.dw_smem
                or lib.snt_pmt_dense_smem(dp.cin, dp.cout,
                                          int(dp.stage)) != dp.smem):
            raise RuntimeError("point_mlp_plan.py and csrc/point_mlp_train.cu "
                               "count shared memory apart")
    return plans, dense


def _block_stats(rows: torch.Tensor, m: int, eps: float,
                 blocks=None):
    """(mu, rstd) as f32 [P, C], and the f64 (mu, msq), from the f64 sums
    rows [P, G, 2, C] over m points per block (under `blocks`, per
    sub-block, m the block's count)."""
    s = rows.sum(1)
    if blocks is not None:
        s = blocks.sums(s)
    mu64, msq64 = s[:, 0] / m, s[:, 1] / m
    var = (msq64 - mu64 * mu64).float()
    return mu64.float(), torch.rsqrt(var + eps), mu64, msq64


def point_mlp_train_fwd_cuda(x, weights, gammas, betas, eps, block_b, bf16,
                             blocks=None):
    """(pooled, block means, block E[z^2] (f64), saved): saved feeds the
    backward kernels. Under `blocks`, block_b is its sub-block and the
    statistics are its blocks'."""
    widths = [x.shape[-1], *(w.shape[1] for w in weights)]
    dense = check_cuda(x, widths, "point_mlp_train", block_b)[1]
    b, n, _ = x.shape
    p, m = b // block_b, block_b * n
    m_stat = m * (1 if blocks is None else blocks.group)
    lib = library()
    grid = launch_grid(-(-m // _TILE), x.device, per_sm=4, n_blocks=p)
    stream = stream_handle(x)
    gammas = [t.contiguous() for t in gammas]
    betas = [t.contiguous() for t in betas]
    h_in, prev = x.contiguous(), None
    zs, mus, rstds, mus64, msqs64 = [], [], [], [], []
    with torch.cuda.device(x.device):
        for w, gamma, beta, dp in zip(weights, gammas, betas, dense):
            cin, cout = w.shape
            z = torch.empty((b * n, cout), dtype=torch.float32, device=x.device)
            rows = torch.empty((p, grid, 2, cout), dtype=torch.float64,
                               device=x.device)
            w_op = round_op(w, bf16).contiguous()
            err = lib.snt_pmt_dense(
                h_in.data_ptr(), cin, prev, 0, int(bf16), w_op.data_ptr(),
                cout, z.data_ptr(), rows.data_ptr(), p, block_b, n,
                int(dp.stage), grid, stream)
            check(err, KERNEL_FWD)
            mu, rstd, mu64, msq64 = _block_stats(rows, m_stat, eps, blocks)
            prev = ptrs(mu, rstd, gamma, beta)
            zs.append(z)
            mus.append(mu)
            rstds.append(rstd)
            mus64.append(mu64)
            msqs64.append(msq64)
            h_in = z
        pooled = torch.empty((b, widths[-1]), dtype=torch.float32,
                             device=x.device)
        argmax = torch.empty((b, widths[-1]), dtype=torch.int32,
                             device=x.device)
        err = lib.snt_pmt_pool(zs[-1].data_ptr(), prev, b, block_b, n,
                               widths[-1], pooled.data_ptr(),
                               argmax.data_ptr(), stream)
    check(err, KERNEL_FWD)
    count_launch(KERNEL_FWD)
    return pooled, mus64, msqs64, (zs, mus, rstds, argmax)


# the backward's rounding modes (csrc/point_mlp_train.cu `Rounds`)
MODE_F32, MODE_GHOST_BF16, MODE_EXACT_BF16 = 0, 1, 2


def bwd_cuda(x, weights, gammas, betas, eps, block_b, mode, saved, g,
             kernel: str, blocks=None):
    """(dx, dWs, dgammas, dbetas): the backward kernels of both chains
    (the exact chain is one block of all B clouds), from a forward's saved
    (zs, mus, rstds, argmax), with the roundings of `mode`: MODE_F32,
    MODE_GHOST_BF16 (operands and the stored xhat in bf16, rstd recomputed
    from the rounded h_prev) or MODE_EXACT_BF16 (operands in bf16, dh read
    back in bf16 by pmt_bwd_dz); `kernel` names the caller in errors. Per
    layer, from the top: pmt_rows (the BN rows), pmt_bwd_dz (dz and
    dh_prev) and pmt_bwd_dw (dW's f64 partials, summed here). Under
    `blocks` (block_b its sub-block) the rows that feed dz are summed over
    each block of the global batch between pmt_rows and pmt_bwd_dz; the
    dgammas and dbetas returned stay this rank's sums."""
    zs, mus, rstds, argmax = saved
    widths = [x.shape[-1], *(w.shape[1] for w in weights)]
    plans, dense = check_cuda(x, widths, kernel, block_b)
    b, n, c0 = x.shape
    p, m = b // block_b, block_b * n
    m_stat = m * (1 if blocks is None else blocks.group)
    tiles = -(-m // _TILE)
    lib = library()
    stream = stream_handle(x)
    g = g.contiguous()
    gammas = [t.contiguous() for t in gammas]
    betas = [t.contiguous() for t in betas]
    bns = [ptrs(mus[i], rstds[i], gammas[i], betas[i]) for i in range(len(zs))]
    nl = len(weights)
    dws, dgammas, dbetas = [None] * nl, [None] * nl, [None] * nl
    dh = None                      # the top layer reads g at argmax
    store = int(mode == MODE_GHOST_BF16)   # the stored xhat is rounded
    with torch.cuda.device(x.device):
        for i in range(nl - 1, -1, -1):
            cin, cout, plan = widths[i], widths[i + 1], plans[i]
            w_op = round_op(weights[i], mode != MODE_F32).contiguous()
            rstd2 = rstds[i]
            if store and i > 0:
                # rstd from z recomputed on h_prev rebuilt from the stored
                # (bf16) xhat of the layer below (:173-184); with bf16 off
                # that z is the forward's, bit for bit
                grid = launch_grid(tiles, x.device, per_sm=4, n_blocks=p)
                rows = torch.empty((p, grid, 2, cout), dtype=torch.float64,
                                   device=x.device)
                err = lib.snt_pmt_dense(
                    zs[i - 1].data_ptr(), cin, bns[i - 1], 1, 1,
                    w_op.data_ptr(), cout, None, rows.data_ptr(), p, block_b,
                    n, int(dense[i].stage), grid, stream)
                check(err, kernel)
                rstd2 = _block_stats(rows, m_stat, eps, blocks)[1] \
                    .contiguous()
            grid = _rows_grid(block_b if dh is None else tiles)
            rows = torch.empty((p, grid, 2, cout), dtype=torch.float64,
                               device=x.device)
            err = lib.snt_pmt_rows(
                zs[i].data_ptr(), bns[i], cout, store,
                None if dh is None else dh.data_ptr(), g.data_ptr(),
                argmax.data_ptr(), p, block_b, n, rows.data_ptr(), grid,
                stream)
            check(err, kernel)
            s = rows.sum(1)                               # [P, 2, C] f64
            dbetas[i], dgammas[i] = s[:, 0].sum(0).float(), \
                s[:, 1].sum(0).float()
            if blocks is not None:
                s = blocks.sums(s)
            gamma64 = gammas[i].double()
            r1 = (gamma64 * s[:, 0] / m_stat).float().contiguous()
            r2 = (gamma64 * s[:, 1] / m_stat).float().contiguous()
            wt = F.pad(w_op.t(), (0, plan.cin_pad - cin)).contiguous()
            dz = torch.empty((b * n, cout), dtype=torch.float32,
                             device=x.device)
            dh_prev = torch.empty((b * n, plan.cin_pad), dtype=torch.float32,
                                  device=x.device)
            err = lib.snt_pmt_bwd_dz(
                zs[i].data_ptr(), bns[i], rstd2.data_ptr(), r1.data_ptr(),
                r2.data_ptr(), cout, mode,
                None if dh is None else dh.data_ptr(), g.data_ptr(),
                argmax.data_ptr(), wt.data_ptr(), plan.cin_pad,
                dz.data_ptr(), dh_prev.data_ptr(), p, block_b, n, plan.dz_rp,
                plan.dz_kc, int(plan.dz_stage), plan.dz_grid, stream)
            check(err, kernel)
            dw_part = torch.empty((plan.dw_splits, plan.cin_pad, cout),
                                  dtype=torch.float64, device=x.device)
            h_in = x.contiguous() if i == 0 else zs[i - 1]
            err = lib.snt_pmt_bwd_dw(
                h_in.data_ptr(), cin, plan.cin_pad,
                None if i == 0 else bns[i - 1], mode, dz.data_ptr(),
                cout, dw_part.data_ptr(), p, block_b, n, plan.dw_splits,
                plan.dw_ri, stream)
            check(err, kernel)
            dws[i] = dw_part.sum(0)[:cin].float()
            dh = dh_prev
    return dh[:, :c0].reshape(b, n, c0), dws, dgammas, dbetas


def point_mlp_train_bwd_cuda(x, weights, gammas, betas, eps, block_b, bf16,
                             saved, g, blocks=None):
    out = bwd_cuda(x, weights, gammas, betas, eps, block_b,
                   MODE_GHOST_BF16 if bf16 else MODE_F32, saved, g, KERNEL_BWD,
                   blocks)
    count_launch(KERNEL_BWD)
    return out


# ------------------------------------------------------------ the Function

class _PointMLPGhost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, block_b, bf16, blocks, n_layers, *params):
        weights = params[:n_layers]
        gammas = params[2 * n_layers:3 * n_layers]
        betas = params[3 * n_layers:]
        # decided once, at the forward: the backward runs on autograd's
        # own thread, outside any plain_on_cuda() block
        ctx.kernel = use_kernel(x)
        ctx.eps, ctx.block_b, ctx.bf16, ctx.n_layers = eps, block_b, bf16, \
            n_layers
        ctx.blocks = blocks
        if ctx.kernel:
            pooled, mus, msqs, saved = point_mlp_train_fwd_cuda(
                x, weights, gammas, betas, eps, block_b, bf16, blocks)
            zs, bmus, rstds, argmax = saved
            ctx.save_for_backward(x, *weights, *gammas, *betas, *zs, *bmus,
                                  *rstds, argmax)
        else:
            pooled, mus, msqs = point_mlp_train_fwd_plain(
                x, weights, gammas, betas, eps, block_b, bf16, blocks)
            ctx.save_for_backward(x, *weights, *gammas, *betas)
        means, vars_ = stats_from_rows(mus, msqs, blocks)
        means = [(mu + bias.to(mu.dtype)).to(x.dtype) for mu, bias in
                 zip(means, params[n_layers:2 * n_layers])]
        vars_ = [v.to(x.dtype) for v in vars_]
        ctx.mark_non_differentiable(*means, *vars_)
        return (pooled, *means, *vars_)

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        nl = ctx.n_layers
        x, *rest = ctx.saved_tensors
        weights, gammas, betas = rest[:nl], rest[nl:2 * nl], rest[2 * nl:3 * nl]
        args = (x, weights, gammas, betas, ctx.eps, ctx.block_b, ctx.bf16)
        if ctx.kernel:
            saved = (rest[3 * nl:4 * nl], rest[4 * nl:5 * nl],
                     rest[5 * nl:6 * nl], rest[6 * nl])
            dx, dws, dgammas, dbetas = point_mlp_train_bwd_cuda(
                *args, saved, g, ctx.blocks)
        else:
            dx, dws, dgammas, dbetas = point_mlp_train_bwd_plain(
                *args, g, ctx.blocks)
        dbiases = [torch.zeros_like(w[0]) for w in weights]
        return (dx, None, None, None, None, None, *dws, *dbiases, *dgammas,
                *dbetas)


def point_mlp_train_max(x, weights, biases, gammas, betas, *,
                        eps: float = 1e-5, block_b: int | None = None,
                        bf16: bool = True, blocks: Any = None):
    """(pooled [B, C_out], means, vars): the train-mode chain relu(BN(x W_l))
    with ghost batch statistics over blocks of `block_b` clouds
    (`auto_block_b` when None), max-pooled over points; means (with each
    layer's dense bias) and vars are the exact global statistics for the
    EMA. Differentiable in x, the weights, gammas and betas (the biases get
    exact zeros). CPU tensors take the plain versions, CUDA tensors the
    kernels (ops/dispatch.py). Under `blocks`, a reducer over the ranks
    that split the global batch (parallel/mesh.py::Blocks: `ranks`,
    `block_b`, `sub`, `group`, `sums`, `means`, `global_means`), x holds
    this rank's rows, block_b is the reducer's (chosen from the global
    batch, as the JAX package chooses it at trace time) and the
    statistics are those of the global batch's blocks."""
    widths = check_args(x, weights, biases, gammas, betas)
    batch = x.shape[0] * (1 if blocks is None else blocks.ranks)
    if blocks is not None:
        if block_b not in (None, blocks.block_b):
            raise ValueError(f"block_b={block_b}, but the reducer's blocks "
                             f"hold {blocks.block_b} clouds")
        block_b = blocks.block_b
    if block_b is None:
        block_b = auto_block_b(batch, x.shape[1], tuple(widths[1:]), bf16)
    if block_b is None or block_b < 1 or batch % block_b:
        raise ValueError(f"no valid batch block for B={batch}, "
                         f"N={x.shape[1]}, widths {widths[1:]}: the caller "
                         f"runs the exact chain")
    nl = len(weights)
    outs = _PointMLPGhost.apply(
        x, eps, block_b if blocks is None else blocks.sub, bool(bf16),
        blocks, nl, *weights, *biases, *gammas, *betas)
    return outs[0], tuple(outs[1:1 + nl]), tuple(outs[1 + nl:])
