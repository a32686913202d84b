"""Train-mode per-point MLP chain with exact batch-global BatchNorm + global
max, forward and backward: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd Function that joins them.

Mirrors samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499-534
(`point_mlp_exact_train_max`): it takes x [B, N, C_in] and per layer the
Dense kernel W [C_in, C_out], its bias, and BN's gamma and beta, and
returns (pooled [B, C_out], means, vars) where means are the batch means
of z plus the dense bias (the EMA's view) and vars the biased fast
variances, clamped at 0 as flax clamps them. Normalisation uses the exact
statistics over all B*N points. The dense bias never enters z, since BN
cancels it, so its gradient is exactly zero on both paths (:490); the
means' and vars' cotangents feed only the EMA and are ignored (:457).
The max-pool gradient goes to the first point that attains the max.

With `bf16` (off by default, as in JAX :508) each matmul rounds both
operands to bf16 and sums the exact products in f32, at the TPU kernel's
rounding points (:97-110, :157-204, :283): in the forward z_l =
bf16(h_{l-1}) bf16(W_l), x itself rounded at layer 0, the statistics
from that z and xhat in f32; in the backward the max-pool cotangent goes
to the first argmax of the f32 h_L, dz is f32 and enters dW =
bf16(h_prev)^T bf16(dz) and dh_prev = bf16(dz) bf16(W)^T, and each
layer's rows (sum dy, sum dy*xhat) come from the unrounded dh_prev,
which the TPU kernel then spills in bf16, so that the layer below reads
the rounded dh; dx is not rounded. The TPU kernel's public entry forces
bf16 off under its CPU interpreter (:522-523); its private `_pme` runs
this arithmetic there, which the CPU tests hold the plain version to.

Both paths keep every pre-BN z_l for the backward (see
csrc/point_mlp_train.cu for the kernels' design: this chain is their case
of one block of all B clouds, backward mode 0 or, in bf16, 2). The plain
version does the same passes with torch ops; sums run in other orders, so
the two agree to f32 round-off (and, in bf16, to the roundings such
round-off can move). The kernels take f32; the plain version also takes
f64, which the on-card checks use as the reference both are held
against.
"""

from __future__ import annotations

from typing import Any

import torch

from samplenet_tpu_torch.ops.cuda._build import check, library, stream_handle
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import (
    full_f32_matmul,
    round_op,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
    MODE_EXACT_BF16,
    MODE_F32,
    bwd_cuda,
    check_args,
    check_cuda,
    launch_grid,
    ptrs,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL_FWD = "point_mlp_exact_fwd"
KERNEL_BWD = "point_mlp_exact_bwd"
KERNEL_FWD_BF16 = "point_mlp_exact_bf16_fwd"
KERNEL_BWD_BF16 = "point_mlp_exact_bf16_bwd"
_TILE = 64               # csrc/point_mlp_train.cu kTileP
_VMEM_BUDGET = 10 * 1024 * 1024     # the TPU kernel's (:54)


def auto_block_b_exact(batch: int, n: int, widths: tuple[int, ...],
                       bf16: bool = False) -> int | None:
    """The TPU kernel's batch block (:57-73, copied as it is): the largest
    power of two that divides `batch` and fits its VMEM plan, or None where
    none fits. The block has no meaning for the result; the port reads
    only whether there is one, because where there is none the JAX package
    runs its XLA chain in f32 instead of the exact kernel
    (nn/layers.py::resolve_fused_mode)."""
    del bf16
    per_lane = 9 * max(widths) * 4 + 3 * 4
    bb_max = _VMEM_BUDGET // max(n * per_lane, 1)
    if bb_max < 1:
        return None
    bb = 1
    while bb * 2 <= bb_max and batch % (bb * 2) == 0:
        bb *= 2
    return None if batch % bb else bb


def _stats(s1: torch.Tensor, s2: torch.Tensor, count: int, eps: float,
           dtype: torch.dtype):
    """(mean, var, rstd) as `dtype` from the sums of z and z^2 over
    `count` points (the kernels' sums are f64)."""
    mu = s1 / count
    var = torch.clamp(s2 / count - mu * mu, min=0.0)
    mu, var = mu.to(dtype), var.to(dtype)
    return mu, var, torch.rsqrt(var + eps)


def _act(z, mu, rstd, gamma, beta):
    return torch.relu(gamma * ((z - mu) * rstd) + beta)


# ------------------------------------------------------------ plain version

def _global(s: torch.Tensor, count: int, blocks):
    """The [2, C] sums s over `count` points, summed over the ranks under
    `blocks` (one all-reduce), and the count they cover."""
    if blocks is None:
        return s, count
    return blocks.sums(s[None])[0], count * blocks.group


def point_mlp_exact_fwd_plain(x, weights, gammas, betas, eps, bf16=False,
                              blocks=None):
    """(pooled [B, C_out], mus, vars, saved): saved feeds the backward.
    Under `blocks` the statistics are the global batch's."""
    b, n, c0 = x.shape
    count = b * n
    h = x.reshape(count, c0)
    zs, mus, rstds, vars_ = [], [], [], []
    with full_f32_matmul():
        for w, gamma, beta in zip(weights, gammas, betas):
            z = torch.matmul(round_op(h, bf16), round_op(w, bf16))
            s, total = _global(torch.stack([z.sum(0), (z * z).sum(0)]),
                               count, blocks)
            mu, var, rstd = _stats(s[0], s[1], total, eps, z.dtype)
            h = _act(z, mu, rstd, gamma, beta)
            zs.append(z)
            mus.append(mu)
            rstds.append(rstd)
            vars_.append(var)
    hb = h.reshape(b, n, -1)
    argmax = torch.argmax(hb, dim=1)                       # first max
    pooled = torch.gather(hb, 1, argmax[:, None, :])[:, 0]
    return pooled, mus, vars_, (zs, mus, rstds, argmax)


def point_mlp_exact_bwd_plain(x, weights, gammas, betas, saved, g,
                              bf16=False, blocks=None):
    """(dx, dWs, dgammas, dbetas) for the pooled cotangent g [B, C_out].
    With bf16, each layer's rows come from dh before its bf16 spill and dz
    from dh after it (below the top layer, whose dh is g at the argmax).
    Under `blocks` the rows that feed dz are summed over the ranks; the
    dgammas and dbetas returned stay this rank's sums."""
    zs, mus, rstds, argmax = saved
    b, n, c0 = x.shape
    count = b * n
    dh = torch.zeros((b, n, g.shape[1]), dtype=g.dtype, device=g.device)
    dh.scatter_(1, argmax[:, None, :], g[:, None, :])
    dh = dh.reshape(count, -1)
    nl = len(weights)
    dws, dgammas, dbetas = [None] * nl, [None] * nl, [None] * nl
    with full_f32_matmul():
        for i in range(nl - 1, -1, -1):
            xhat = (zs[i] - mus[i]) * rstds[i]
            on = torch.relu(gammas[i] * xhat + betas[i]) > 0
            dy = torch.where(on, dh, torch.zeros_like(dh))
            dbetas[i], dgammas[i] = dy.sum(0), (dy * xhat).sum(0)
            s, total = _global(torch.stack([dbetas[i], dgammas[i]]), count,
                               blocks)
            r1, r2 = gammas[i] * s[0] / total, gammas[i] * s[1] / total
            if bf16 and i < nl - 1:        # the spilled dh, read back
                dy = torch.where(on, round_op(dh, True),
                                 torch.zeros_like(dh))
            dz = round_op(rstds[i] * (gammas[i] * dy - r1 - xhat * r2),
                          bf16)
            h_prev = x.reshape(count, c0) if i == 0 else _act(
                zs[i - 1], mus[i - 1], rstds[i - 1], gammas[i - 1],
                betas[i - 1])
            dws[i] = torch.matmul(round_op(h_prev, bf16).t(), dz)
            dh = torch.matmul(dz, round_op(weights[i], bf16).t())
    return dh.reshape(b, n, c0), dws, dgammas, dbetas


# -------------------------------------------------------------- CUDA kernels
#
# csrc/point_mlp_train.cu holds the kernels of this chain and of the ghost
# chain (point_mlp_train_kernel.py, which also holds the helpers both
# wrappers share): exact global BN is its case of one block of all B
# clouds, in backward mode MODE_F32 or MODE_EXACT_BF16.

def point_mlp_exact_fwd_cuda(x, weights, gammas, betas, eps, bf16=False,
                             blocks=None):
    name = KERNEL_FWD_BF16 if bf16 else KERNEL_FWD
    widths = [x.shape[-1], *(w.shape[1] for w in weights)]
    dense = check_cuda(x, widths, "point_mlp_exact")[1]
    b, n, _ = x.shape
    count = b * n
    lib = library()
    grid = launch_grid(-(-count // _TILE), x.device, per_sm=4)
    stream = stream_handle(x)
    h_in, prev = x.contiguous(), None
    zs, mus, rstds, vars_ = [], [], [], []
    with torch.cuda.device(x.device):
        for w, gamma, beta, dp in zip(weights, gammas, betas, dense):
            cin, cout = w.shape
            z = torch.empty((count, cout), dtype=torch.float32, device=x.device)
            rows = torch.empty((grid, 2, cout), dtype=torch.float64,
                               device=x.device)
            w_op = round_op(w, bf16).contiguous()
            err = lib.snt_pmt_dense(
                h_in.data_ptr(), cin, prev, 0, int(bf16), w_op.data_ptr(),
                cout, z.data_ptr(), rows.data_ptr(), 1, b, n, int(dp.stage),
                grid, stream)
            check(err, name)
            s, total = _global(rows.sum(0), count, blocks)
            mu, var, rstd = _stats(s[0], s[1], total, eps,
                                   torch.float32)
            prev = ptrs(mu, rstd, gamma.contiguous(), beta.contiguous())
            bn_keep = (mu, rstd, gamma.contiguous(), beta.contiguous())
            zs.append(z)
            mus.append(mu)
            rstds.append(rstd)
            vars_.append(var)
            h_in = z
        pooled = torch.empty((b, widths[-1]), dtype=torch.float32,
                             device=x.device)
        argmax = torch.empty((b, widths[-1]), dtype=torch.int32,
                             device=x.device)
        err = lib.snt_pmt_pool(zs[-1].data_ptr(), ptrs(*bn_keep), b, b, n,
                               widths[-1], pooled.data_ptr(),
                               argmax.data_ptr(), stream)
    check(err, name)
    count_launch(name)
    return pooled, mus, vars_, (zs, mus, rstds, argmax)


def point_mlp_exact_bwd_cuda(x, weights, gammas, betas, saved, g,
                             bf16=False, blocks=None):
    """The ghost chain's backward kernels as one block of all B clouds (of
    every rank under `blocks`), in mode MODE_F32 or, with bf16,
    MODE_EXACT_BF16 (`point_mlp_train_kernel.bwd_cuda`)."""
    name = KERNEL_BWD_BF16 if bf16 else KERNEL_BWD
    out = bwd_cuda(x, weights, gammas, betas, 0.0, x.shape[0],
                   MODE_EXACT_BF16 if bf16 else MODE_F32, saved, g, name,
                   blocks)
    count_launch(name)
    return out


# ------------------------------------------------------------ the Function

class _PointMLPExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, bf16, blocks, n_layers, *params):
        weights = params[:n_layers]
        gammas = params[2 * n_layers:3 * n_layers]
        betas = params[3 * n_layers:]
        # decided once, at the forward: the backward runs on autograd's
        # own thread, outside any plain_on_cuda() block
        ctx.kernel = use_kernel(x)
        fwd = point_mlp_exact_fwd_cuda if ctx.kernel \
            else point_mlp_exact_fwd_plain
        pooled, mus, vars_, saved = fwd(x, weights, gammas, betas, eps, bf16,
                                        blocks)
        zs, _, rstds, argmax = saved
        ctx.n_layers, ctx.bf16, ctx.blocks = n_layers, bf16, blocks
        ctx.save_for_backward(x, *weights, *gammas, *betas, *zs, *mus,
                              *rstds, argmax)
        means = [mu + bias for mu, bias in
                 zip(mus, params[n_layers:2 * n_layers])]
        ctx.mark_non_differentiable(*means, *vars_)
        return (pooled, *means, *vars_)

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        nl = ctx.n_layers
        x, *rest = ctx.saved_tensors
        weights, gammas, betas = rest[:nl], rest[nl:2 * nl], rest[2 * nl:3 * nl]
        zs, mus = rest[3 * nl:4 * nl], rest[4 * nl:5 * nl]
        rstds, argmax = rest[5 * nl:6 * nl], rest[6 * nl]
        bwd = point_mlp_exact_bwd_cuda if ctx.kernel \
            else point_mlp_exact_bwd_plain
        dx, dws, dgammas, dbetas = bwd(x, weights, gammas, betas,
                                       (zs, mus, rstds, argmax), g, ctx.bf16,
                                       ctx.blocks)
        dbiases = [torch.zeros_like(w[0]) for w in weights]
        return (dx, None, None, None, None, *dws, *dbiases, *dgammas,
                *dbetas)


def point_mlp_exact_train_max(x, weights, biases, gammas, betas, *,
                              eps: float = 1e-5, bf16: bool = False,
                              blocks: Any = None):
    """(pooled [B, C_out], means, vars): the train-mode chain
    relu(BN(x W_l)) with exact batch statistics, max-pooled over points,
    with bf16 matmul operands where `bf16`. weights are Dense kernels
    [C_in, C_out]; means include each layer's dense bias. Differentiable
    in x, the weights, gammas and betas (the biases get exact zeros). CPU
    tensors take the plain versions, CUDA tensors the kernels
    (ops/dispatch.py), counted as point_mlp_exact_{fwd,bwd} or, in bf16,
    point_mlp_exact_bf16_{fwd,bwd}. Under `blocks`, a reducer over the
    ranks that split the global batch with one block of all of it
    (parallel/mesh.py::batch_blocks), x holds this rank's rows and the
    statistics are the global batch's: each layer's [2, C] sums are
    reduced between the forward's launches, and the rows that feed dz
    between the backward's (the JAX kernel's psum under a sharded caller,
    :19-26, :418)."""
    check_args(x, weights, biases, gammas, betas)
    if blocks is not None and blocks.block_b != x.shape[0] * blocks.ranks:
        raise ValueError(f"the exact chain's statistics are one block of "
                         f"the global batch, {x.shape[0] * blocks.ranks} "
                         f"clouds; the reducer's blocks hold "
                         f"{blocks.block_b}")
    nl = len(weights)
    outs = _PointMLPExact.apply(x, eps, bool(bf16), blocks, nl, *weights,
                                *biases, *gammas, *betas)
    return outs[0], tuple(outs[1:1 + nl]), tuple(outs[1 + nl:])
