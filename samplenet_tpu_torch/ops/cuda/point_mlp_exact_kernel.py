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

Both paths keep every pre-BN z_l for the backward (see
csrc/point_mlp_train.cu for the kernels' design: this chain is their case
of one block of all B clouds, with bf16 off). The plain version does
the same passes with torch ops; sums run in other orders, so the two
agree to f32 round-off. The kernels take f32; the plain version also
takes f64, which the on-card checks use as the reference both are held
against.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda._build import check, library, stream_handle
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
    bwd_cuda,
    check_args,
    check_cuda,
    launch_grid,
    ptrs,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL_FWD = "point_mlp_exact_fwd"
KERNEL_BWD = "point_mlp_exact_bwd"
_TILE = 64               # csrc/point_mlp_train.cu kTileP


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

def point_mlp_exact_fwd_plain(x, weights, gammas, betas, eps):
    """(pooled [B, C_out], mus, vars, saved): saved feeds the backward."""
    b, n, c0 = x.shape
    count = b * n
    h = x.reshape(count, c0)
    zs, mus, rstds, vars_ = [], [], [], []
    with full_f32_matmul():
        for w, gamma, beta in zip(weights, gammas, betas):
            z = torch.matmul(h, w)
            mu, var, rstd = _stats(z.sum(0), (z * z).sum(0), count, eps,
                                   z.dtype)
            h = _act(z, mu, rstd, gamma, beta)
            zs.append(z)
            mus.append(mu)
            rstds.append(rstd)
            vars_.append(var)
    hb = h.reshape(b, n, -1)
    argmax = torch.argmax(hb, dim=1)                       # first max
    pooled = torch.gather(hb, 1, argmax[:, None, :])[:, 0]
    return pooled, mus, vars_, (zs, mus, rstds, argmax)


def point_mlp_exact_bwd_plain(x, weights, gammas, betas, saved, g):
    """(dx, dWs, dgammas, dbetas) for the pooled cotangent g [B, C_out]."""
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
            h = torch.relu(gammas[i] * xhat + betas[i])
            dy = torch.where(h > 0, dh, torch.zeros_like(dh))
            dbetas[i], dgammas[i] = dy.sum(0), (dy * xhat).sum(0)
            r1 = gammas[i] * dbetas[i] / count
            r2 = gammas[i] * dgammas[i] / count
            dz = rstds[i] * (gammas[i] * dy - r1 - xhat * r2)
            h_prev = x.reshape(count, c0) if i == 0 else _act(
                zs[i - 1], mus[i - 1], rstds[i - 1], gammas[i - 1],
                betas[i - 1])
            dws[i] = torch.matmul(h_prev.t(), dz)
            dh = torch.matmul(dz, weights[i].t())
    return dh.reshape(b, n, c0), dws, dgammas, dbetas


# -------------------------------------------------------------- CUDA kernels
#
# csrc/point_mlp_train.cu holds the kernels of this chain and of the ghost
# chain (point_mlp_train_kernel.py, which also holds the helpers both
# wrappers share): exact global BN is its case of one block of all B
# clouds, with bf16 off.

def point_mlp_exact_fwd_cuda(x, weights, gammas, betas, eps):
    widths = [x.shape[-1], *(w.shape[1] for w in weights)]
    check_cuda(x, widths, "point_mlp_exact")
    b, n, _ = x.shape
    count = b * n
    lib = library()
    grid = launch_grid(-(-count // _TILE), x.device, per_sm=4)
    stream = stream_handle(x)
    h_in, prev = x.contiguous(), None
    zs, mus, rstds, vars_ = [], [], [], []
    with torch.cuda.device(x.device):
        for w, gamma, beta in zip(weights, gammas, betas):
            cin, cout = w.shape
            z = torch.empty((count, cout), dtype=torch.float32, device=x.device)
            rows = torch.empty((grid, 2, cout), dtype=torch.float64,
                               device=x.device)
            err = lib.snt_pmt_dense(
                h_in.data_ptr(), cin, prev, 0, 0, w.contiguous().data_ptr(),
                cout, z.data_ptr(), rows.data_ptr(), 1, b, n, grid, stream)
            check(err, KERNEL_FWD)
            s = rows.sum(0)
            mu, var, rstd = _stats(s[0], s[1], count, eps,
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
    check(err, KERNEL_FWD)
    count_launch(KERNEL_FWD)
    return pooled, mus, vars_, (zs, mus, rstds, argmax)


def point_mlp_exact_bwd_cuda(x, weights, gammas, betas, saved, g):
    """The ghost chain's backward kernels as one block of all B clouds,
    with bf16 off (`point_mlp_train_kernel.bwd_cuda`)."""
    out = bwd_cuda(x, weights, gammas, betas, 0.0, x.shape[0], False, saved,
                   g, KERNEL_BWD)
    count_launch(KERNEL_BWD)
    return out


# ------------------------------------------------------------ the Function

class _PointMLPExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, n_layers, *params):
        weights = params[:n_layers]
        gammas = params[2 * n_layers:3 * n_layers]
        betas = params[3 * n_layers:]
        # decided once, at the forward: the backward runs on autograd's
        # own thread, outside any plain_on_cuda() block
        ctx.kernel = use_kernel(x)
        fwd = point_mlp_exact_fwd_cuda if ctx.kernel \
            else point_mlp_exact_fwd_plain
        pooled, mus, vars_, saved = fwd(x, weights, gammas, betas, eps)
        zs, _, rstds, argmax = saved
        ctx.n_layers = n_layers
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
                                       (zs, mus, rstds, argmax), g)
        dbiases = [torch.zeros_like(w[0]) for w in weights]
        return (dx, None, None, *dws, *dbiases, *dgammas, *dbetas)


def point_mlp_exact_train_max(x, weights, biases, gammas, betas, *,
                              eps: float = 1e-5):
    """(pooled [B, C_out], means, vars): the train-mode chain
    relu(BN(x W_l)) with exact batch statistics, max-pooled over points.
    weights are Dense kernels [C_in, C_out]; means include each layer's
    dense bias. Differentiable in x, the weights, gammas and betas (the
    biases get exact zeros). CPU tensors take the plain versions, CUDA
    tensors the kernels (ops/dispatch.py)."""
    check_args(x, weights, biases, gammas, betas)
    nl = len(weights)
    outs = _PointMLPExact.apply(x, eps, nl, *weights, *biases, *gammas,
                                *betas)
    return outs[0], tuple(outs[1:1 + nl]), tuple(outs[1 + nl:])
