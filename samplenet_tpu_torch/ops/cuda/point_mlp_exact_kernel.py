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
csrc/point_mlp_exact.cu for the kernels' design). The plain version does
the same passes with torch ops; sums run in other orders, so the two
agree to f32 round-off. The kernels take f32; the plain version also
takes f64, which the on-card checks use as the reference both are held
against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL_FWD = "point_mlp_exact_fwd"
KERNEL_BWD = "point_mlp_exact_bwd"
_TILE = 64               # csrc/point_mlp_exact.cu kTileP


def _check_args(x, weights, biases, gammas, betas) -> list[int]:
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

def _grid(work: int, device, per_sm: int) -> int:
    """Blocks for a pass over `work` tiles that keeps its partial sums in
    shared memory: `per_sm` per SM at most (what fits at the train
    widths), a number fixed by the shape and the card, so the partial
    sums (and their order) repeat from run to run."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(work, per_sm * sms))


_MAX_ROW_BLOCKS = 65535


def _rows_grid(work: int) -> int:
    """Blocks for the BN-rows pass: one per tile or cloud (each block
    strides over the rest beyond the cap); the partials are f64 rows."""
    return max(1, min(work, _MAX_ROW_BLOCKS))


def _ptrs(*tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _bwd_slab(cin_pad: int, cout: int, smem_of, limit: int) -> int | None:
    """Input channels one pme_bwd block takes: all cin_pad where its
    shared memory fits `limit`, else cin_pad cut into the fewest equal
    slabs (multiples of 4) that fit (csrc/point_mlp_exact.cu, pme_bwd);
    None where not even 4 channels do."""
    for parts in range(1, cin_pad // 4 + 1):
        slab = -(-cin_pad // (4 * parts)) * 4
        if smem_of(slab, cout) <= limit:
            return slab
    return None


def _check_cuda(x, widths) -> list[int]:
    """Checks what the kernels take; returns each layer's pme_bwd slab."""
    if x.device.type != "cuda":
        raise ValueError(f"the point_mlp_exact kernels take CUDA tensors, "
                         f"got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the point_mlp_exact kernels take float32, got "
                        f"{x.dtype}")
    if any(c % 4 for c in widths[1:]):
        raise ValueError(f"the point_mlp_exact kernels take output widths "
                         f"divisible by 4, got {widths}")
    lib = library()
    limit = max_dynamic_smem(x.device)
    need = max(lib.snt_pme_dense_smem(ci, co)
               for ci, co in zip(widths[:-1], widths[1:]))
    slabs = [_bwd_slab(-(-ci // 4) * 4, co, lib.snt_pme_bwd_smem, limit)
             for ci, co in zip(widths[:-1], widths[1:])]
    if need > limit or None in slabs:
        raise ValueError(f"widths {widths} need more shared memory per block "
                         f"than the card offers")
    return slabs


def point_mlp_exact_fwd_cuda(x, weights, gammas, betas, eps):
    widths = [x.shape[-1], *(w.shape[1] for w in weights)]
    _check_cuda(x, widths)
    b, n, _ = x.shape
    count = b * n
    lib = library()
    grid = _grid(-(-count // _TILE), x.device, per_sm=4)
    stream = stream_handle(x)
    h_in, prev = x.contiguous(), None
    zs, mus, rstds, vars_ = [], [], [], []
    with torch.cuda.device(x.device):
        for w, gamma, beta in zip(weights, gammas, betas):
            cin, cout = w.shape
            z = torch.empty((count, cout), dtype=torch.float32, device=x.device)
            rows = torch.empty((grid, 2, cout), dtype=torch.float64,
                               device=x.device)
            err = lib.snt_pme_dense(
                h_in.data_ptr(), cin, prev, w.contiguous().data_ptr(), cout,
                z.data_ptr(), rows.data_ptr(), count, grid, stream)
            check(err, KERNEL_FWD)
            s = rows.sum(0)
            mu, var, rstd = _stats(s[0], s[1], count, eps,
                                   torch.float32)
            prev = _ptrs(mu, rstd, gamma.contiguous(), beta.contiguous())
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
        err = lib.snt_pme_pool(zs[-1].data_ptr(), _ptrs(*bn_keep), b, n,
                               widths[-1], pooled.data_ptr(),
                               argmax.data_ptr(), stream)
    check(err, KERNEL_FWD)
    count_launch(KERNEL_FWD)
    return pooled, mus, vars_, (zs, mus, rstds, argmax)


def point_mlp_exact_bwd_cuda(x, weights, gammas, betas, saved, g):
    zs, mus, rstds, argmax = saved
    widths = [x.shape[-1], *(w.shape[1] for w in weights)]
    slabs = _check_cuda(x, widths)
    b, n, c0 = x.shape
    count = b * n
    lib = library()
    tiles = -(-count // _TILE)
    stream = stream_handle(x)
    g = g.contiguous()
    gammas = [t.contiguous() for t in gammas]
    betas = [t.contiguous() for t in betas]
    bns = [(mus[i], rstds[i], gammas[i], betas[i]) for i in range(len(zs))]
    nl = len(weights)
    dws, dgammas, dbetas = [None] * nl, [None] * nl, [None] * nl
    dh = None                      # the top layer reads g at argmax
    with torch.cuda.device(x.device):
        for i in range(nl - 1, -1, -1):
            cout = widths[i + 1]
            grid = _rows_grid(b if dh is None else tiles)
            rows = torch.empty((grid, 2, cout), dtype=torch.float64,
                               device=x.device)
            err = lib.snt_pme_rows(
                zs[i].data_ptr(), _ptrs(*bns[i]), cout,
                None if dh is None else dh.data_ptr(), g.data_ptr(),
                argmax.data_ptr(), b, n, rows.data_ptr(), grid, stream)
            check(err, KERNEL_BWD)
            s = rows.sum(0).float()
            dbetas[i], dgammas[i] = s[0], s[1]
            r1 = (gammas[i] * dbetas[i] / count).contiguous()
            r2 = (gammas[i] * dgammas[i] / count).contiguous()
            cin = widths[i]
            cin_pad = -(-cin // 4) * 4
            wt = F.pad(weights[i].t(), (0, cin_pad - cin)).contiguous()
            grid = _grid(tiles, x.device, per_sm=2)
            dw_part = torch.empty((grid, cin_pad, cout), dtype=torch.float64,
                                  device=x.device)
            dh_prev = torch.empty((count, cin_pad), dtype=torch.float32,
                                  device=x.device)
            h_in = x.contiguous() if i == 0 else zs[i - 1]
            err = lib.snt_pme_bwd(
                h_in.data_ptr(), cin, cin_pad, slabs[i],
                None if i == 0 else _ptrs(*bns[i - 1]), zs[i].data_ptr(),
                _ptrs(*bns[i]), cout, None if dh is None else dh.data_ptr(),
                g.data_ptr(), argmax.data_ptr(), b, n, r1.data_ptr(),
                r2.data_ptr(), wt.data_ptr(), dw_part.data_ptr(),
                dh_prev.data_ptr(), grid, stream)
            check(err, KERNEL_BWD)
            dws[i] = dw_part.sum(0)[:cin].float()
            dh = dh_prev
    count_launch(KERNEL_BWD)
    return dh[:, :c0].reshape(b, n, c0), dws, dgammas, dbetas


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
    _check_args(x, weights, biases, gammas, betas)
    nl = len(weights)
    outs = _PointMLPExact.apply(x, eps, nl, *weights, *biases, *gammas,
                                *betas)
    return outs[0], tuple(outs[1:1 + nl]), tuple(outs[1 + nl:])
