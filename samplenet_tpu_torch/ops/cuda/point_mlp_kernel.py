"""Eval per-point MLP chain + global max: the CUDA kernel's wrapper, its
plain PyTorch version, and the BN fold that feeds both.

Mirrors samplenet_tpu/ops/pallas/point_mlp_kernel.py:35-42
(`fold_bn_affine`), :45-66 (the Pallas body) and :127-164
(`point_mlp_max`). The kernel is csrc/point_mlp_max.cu; its note says what
bounds it and how it is laid out. Operands are f32, multiplied on the
tensor cores in two TF32 parts each (the TPU default of bf16 operands is
later work); sums run in another order than the plain version's matmuls,
so the two agree to f32 round-off, not bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_plan import (
    MAX_LAYERS as _MAX_LAYERS,
    max_smem,
    plan_max,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "point_mlp_max"


def fold_bn_affine(kernel, bias, scale, bn_bias, mean, var, eps=1e-5):
    """Folds an eval-mode BatchNorm into the preceding Dense layer.

    y = ((x @ W + b) - mean) * scale / sqrt(var + eps) + bn_bias
      =  x @ (W * s) + ((b - mean) * s + bn_bias),  s = scale * rsqrt(var+eps)
    """
    s = scale * torch.rsqrt(var + eps)
    return kernel * s[None, :], (bias - mean) * s + bn_bias


def _pairs(weights_and_biases) -> list[tuple[torch.Tensor, torch.Tensor]]:
    wbs = tuple(weights_and_biases)
    if not wbs or len(wbs) % 2:
        raise ValueError("point_mlp_max takes (w_0, b_0, ..., w_L-1, b_L-1)")
    return [(wbs[i], wbs[i + 1].reshape(-1)) for i in range(0, len(wbs), 2)]


def _check_args(x: torch.Tensor, pairs) -> list[int]:
    if x.dim() != 3 or x.shape[1] == 0:
        raise ValueError(f"point_mlp_max takes x [B, N>=1, C], got "
                         f"{tuple(x.shape)}")
    widths = [x.shape[-1]]
    for w, b in pairs:
        if w.dim() != 2 or w.shape[0] != widths[-1] \
                or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"layer {len(widths) - 1}: w {tuple(w.shape)} and b "
                f"{tuple(b.shape)} do not follow width {widths[-1]}")
        widths.append(w.shape[1])
    for t in (x, *(t for pair in pairs for t in pair)):
        if t.dtype != torch.float32:
            raise TypeError(f"point_mlp_max takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and the weights must share a device")
    return widths


@contextlib.contextmanager
def full_f32_matmul():
    """Plain f32 matmuls: TF32 off for the block, as the reference holds."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def point_mlp_max_plain(x: torch.Tensor, weights_and_biases) -> torch.Tensor:
    """max over points of the ReLU-chained per-point MLP: [B, C_out]."""
    h = x
    with full_f32_matmul():
        for w, b in _pairs(weights_and_biases):
            h = torch.relu(torch.matmul(h, w) + b)
    return h.amax(dim=1)


def point_mlp_max(x: torch.Tensor, weights_and_biases) -> torch.Tensor:
    """max over points of the ReLU-chained per-point MLP. Returns [B, C_out].

    Each w_i is [C_in_i, C_out_i] f32 with eval-BN already folded
    (`fold_bn_affine`); each b_i is [C_out_i] or [1, C_out_i]. CPU tensors
    take `point_mlp_max_plain`, CUDA tensors the kernel (ops/dispatch.py).
    The kernel has no backward, so an input that requires grad under grad
    mode raises on both devices rather than lose its gradient on the card.
    """
    pairs = _pairs(weights_and_biases)
    widths = _check_args(x, pairs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *(t for pair in pairs for t in pair))):
        raise RuntimeError(
            "point_mlp_max has no backward: call it under torch.no_grad() "
            "or on inputs that do not require grad")
    if not use_kernel(x):
        return point_mlp_max_plain(x, weights_and_biases)
    return _point_mlp_max_cuda(x, pairs, widths)


def _point_mlp_max_cuda(x, pairs, widths) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the point_mlp_max kernel takes CUDA tensors, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("the point_mlp_max kernel takes a contiguous x")
    layers = len(pairs)
    if layers > _MAX_LAYERS or any(c % 4 for c in widths[1:]):
        raise ValueError(
            f"the point_mlp_max kernel takes at most {_MAX_LAYERS} layers "
            f"with output widths divisible by 4, got {widths}")
    lib = library()
    c_widths = (ctypes.c_int * (layers + 1))(*widths)
    smem = lib.snt_point_mlp_max_smem(c_widths, layers)
    if plan_max(widths, max_dynamic_smem(x.device)) is None:
        raise ValueError(f"widths {widths} need {smem} bytes of shared "
                         f"memory per block, more than the card offers")
    if smem != max_smem(widths):
        raise RuntimeError("point_mlp_plan.py and csrc/point_mlp_max.cu "
                           "count shared memory apart")
    # one packed buffer, W_l then b_l per layer; every offset is a multiple
    # of 4 floats because every output width is
    params = torch.cat([t.reshape(-1) for pair in pairs for t in pair])
    out = torch.empty((x.shape[0], widths[-1]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.snt_point_mlp_max(
            x.data_ptr(), params.data_ptr(), c_widths, layers,
            out.data_ptr(), x.shape[0], x.shape[1], stream_handle(x))
    check(err, KERNEL)
    count_launch(KERNEL)
    return out
