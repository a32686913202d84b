"""Eval per-point MLP chain + global max: the CUDA kernel's wrapper, its
plain PyTorch version, and the BN fold that feeds both.

Mirrors samplenet_tpu/ops/pallas/point_mlp_kernel.py:35-42
(`fold_bn_affine`), :45-66 (the Pallas body) and :127-164
(`point_mlp_max`). The kernel is csrc/point_mlp_max.cu; its note says what
bounds it and how it is laid out. It has two modes:

- f32 (the port's default, what the JAX package computes off the TPU,
  where its interpreter forces bf16 off, :148-149): operands multiplied
  on the tensor cores in two TF32 parts each;
- `bf16=True` (the TPU kernel's own default, :133, body :53-63): each
  layer's operands, x included, rounded to bf16, their exact products
  summed in f32, bias and ReLU in f32, the max over points; on the tensor
  cores as one bf16 product a multiply-add.

Sums run in another order than the plain version's matmuls, so the two
agree to f32 round-off (in bf16, to the roundings that round-off can
move), not bit for bit.
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
    BF16_MMA_MIN_CIN,
    MAX_LAYERS as _MAX_LAYERS,
    max_smem,
    plan_max,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "point_mlp_max"
KERNEL_BF16 = "point_mlp_max_bf16"


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


def round_op(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A matmul operand rounded to bf16 (kept in its dtype) where `bf16`,
    as the kernels round it: exact products, summed in f32."""
    return t.to(torch.bfloat16).to(t.dtype) if bf16 else t


def point_mlp_max_plain(x: torch.Tensor, weights_and_biases,
                        bf16: bool = False) -> torch.Tensor:
    """max over points of the ReLU-chained per-point MLP: [B, C_out]; with
    `bf16` each matmul's operands are rounded to bf16 first."""
    h = x
    with full_f32_matmul():
        for w, b in _pairs(weights_and_biases):
            h = torch.relu(torch.matmul(round_op(h, bf16),
                                        round_op(w, bf16)) + b)
    return h.amax(dim=1)


def point_mlp_max(x: torch.Tensor, weights_and_biases, *,
                  bf16: bool = False) -> torch.Tensor:
    """max over points of the ReLU-chained per-point MLP. Returns [B, C_out].

    Each w_i is [C_in_i, C_out_i] f32 with eval-BN already folded
    (`fold_bn_affine`); each b_i is [C_out_i] or [1, C_out_i]. `bf16`
    rounds each matmul's operands to bf16 (the TPU kernel's default; the
    port's default stays f32, as the JAX package computes on the CPU).
    CPU tensors take `point_mlp_max_plain`, CUDA tensors the kernel
    (ops/dispatch.py), counted as point_mlp_max or point_mlp_max_bf16.
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
        return point_mlp_max_plain(x, weights_and_biases, bf16)
    return _point_mlp_max_cuda(x, pairs, widths, bool(bf16))


def _bf16_pairs(w: torch.Tensor) -> torch.Tensor:
    """W [cin, cout] as the bf16 kernel reads it: rows 2k and 2k + 1 of
    bf16(W) packed in one 32-bit word per column, row 2k in the low half
    (cin padded to even with a zero row): [ceil(cin/2), cout] words,
    returned as float32 bits."""
    cin, cout = w.shape
    wb = torch.zeros((cin + cin % 2, cout), dtype=torch.bfloat16,
                     device=w.device)
    wb[:cin] = w
    return wb.reshape(-1, 2, cout).transpose(1, 2).contiguous().view(
        torch.float32).reshape(-1)


def _params(pairs, bf16: bool) -> torch.Tensor:
    """One packed buffer, W_l then b_l per layer. In bf16 W_l is rounded:
    as f32 values where the kernel takes layer l on the FP32 pipes (a first
    layer of fewer than 16 channels), else packed in pairs (`_bf16_pairs`).
    Every offset is a multiple of 4 words because every output width is."""
    parts = []
    for layer, (w, b) in enumerate(pairs):
        if not bf16:
            parts.append(w.reshape(-1))
        elif layer == 0 and w.shape[0] < BF16_MMA_MIN_CIN:
            parts.append(round_op(w, True).reshape(-1))
        else:
            parts.append(_bf16_pairs(w))
        parts.append(b.reshape(-1))
    return torch.cat(parts)


def _point_mlp_max_cuda(x, pairs, widths, bf16: bool) -> torch.Tensor:
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
    smem = lib.snt_point_mlp_max_smem(c_widths, layers, int(bf16))
    if plan_max(widths, max_dynamic_smem(x.device), bf16) is None:
        raise ValueError(f"widths {widths} need {smem} bytes of shared "
                         f"memory per block, more than the card offers")
    if smem != max_smem(widths, bf16):
        raise RuntimeError("point_mlp_plan.py and csrc/point_mlp_max.cu "
                           "count shared memory apart")
    params = _params(pairs, bf16)
    out = torch.empty((x.shape[0], widths[-1]), dtype=torch.float32,
                      device=x.device)
    name = KERNEL_BF16 if bf16 else KERNEL
    with torch.cuda.device(x.device):
        err = lib.snt_point_mlp_max(
            x.data_ptr(), params.data_ptr(), c_widths, layers, int(bf16),
            out.data_ptr(), x.shape[0], x.shape[1], stream_handle(x))
    check(err, name)
    count_launch(name)
    return out
