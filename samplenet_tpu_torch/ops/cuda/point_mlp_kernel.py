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

Where B clouds leave the card's block slots idle, a cloud's 64-point tiles
are split over S blocks (point_mlp_plan.py::max_splits); the output's bits
do not depend on S.

Sums run in another order than the plain version's matmuls, so the two
agree to f32 round-off (in bf16, to the roundings that round-off can
move), not bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_plan import (
    BF16_MMA_MIN_CIN,
    PARAM_LAYERS,
    kernel_widths,
    max_smem,
    max_splits,
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
    (ops/dispatch.py), counted as point_mlp_max or point_mlp_max_bf16;
    both through the op samplenet::point_mlp_max, which takes the layers
    packed in one buffer (`_flat_params`); under `plain_on_cuda()` the
    plain version on the card. The kernel has no backward, so an input
    that requires grad under grad mode raises on both devices rather than
    lose its gradient on the card.
    """
    pairs = _pairs(weights_and_biases)
    widths = _check_args(x, pairs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *(t for pair in pairs for t in pair))):
        raise RuntimeError(
            "point_mlp_max has no backward: call it under torch.no_grad() "
            "or on inputs that do not require grad")
    if use_kernel(x):  # checked here too: tracing runs no CUDA impl
        _check_cuda(x)
    elif x.device.type == "cuda":                  # under plain_on_cuda()
        return point_mlp_max_plain(x, weights_and_biases, bf16)
    return point_mlp_max_op(x, _flat_params(pairs), widths, bool(bf16))


def _flat_params(pairs) -> torch.Tensor:
    """W_0 [C_0, C_1] row-major, b_0, W_1, b_1, ... in one f32 buffer: the
    f32 kernel's own layout (`_params`)."""
    return torch.cat([t.reshape(-1) for pair in pairs for t in pair])


def _unflatten(params: torch.Tensor, widths) -> list[tuple[torch.Tensor,
                                                           torch.Tensor]]:
    pairs, off = [], 0
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = params[off:off + cin * cout].view(cin, cout)
        off += cin * cout
        pairs.append((w, params[off:off + cout]))
        off += cout
    if off != params.numel():
        raise ValueError(f"point_mlp_max: {params.numel()} parameters do "
                         f"not fit widths {list(widths)}")
    return pairs


@torch.library.custom_op("samplenet::point_mlp_max", mutates_args=(),
                         device_types="cpu")
def point_mlp_max_op(x: torch.Tensor, params: torch.Tensor,
                     widths: list[int], bf16: bool) -> torch.Tensor:
    """The op a torch.export program carries, over the layers packed by
    `_flat_params`; on the CPU the plain version."""
    pairs = _unflatten(params, widths)
    return point_mlp_max_plain(x, [t for pair in pairs for t in pair], bf16)


@point_mlp_max_op.register_fake
def _point_mlp_max_fake(x, params, widths, bf16):
    return x.new_empty((x.shape[0], widths[-1]))


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
    Every offset is a multiple of 4 words because every output width is
    (`padded_pairs`)."""
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


def _check_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the point_mlp_max kernel takes CUDA tensors, got "
                         f"{x.device}")


def padded_pairs(pairs, widths) -> tuple[list, tuple[int, ...]]:
    """The layers at `kernel_widths(widths)`, which the kernel runs: each
    output width padded to a multiple of 4 with zero weight columns (and
    the next layer's zero rows) and zero bias, so that a padded channel's
    h is relu(0) = 0 and the real channels' values are unchanged; the
    caller keeps the first widths[-1] channels of the max."""
    kw = kernel_widths(widths)
    return [(F.pad(w, (0, co - w.shape[1], 0, ci - w.shape[0])),
             F.pad(b, (0, co - b.shape[0])))
            for (w, b), ci, co in zip(pairs, kw[:-1], kw[1:])], kw


@point_mlp_max_op.register_kernel("cuda")
def _point_mlp_max_cuda(x, params, widths, bf16):
    return _launch(x, params, widths, bf16, None)


@functools.lru_cache(maxsize=256)
def _resident(device: int, widths: tuple[int, ...], bf16: bool) -> int:
    """Blocks of the chain's kernel an SM of CUDA device `device` holds."""
    with torch.cuda.device(device):
        blocks = library().snt_point_mlp_max_resident(
            (ctypes.c_int * len(widths))(*widths), len(widths) - 1, int(bf16))
    if blocks < 1:
        raise RuntimeError(f"point_mlp_max at widths {list(widths)}: no "
                           f"block fits an SM ({blocks})")
    return blocks


def max_splits_for(x: torch.Tensor, widths, bf16: bool = False) -> int:
    """The plan's S (blocks a cloud) for x [B, N, C] on its card at the
    chain `widths`."""
    kw = kernel_widths(widths)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return max_splits(x.shape[0], x.shape[1], sms=sms,
                      resident=_resident(x.device.index, kw, bool(bf16)))


def launch_max(x: torch.Tensor, weights_and_biases, *, bf16: bool = False,
               splits: int) -> torch.Tensor:
    """The kernel on CUDA x under a forced S (the card tests and
    chip_smoke.py hold every S to the plan's bits)."""
    pairs = _pairs(weights_and_biases)
    widths = _check_args(x, pairs)
    return _launch(x, _flat_params(pairs), widths, bool(bf16), splits)


def _launch(x, params, widths, bf16, splits):
    _check_cuda(x)
    x = x.contiguous()              # strided x: the kernel reads rows
    width = widths[-1]
    pairs = _unflatten(params, widths)
    if kernel_widths(widths) != tuple(widths):
        pairs, widths = padded_pairs(pairs, widths)
        params = _flat_params(pairs)
    layers = len(pairs)
    lib = library()
    c_widths = (ctypes.c_int * (layers + 1))(*widths)
    smem = lib.snt_point_mlp_max_smem(c_widths, layers, int(bf16))
    if plan_max(widths, max_dynamic_smem(x.device), bf16) is None:
        raise ValueError(f"widths {widths} need {smem} bytes of shared "
                         f"memory per block, more than the card offers")
    if (smem != max_smem(widths, bf16)
            or lib.snt_point_mlp_max_param_layers() != PARAM_LAYERS):
        raise RuntimeError("point_mlp_plan.py and csrc/point_mlp_max.cu "
                           "count shared memory or layers apart")
    params = _params(pairs, True) if bf16 else params.contiguous()
    out = torch.empty((x.shape[0], widths[-1]), dtype=torch.float32,
                      device=x.device)
    name = KERNEL_BF16 if bf16 else KERNEL
    # a chain deeper than the kernel's parameters hold reads its layer
    # table (widths and offsets, which the C entry fills) from here
    table = (torch.empty(3 * layers + 1, dtype=torch.int64, device=x.device)
             if layers > PARAM_LAYERS else None)
    if splits is None:
        splits = max_splits_for(x, widths, bf16)
    with torch.cuda.device(x.device):
        err = lib.snt_point_mlp_max(
            x.data_ptr(), params.data_ptr(), c_widths, layers, int(bf16),
            None if table is None else table.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], splits, stream_handle(x))
    check(err, name)
    count_launch(name)
    return out if widths[-1] == width else out[:, :width].contiguous()
