"""The port's one dispatch rule, and the kernels' launch counters.

Mirrors samplenet_tpu/ops/dispatch.py:7-13, where the JAX package picks a
Pallas kernel by backend. Here the tensor's device decides, and nothing
falls back:

  * a CPU tensor runs the plain PyTorch version;
  * a CUDA tensor runs the hand-written kernel, which raises if it cannot
    be built or launched;
  * any other device raises.

`plain_on_cuda()` lets a caller run the plain versions on CUDA tensors, to
compare a kernel path with its reference on the card; the serving path
never enters it. The eval path's three kernels (nn_direction, fps,
point_mlp_max) are torch.library ops, samplenet::*, each with a CPU
implementation (the plain version), a CUDA one (the kernel) and a fake one
(shapes and dtypes), so that torch.export carries them (serving.py).

A model run in a compute dtype (bf16, `--bf16`) reaches no per-point MLP
kernel: as in the JAX package, whose `dtype` turns off both its eval
kernel and its fused train chain (samplenet_tpu/nn/layers.py:88, :120),
those chains run as tensor ops (nn/layers.py::use_eval_kernel,
resolve_fused_mode), which are cuBLAS bf16 GEMMs on the card where the
JAX package ran XLA matmuls outside any Pallas kernel. The distance
kernels still run, in f32.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

_launches: Counter[str] = Counter()
_launches_lock = threading.Lock()


class _Mode(threading.local):
    plain_on_cuda = False


_mode = _Mode()


def use_kernel(t: torch.Tensor) -> bool:
    """True where `t` must go through the CUDA kernel, False where it takes
    the plain version; raises for a device the port does not serve."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return not _mode.plain_on_cuda
    raise ValueError(
        f"samplenet_tpu_torch runs on cpu or cuda tensors, got {t.device}")


@contextlib.contextmanager
def plain_on_cuda():
    """Within this block (and this thread), CUDA tensors take the plain
    PyTorch versions instead of the kernels."""
    prev = _mode.plain_on_cuda
    _mode.plain_on_cuda = True
    try:
        yield
    finally:
        _mode.plain_on_cuda = prev


def count_launch(name: str) -> None:
    """Called by a wrapper right after it launched kernel `name`."""
    with _launches_lock:
        _launches[name] += 1


def launch_counts() -> dict[str, int]:
    with _launches_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launches_lock:
        _launches.clear()
