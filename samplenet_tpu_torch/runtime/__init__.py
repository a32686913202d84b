"""The port's native data runtime (counterpart of samplenet_tpu/runtime):
the C++ PLY parser and threaded prefetch pipeline, built with g++ at first
use and bound with ctypes."""

from samplenet_tpu_torch.runtime.loader import (  # noqa: F401
    NativeLoader,
    load_ply_native,
    native_available,
)
