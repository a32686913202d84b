#!/usr/bin/env python3
"""Whether chip_smoke.py's checks catch point_mlp_max computing in one
TF32 product where the port holds it to f32 (its tensor-core tile splits
the operands: three TF32 products a multiply-add).

    python3 tools/tf32_mutant.py

Run it from the root of a checkout on a machine with an NVIDIA H100. For
the checkout itself and for a mutant (a copy under the temp directory
whose tile in csrc/mma_tile.cuh drops the operands' low TF32 parts, so
each multiply-add is the single product a_hi * b_hi), it builds the
kernels and prints, at chip_smoke.py's shapes and tolerance, for
point_mlp_max at B=1024, N=1024 (widths 3-64-64-64-128-128) and at the
reconstruction widths (B=50, N=2048): max |kernel - plain|, whether it
holds rtol = atol = 1e-4, and the kernel's and the plain f32 version's
error against the plain version in float64 (largest entry, relative to
the largest).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = "samplenet_tpu_torch/csrc/mma_tile.cuh"
EDIT = ("lo = tf32(v - __uint_as_float(hi));", "lo = 0u;")


def read(name: str) -> None:
    """The readings in the checkout at the working directory."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain

    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def held(k, p) -> str:
        try:
            torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-4)
            return "holds 1e-4"
        except AssertionError:
            return "FAILS 1e-4"

    rng = np.random.default_rng(cs.SEED)
    for b, n, widths in ((cs.B, cs.N, cs.WIDTHS),
                         (cs.RECON_B, cs.RECON_N, cs.RECON_WIDTHS)):
        y = cs._randn(torch, rng, b, n, 3)
        wbs = cs._mlp_weights(torch, rng, cs.DEVICE, widths)
        k, p = point_mlp_max(y, wbs), point_mlp_max_plain(y, wbs)
        r = point_mlp_max_plain(y.double(), tuple(t.double() for t in wbs))
        print(f"[{name}] point_mlp_max B={b}, N={n}, widths {widths}: max "
              f"|kernel - plain| {float((k - p).abs().max())!r} "
              f"({held(k, p)}); against f64: kernel {cs._rel_err(k, r)!r}, "
              f"plain f32 {cs._rel_err(p, r)!r}", flush=True)


def run(root: str, name: str) -> None:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--read", name], cwd=root, capture_output=True,
                          text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    if proc.returncode:
        raise RuntimeError(f"{name}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")


def main() -> int:
    if sys.argv[1:2] == ["--read"]:
        read(sys.argv[2])
        return 0
    run(HERE, "tile")
    skip = shutil.ignore_patterns(".git", "build", "__pycache__")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "checkout")
        shutil.copytree(HERE, root, ignore=skip)
        path = os.path.join(root, TILE)
        with open(path) as f:
            src = f.read()
        if src.count(EDIT[0]) != 1:
            raise RuntimeError(f"the text to mutate is not in {TILE} "
                               f"exactly once")
        with open(path, "w") as f:
            f.write(src.replace(*EDIT))
        run(root, "1xTF32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
