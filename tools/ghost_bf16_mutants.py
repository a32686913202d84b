#!/usr/bin/env python3
"""Which wrong ghost-BN kernels the bf16 check of chip_smoke.py catches.

    python3 tools/ghost_bf16_mutants.py

Run it from the root of a checkout on a machine with an NVIDIA H100. For
the checkout itself, and for each mutant (a copy of it under the temp
directory with one of the ghost kernel's bf16 roundings left out), it
builds the kernels and prints the check's two readings at chip_smoke.py's
own input (B=32, N=1024, block 4): the outputs against the plain bf16
version, and the backward kernel against the plain VJP run on the kernel
forward's own state, both norm-wise, each beside the control (the kernel
with bf16 off) and the limits. For the checkout itself it also reads them
at four more seeded inputs, one of them at B=3 with block 1 and one at
the reconstruction widths.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = "samplenet_tpu_torch/csrc/point_mlp_train.cu"
PY = "samplenet_tpu_torch/ops/cuda/point_mlp_train_kernel.py"
MUTANTS = {  # name -> edits (file, text, its replacement), each text once
    "rounds nothing": [(
        CU, "return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;",
        "return v;")],
    # the forward's (pmt_dense's loader), and pmt_bwd_dw's h_prev
    "activations unrounded": [
        (CU, "__float_as_uint(rnd(v[j], kBf16));", "__float_as_uint(v[j]);"),
        (CU, "          v = rnd(v, R::op);", "          v = v;")],
    "dz unrounded": [(
        CU, "v[j] = rnd(rstd2 * (gamma * dy - r1 - xh * r2), R::op);",
        "v[j] = rstd2 * (gamma * dy - r1 - xh * r2);")],
    "mask from unrounded xhat": [  # the rows pass's, and pmt_bwd_dz's
        (CU, "*xh = rnd(ghost_xhat(bn, blk, c, c_out, z[gp * c_out + c]), "
             "store);",
         "*xh = ghost_xhat(bn, blk, c, c_out, z[gp * c_out + c]);"),
        (CU, "const float xh = rnd(__fmul_rn(__fsub_rn(zv[j], mu), rstd), "
             "R::xhat);",
         "const float xh = __fmul_rn(__fsub_rn(zv[j], mu), rstd);")],
    "h_prev from unrounded xhat": [(
        CU, "const float xh = rnd(__fmul_rn(__fsub_rn(v, mu), rstd), "
            "R::xhat);",
        "const float xh = __fmul_rn(__fsub_rn(v, mu), rstd);")],
    "rstd not recomputed": [(PY, "if store and i > 0:", "if False:")],
}


def read(name: str) -> None:
    """The readings in the checkout at the working directory."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from samplenet_tpu_torch.ops.cuda import auto_block_b

    cs.phase_build()
    rng = np.random.default_rng(cs.SEED + 30)  # as phase_compare_progressive
    for b, n1, n2 in ((cs.PROG_B, cs.PROG_N, cs.PROG_N), (3, 1000, 2500)):
        cs._randn(torch, rng, b, n1, 3), cs._randn(torch, rng, b, n2, 3)
    bb = auto_block_b(cs.PROG_B, cs.PROG_N, cs.WIDTHS[1:], True)
    cases = [("chip_smoke's input", cs._exact_inputs(
        torch, rng, cs.PROG_B, cs.PROG_N), bb)]
    if name == "none":
        for seed, b, n, widths, block in (
                (30, 32, 1024, cs.WIDTHS, bb), (31, 32, 1024, cs.WIDTHS, bb),
                (33, 3, 1000, cs.WIDTHS, 1),
                (34, 50, 2048, cs.RECON_WIDTHS, 1)):
            cases.append((f"seed {seed}, B={b}, N={n}", cs._exact_inputs(
                torch, np.random.default_rng(seed), b, n, widths), block))
    for tag, (x, groups, g), block in cases:
        op, _ = cs._ghost_call(torch, x, groups, g, block, True, plain=True)
        k = (cs._out_gap(torch, x, groups, g, block, True, op),
             cs._bwd_gap(torch, x, groups, g, block, True))
        c = (cs._out_gap(torch, x, groups, g, block, False, op),
             cs._bwd_gap(torch, x, groups, g, block, False))
        caught = not (k[0] <= cs.GHOST_BF16_OUT and k[1] <= cs.GHOST_BF16_BWD)
        print(f"[{name}] {tag}, block {block}: outputs {k[0]!r}, backward "
              f"{k[1]!r} (limits {cs.GHOST_BF16_OUT}, {cs.GHOST_BF16_BWD}): "
              f"{'CAUGHT' if caught else 'passes'}; control, bf16 off: "
              f"{c[0]!r}, {c[1]!r}", flush=True)
        torch.cuda.empty_cache()


def run(root: str, name: str) -> None:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--read", name], cwd=root, capture_output=True,
                          text=True, timeout=600)
    sys.stdout.write(proc.stdout)
    if proc.returncode:
        raise RuntimeError(f"{name}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")


def main() -> int:
    if sys.argv[1:2] == ["--read"]:
        read(sys.argv[2])
        return 0
    run(HERE, "none")
    skip = shutil.ignore_patterns(".git", "build", "__pycache__")
    for name, edits in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "checkout")
            shutil.copytree(HERE, root, ignore=skip)
            for path, text, new in edits:
                with open(os.path.join(root, path)) as f:
                    src = f.read()
                if src.count(text) != 1:
                    raise RuntimeError(f"{name}: the text to mutate is not "
                                       f"in {path} exactly once")
                with open(os.path.join(root, path), "w") as f:
                    f.write(src.replace(text, new))
            run(root, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
