#!/usr/bin/env python3
"""Compare the SASS of the kernels that two checkouts build.

    python3 tools/sass_diff.py CHECKOUT_A CHECKOUT_B [SUBSTRING ...]

Builds each checkout's kernel library (that checkout's
samplenet_tpu_torch/ops/cuda/_build.py, into its own build/ directory),
disassembles both with cuobjdump (chip_smoke.py's `_sass`) and, for every
kernel that both hold under one mangled name (the anonymous namespace's
per-file hash taken out, and trailing int parameters, so that a kernel
that gained one at the end of its list is held to its old self) and
whose name holds one of the SUBSTRINGs (every kernel without any),
prints whether its instructions are the same,
instruction for instruction, and their counts. Equal SASS means that the
kernel runs the same code on both trees. Kernels that only one tree
holds are counted apart. Exits 1 where a common kernel differs.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# e.g. 38_GLOBAL__N__d2e953e7_6_fps_cu_a7ff0874: the length-prefixed
# anonymous namespace of fps.cu, whose hashes change with the file
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}")
TRAILING_INTS = re.compile(r"[ix]+$")    # int and long long parameters


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels(cs, root: str, tag: str) -> dict[str, list[str]]:
    """{normalised mangled name: [instruction]} of `root`'s library."""
    build = _module(os.path.join(root, "samplenet_tpu_torch", "ops", "cuda",
                                 "_build.py"), f"_build_{tag}")
    path, _ = build.build()
    funcs = {ANON.sub(r"anon_\1", name): [ins for _, ins in code]
             for name, code in cs._sass(build.find_nvcc(), path).items()}
    short = [TRAILING_INTS.sub("", name) for name in funcs]
    # a name stays whole where another kernel is apart only by int params
    return {s if short.count(s) == 1 else name: code
            for s, (name, code) in zip(short, funcs.items())}


def main() -> int:
    a_root, b_root = (os.path.abspath(p) for p in sys.argv[1:3])
    keys = sys.argv[3:]
    cs = _module(os.path.join(TOOL_ROOT, "chip_smoke.py"), "chip_smoke")
    a, b = kernels(cs, a_root, "a"), kernels(cs, b_root, "b")
    common = sorted(n for n in a.keys() & b.keys()
                    if not keys or any(k in n for k in keys))
    differ = 0
    for name in common:
        same = a[name] == b[name]
        differ += not same
        print(f"{'same   ' if same else 'DIFFERS'} {len(a[name])} / "
              f"{len(b[name])} instructions: {name}")
    only = [sorted(n for n in x.keys() - y.keys()
                   if not keys or any(k in n for k in keys))
            for x, y in ((a, b), (b, a))]
    print(f"{len(common)} kernels in both, {differ} differ; only in "
          f"{a_root}: {len(only[0])}; only in {b_root}: {len(only[1])}")
    for name in only[1]:
        print(f"only in {b_root}: {name}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
