#!/usr/bin/env python3
"""Where the soft-projection backward's time goes, and what its design
choices are worth, on the card: variants of csrc/soft_projection.cu, each
built into its own library, timed at the four paths' shapes.

    python3 tools/diagnostics/soft_projection_bwd_variants.py

Run it from the root of a checkout on the machine with the card. Each
variant is the checkout's source with one edit, compiled for k = 7 and
16 only into build/variants/ (gitignored):

- `kept`: the source as it is (4 idx loads a lane a round, at most 64
  registers: __launch_bounds__(256, 4));
- `u8`, `u16`: 8 or 16 idx loads a lane a round, with no register cap;
- `u8_cap`: 8 loads, at most 80 registers (__launch_bounds__(256, 3));
- `atomic_masks`: each in-range lane sets its own bit of its warp's mask
  for its point by an integer atomicOr, in place of __match_any_sync and
  one write by the group's lowest lane;
- `points_only`, `dsigma_only`: the d sigma^2 blocks, or the point
  blocks, return at once (the first kernel runs in both).

For each of chip_smoke.py's SOFT_SHAPES (on its `_soft_inputs`, seed as
tools/time_soft_projection.py) it checks that every whole variant gives
the package's bits under the planned launch, then prints each variant's
device ms a call under torch.profiler (both kernels, not the wrapper's sum
over B) under the plan and under other (span, threads).
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "variants")
CAP = "__launch_bounds__(kMaxPointThreads, 4)\nsoft_project_bwd_points"
LOADS = "constexpr int kUnroll = 4;"
MASKS = """      const unsigned peers = __match_any_sync(kFull, key);
      if (key >= 0 && (peers & below) == 0u) {
        mask[wid * span + key] = peers;
        atomicOr(hit + key, 1u << wid);  // a flag: the result is not read
      }"""
DSIGMA = "  if (range == ranges) {  // d sigma^2 of cloud b\n"
POINTS = "  const int entries = m * K;\n  const int round"


def variants(src: str) -> dict[str, str]:
    def edit(*pairs):
        out = src
        for old, new in pairs:
            if old not in out:
                raise RuntimeError(f"the source no longer holds {old!r}")
            out = out.replace(old, new)
        return re.sub(r"    case (\d+): return CALL\(\d+\); *\\\n",
                      lambda mo: mo.group(0) if mo.group(1) in ("7", "16")
                      else "", out)

    uncapped = (CAP, CAP.replace(", 4)", ")"))
    return {
        "kept": edit(),
        "u8": edit((LOADS, LOADS.replace("4", "8")), uncapped),
        "u16": edit((LOADS, LOADS.replace("4", "16")), uncapped),
        "u8_cap": edit((LOADS, LOADS.replace("4", "8")),
                       (CAP, CAP.replace(", 4)", ", 3)"))),
        "atomic_masks": edit(
            (MASKS, """      if (key >= 0) {
        atomicOr(mask + wid * span + key, 1u << lane);
        atomicOr(hit + key, 1u << wid);
      }"""),
            ("          unsigned mk = mask[w * span + pp];\n",
             "          unsigned mk = mask[w * span + pp];\n"
             "          mask[w * span + pp] = 0u;\n"),
            ("  for (int i = t; i < span; i += threads) hit[i] = 0u;",
             "  for (int i = t; i < (warps + 1) * span; i += threads) "
             "hit[i] = 0u;")),
        "points_only": edit((DSIGMA, DSIGMA + "    return;\n")),
        "dsigma_only": edit((POINTS, "  return;\n" + POINTS)),
    }


def build(nvcc: str, sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    os.makedirs(OUT, exist_ok=True)
    csrc = os.path.join(ROOT, "samplenet_tpu_torch", "csrc")
    jobs = {}
    for name, text in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"lib_{name}.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", "-I", csrc, "-o", lib, path]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-3000:]}")
        regs = sorted({int(r) for r in re.findall(
            r"Used (\d+) registers", err)})
        print(f"{name}: registers a thread across its kernels {regs}")
        cdll = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        cdll.snt_soft_project_bwd.argtypes = [*[p] * 10, *[i] * 7, p]
        cdll.snt_soft_project_bwd.restype = i
        libs[name] = cdll
    return libs


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
    from samplenet_tpu_torch.ops.cuda._build import find_nvcc, stream_handle

    with open(os.path.join(ROOT, "samplenet_tpu_torch", "csrc",
                           "soft_projection.cu")) as f:
        libs = build(find_nvcc(), variants(f.read()))
    card = cs.card_line()
    for i, (path, (b, n, m, k)) in enumerate(cs.SOFT_SHAPES.items()):
        rng = np.random.default_rng(cs.SEED + 41 + i)
        pts, qs, sigma, cot = cs._soft_inputs(torch, rng, b, n, m)
        sigma = sigma.reshape(1)
        idx = spk.soft_project_fwd_cuda(pts, qs, sigma, k)[1]
        f32 = dict(dtype=torch.float32, device=pts.device)
        out = (torch.empty_like(pts), torch.empty_like(qs),
               torch.empty((b,), **f32), torch.empty((b, k, m, 4), **f32),
               torch.empty((b, k, m, 2), **f32))
        want = spk.soft_project_bwd_cuda(pts, qs, sigma, idx, cot)
        plan = spk.bwd_plan(pts.device.index, b, n, m, k)

        def call(lib, plan):
            err = lib.snt_soft_project_bwd(
                pts.data_ptr(), qs.data_ptr(), sigma.data_ptr(),
                idx.data_ptr(), cot.data_ptr(), *(t.data_ptr() for t in out),
                b, n, m, k, plan.tile, plan.threads, plan.span,
                stream_handle(pts))
            if err:
                raise RuntimeError(f"CUDA error {err} under {plan}")

        for name, lib in libs.items():
            if not name.endswith("_only"):
                call(lib, plan)
                if not (torch.equal(out[0], want[0])
                        and torch.equal(out[1], want[1])
                        and torch.equal(out[2].sum().reshape(1), want[2])):
                    raise AssertionError(f"{name} differs at the {path}")
        for span, threads in dict.fromkeys(
                ((plan.span, plan.threads), (256, 64), (256, 256),
                 (512, 256), (1024, 256), (128, 128))):
            other = spp.BwdPlan(plan.tile, threads, span)
            row = []
            for name, lib in libs.items():
                ms = cs._device_ms(torch, lambda: call(lib, other), 10)
                row.append(f"{name} {ms!r}")
            print(f"{path} (B={b}, N={n}, M={m}, k={k}), span {span}, "
                  f"threads {threads}{' (the plan)' if other == plan else ''}"
                  f": " + ", ".join(row) + f" ({card})", flush=True)
        del pts, qs, cot, idx, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
