#!/usr/bin/env python3
"""Where pmt_bwd_dz_chunked's time goes, by variants of its source.

    python3 tools/diagnostics/dz_chunked_variants.py

Copies csrc/point_mlp_train.cu into the checkout's build/ directory once
per variant, changes one part of the chunked dz kernel in each copy by a
text substitution, builds them all at once (nvcc, sm_90a) and times each
on the card at chip_smoke.py's WIDE top layer (128 -> 1024, B=1024,
N=1024, the plan's chunks, random inputs): CUDA events over 5 launches
after one. The variants:

- "kernel": the source as it is;
- "no form": no dz formed (the product reads whatever dzs holds);
- "no product": dz formed and written, no dh_prev sums;
- "no dz store": dz formed into shared memory but not written to HBM;
- "no argmax": the top layer's dh taken as 0 (no reads of the pooled
  cotangent and its argmax);
- "stamps": clock64 stamps in block 0's thread 0: the cycles a chunk
  spends loading the chunk's constants and op(W)^T rows (with the
  barriers around them), forming dz, and in the product.

Then it times the kernel under chunks of 16 to 128 channels, and prints
the SASS instruction mix of its <8, 0> instantiation (cuobjdump). The
variants' times apart from the kernel's say what each part costs; none
of their outputs is meaningful.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORM = ("      form_dz<false, kMode>(a, a.z + p0 * cout, top ? nullptr : a.dh "
        "+ p0 * cout,\n                            cs, pcl, dzs, p0, np, c0, "
        "nc);\n")
PRODUCT = "        dz_product<kRP>(acc, wts, dzs, nc, cin_pad, i0, pp);\n"
STORE = "        a.dz[(p0 + p) * cout + og] = v[j];\n"
ARGMAX = ("          dhv[j] = __ldg(a.argmax + b * cout + og) == lp ? "
          "__ldg(a.g + b * cout + og)\n"
          "                                                         : 0.0f;\n",
          "          dhv[j] = 0.0f * lp;\n")
# clock64 stamps of block 0's thread 0 over its chunks, into g_stamps
STAMPS = [
    ("      if (c0 > 0) __syncthreads();  // the last chunk's product is done\n",
     "      long long t0 = clock64();\n"
     "      if (c0 > 0) __syncthreads();\n"),
    ("      load_wt_rows(wts, a, c0, c0 + nc);\n      __syncthreads();\n",
     "      load_wt_rows(wts, a, c0, c0 + nc);\n      __syncthreads();\n"
     "      long long t1 = clock64();\n"),
    ("      __syncthreads();  // the chunk's dz is complete\n",
     "      __syncthreads();\n      long long t2 = clock64();\n"),
    ("        dz_product<kRP>(acc, wts, dzs, nc, cin_pad, i0, pp);\n",
     "        dz_product<kRP>(acc, wts, dzs, nc, cin_pad, i0, pp);\n"
     "        if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "          long long t3 = clock64();\n"
     "          g_stamps[0] += t1 - t0; g_stamps[1] += t2 - t1;\n"
     "          g_stamps[2] += t3 - t2; g_stamps[7] += 1;\n"
     "        }\n"),
    ("namespace {\n",
     "__device__ long long g_stamps[8];\n"
     "extern \"C\" int dz_stamps(long long* out) {\n"
     "  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n"
     "}\n"
     "extern \"C\" int dz_stamps_reset() {\n"
     "  long long zero[8] = {};\n"
     "  return cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n"
     "}\n"
     "namespace {\n"),
]
STAMP_PARTS = ("constants and op(W)^T rows", "form dz", "product")
# name -> (text, what it becomes), or a list of them; None: as it is
VARIANTS = {"kernel": None, "no form": (FORM, ""), "no product": (PRODUCT, ""),
            "no dz store": (STORE, ""), "no argmax": ARGMAX, "stamps": STAMPS}


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan
    from samplenet_tpu_torch.ops.cuda._build import (
        CSRC,
        NVCC_FLAGS,
        find_nvcc,
        max_dynamic_smem,
    )

    if not torch.cuda.is_available():
        print("dz_chunked_variants: no CUDA device", file=sys.stderr)
        return 1
    src = (CSRC / "point_mlp_train.cu").read_text()
    out_dir = os.path.join(HERE, "build", "dz_chunked_variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def build(item):
        name, cut = item
        text = src
        for old, new in ([] if cut is None else
                         cut if isinstance(cut, list) else [cut]):
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new, 1)
        tag = name.replace(" ", "_")
        path = os.path.join(out_dir, f"{tag}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"{tag}.so")
        subprocess.run([nvcc, *flags, "-shared", "-I", str(CSRC), "-o", lib,
                        path], check=True, capture_output=True)
        return name, lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS.items()))

    b, n, widths = 1024, 1024, cs.WIDE
    cin, cout = widths[-2], widths[-1]
    rows = b * n
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    top = plan.plan_bwd(widths, 1, rows, sms, max_dynamic_smem(dev))[-1]
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    z = randn(rows, cout)
    mu, rstd = randn(1, cout), randn(1, cout).abs() + 0.5
    gamma, beta = randn(cout), randn(cout)
    r1, r2, rstd2 = randn(1, cout), randn(1, cout), rstd.clone()
    g = randn(b, cout)
    argmax = torch.randint(0, n, (b, cout), device=dev, generator=gen,
                           dtype=torch.int32)
    wt = randn(cout, top.cin_pad)
    dz = torch.empty(rows, cout, device=dev)
    dh_prev = torch.empty(rows, top.cin_pad, device=dev)
    bn = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (mu, rstd, gamma,
                                                         beta)))
    p, i = ctypes.c_void_p, ctypes.c_int
    card = cs.card_line()

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    def launcher(dll, oc, grid):
        fn = dll.snt_pmt_bwd_dz
        fn.argtypes = [p, ctypes.POINTER(p), p, p, p, i, i, p, p, p, p, i, p,
                       p, i, i, i, i, i, i, i, i, p]
        fn.restype = i

        def call():
            err = fn(z.data_ptr(), bn, rstd2.data_ptr(), r1.data_ptr(),
                     r2.data_ptr(), cout, 0, None, g.data_ptr(),
                     argmax.data_ptr(), wt.data_ptr(), top.cin_pad,
                     dz.data_ptr(), dh_prev.data_ptr(), 1, b, n, top.dz_rp,
                     oc, 0, oc, grid, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"chunks of {oc}: launch error {err}")

        return call

    for name, lib in libs.items():
        dll = ctypes.CDLL(lib)
        call = launcher(dll, top.dz_oc, top.dz_grid)
        ms = timed(call)
        if name == "stamps":
            st = (ctypes.c_longlong * 8)()
            dll.dz_stamps_reset()
            call()
            torch.cuda.synchronize()
            dll.dz_stamps(st)
            chunks = max(st[7], 1)
            print("pmt_bwd_dz_chunked, block 0's cycles a chunk: " + ", ".join(
                f"{part} {st[k] / chunks!r}"
                for k, part in enumerate(STAMP_PARTS))
                + f" ({chunks} chunks)", flush=True)
        print(f"pmt_bwd_dz_chunked, {name}: {ms!r} ms a launch ({cin} -> "
              f"{cout}, B={b}, N={n}, chunks of {top.dz_oc}, grid "
              f"{top.dz_grid}; {card})", flush=True)
    dll = ctypes.CDLL(libs["kernel"])
    smem_of = dll.snt_pmt_bwd_dz_smem
    smem_of.argtypes, smem_of.restype = [i, i, i, i, i, i], ctypes.c_size_t
    sweep = []
    for oc in (16, 32, 64, 96, 128):
        smem = smem_of(top.cin_pad, cout, oc, 0, oc, 0)
        if smem > max_dynamic_smem(dev):
            continue
        grid = min(rows // 64, plan.blocks_per_sm(smem, plan.DZ_THREADS)
                   * sms)
        sweep.append(f"{oc}: {timed(launcher(dll, oc, grid))!r}")
    print(f"pmt_bwd_dz_chunked by chunk (ms a launch): {', '.join(sweep)} "
          f"({card})", flush=True)
    for fname, code in cs._sass(nvcc, libs["kernel"]).items():
        if "pmt_bwd_dz_chunked_kernelILi8ELi0E" not in fname:
            continue
        mix: dict[str, int] = {}
        for _, ins in code:
            op = re.split(r"[\s;]", ins.strip().lstrip("@!P0123456789 "),
                          maxsplit=1)[0]
            key = (op if op.startswith(("FFMA", "LDS", "LD.", "LDG", "STS",
                                        "STG", "BAR"))
                   else "other")
            mix[key] = mix.get(key, 0) + 1
        print(f"SASS of pmt_bwd_dz_chunked_kernel<8, 0>: {len(code)} "
              f"instructions; " + ", ".join(f"{k} {v}" for k, v in
                                            sorted(mix.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
