#!/usr/bin/env python3
"""Time the per-point MLP kernels of a checkout on the card.

    python3 tools/time_exact_chain.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there),
prints the build's ptxas lines for the forward kernels (registers, spills)
and then, under TAG, each a median of 20 calls after 3 warm-ups, CUDA
events around each call, host time included:

- `point_mlp_max` at the serving path's shape (B=1024 clouds of 1024
  points, widths 3-64-64-64-128-128) and the eval forward with hard
  matching (SampleNet 1024 -> 32, chip_smoke.py's seeded model);
- point_mlp_exact_train_max at the classification train shape (B=1024,
  N=1024, widths 3-64-64-64-128-128) and the reconstruction track's (B=50,
  N=2048, widths 3-64-128-128-256-128): the forward, forward + backward,
  and the backward kernels alone (`point_mlp_exact_bwd_cuda` on a saved
  forward); then the forward's and the backward's device time under
  torch.profiler, split by pass (chip_smoke.py's `_pass_split`, read from
  this script's own checkout);
- the ghost chain (bf16, block 4) at the progressive step's shape (B=32,
  N=1024) and at the classification step's (B=1024, N=1024, the block
  `train_samplenet --fused-train` takes there): its forward and its
  backward per call, and their splits;
- for each train-chain shape, a digest (SHA-1) of the forward kernels'
  outputs (pooled, statistics, z, argmax) and of the backward kernels'
  gradients, and one of `point_mlp_max`'s output: equal digests from two
  checkouts mean bit-equal results; last, the digests chip_smoke.py's
  `wide` phase prints (`_chain_digests`, from this script's own
  chip_smoke.py), for the checkout's kernels;
- where the checkout has them, the bf16 modes: `point_mlp_max(...,
  bf16=True)` at the serving shape, and the exact chain's forward and
  backward kernels with bf16 at each train-chain shape, per call and
  split by pass;
- the wide chains (chip_smoke.py's WIDE at B=1024 and B=32, N=1024, and
  WIDE_AE at B=50, N=2048), whose top layer runs the chunked dz kernel:
  the f32 backward per call and its device time split by pass, the
  chunked layer's own device time a launch (the profiler's
  pmt_bwd_dz_chunked events) and, as a yardstick that
  computes less (dh_prev only, no dz), torch.matmul of dz and W^T in
  f32 (TF32 off); then, in backward modes 0 (the exact chain in f32), 1
  (the ghost chain in bf16, blocks of 4 clouds, 5 at B=50) and 2 (the
  exact chain in bf16), and in mode 0 under chunks of WIDE_OC_CAP
  channels, digests of the chunked layer's dz and dh_prev (the backward's
  first allocations of their shapes) and of the gradients.

To compare two checkouts on one card, run it four times in a row: A, B,
B, A.
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import sys

SHAPES = ((1024, 1024, (3, 64, 64, 64, 128, 128)),
          (50, 2048, (3, 64, 128, 128, 256, 128)))
GHOST = ((32, 1024, (3, 64, 64, 64, 128, 128), 4),
         (1024, 1024, (3, 64, 64, 64, 128, 128), 4))
WIDE_CHUNKED = "pmt_bwd_dz_chunked"
FWD_KERNELS = ("point_mlp_max", "pmt_dense")
TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TOOL_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    digest = cs._digest
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import point_mlp_max
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt
    from samplenet_tpu_torch.ops.cuda._build import library, library_path

    library()
    log = (library_path().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):        # each entry's properties follow it
        if "Compiling entry" in line and any(k in line for k in FWD_KERNELS):
            print(f"[{tag}] ptxas: " + " | ".join(
                ln.strip() for ln in log[i:i + 4]
                if "spill" in ln or "registers" in ln or "entry" in ln))
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).cuda()

    def median_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def inputs(b, n, widths):
        x = randn(b, n, widths[0]).requires_grad_()
        pairs = list(zip(widths[:-1], widths[1:]))
        params = ([randn(ci, co) / ci ** 0.5 for ci, co in pairs],
                  [0.1 * randn(co) for _, co in pairs],
                  [1 + 0.1 * randn(co) for _, co in pairs],
                  [0.1 * randn(co) for _, co in pairs])
        for group in params:
            for t in group:
                t.requires_grad_()
        return x, params, randn(b, widths[-1])

    y = randn(cs.B, cs.N, 3)
    wbs = cs._mlp_weights(torch, rng, "cuda")
    model = cs.make_model(torch, "cuda")
    clouds = randn(cs.B, cs.N, 3)

    def forward_eval():
        with torch.inference_mode():
            model(clouds)

    print(f"[{tag}] point_mlp_max B={cs.B}, N={cs.N}, widths {cs.WIDTHS}: "
          f"{median_ms(lambda: point_mlp_max(y, wbs))!r} ms per call; eval "
          f"forward + matching {median_ms(forward_eval)!r} ms per call; "
          f"bits {digest(point_mlp_max(y, wbs))}", flush=True)
    has_bf16 = "bf16" in inspect.signature(point_mlp_max).parameters
    if has_bf16:
        print(f"[{tag}] point_mlp_max bf16: "
              f"{median_ms(lambda: point_mlp_max(y, wbs, bf16=True))!r} ms "
              f"per call", flush=True)
    del model, clouds, y

    for b, n, widths in SHAPES:
        x, params, g = inputs(b, n, widths)
        ws, _, gs, bes = [[t.detach() for t in grp] for grp in params]
        xd = x.detach()

        def forward():
            with torch.no_grad():
                pme.point_mlp_exact_train_max(x, *params)

        def both():
            pooled, _, _ = pme.point_mlp_exact_train_max(x, *params)
            (pooled * g).sum().backward()

        saved = pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5)[3]

        def backward():
            pme.point_mlp_exact_bwd_cuda(xd, ws, gs, bes, saved, g)

        def fwd_kernels():
            pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5)

        layers = len(widths) - 1
        print(f"[{tag}] B={b}, N={n}, widths {widths}: forward "
              f"{median_ms(forward)!r} ms, forward + backward "
              f"{median_ms(both)!r} ms, backward {median_ms(backward)!r} ms; "
              f"forward {cs._pass_split(torch, fwd_kernels, 5, layers, cs.FWD_PASSES)}"
              f"; backward {cs._pass_split(torch, backward, 5, layers)}",
              flush=True)
        fwd = pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5)
        bwd = pme.point_mlp_exact_bwd_cuda(xd, ws, gs, bes, fwd[3], g)
        print(f"[{tag}] bits of B={b}, N={n}: forward {digest(fwd)}, "
              f"backward {digest(bwd)}", flush=True)
        if has_bf16:
            saved16 = pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5,
                                                   True)[3]
            def fwd16():
                pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5, True)

            def bwd16():
                pme.point_mlp_exact_bwd_cuda(xd, ws, gs, bes, saved16, g,
                                             True)

            print(f"[{tag}] B={b}, N={n} in bf16: forward kernels "
                  f"{median_ms(fwd16)!r} ms, backward kernels "
                  f"{median_ms(bwd16)!r} ms per call; forward "
                  f"{cs._pass_split(torch, fwd16, 5, layers, cs.FWD_PASSES)}"
                  f"; backward {cs._pass_split(torch, bwd16, 5, layers)}",
                  flush=True)
            del saved16
        del saved, fwd, bwd
        torch.cuda.empty_cache()

    for b, n, widths, bb in GHOST:
        x, params, g = inputs(b, n, widths)
        ws, _, gs, bes = [[t.detach() for t in grp] for grp in params]
        xd = x.detach()
        saved = pmt.point_mlp_train_fwd_cuda(xd, ws, gs, bes, 1e-5, bb,
                                             True)[3]

        def ghost_forward():
            pmt.point_mlp_train_fwd_cuda(xd, ws, gs, bes, 1e-5, bb, True)

        def ghost_backward():
            pmt.point_mlp_train_bwd_cuda(xd, ws, gs, bes, 1e-5, bb, True,
                                         saved, g)

        layers = len(widths) - 1
        print(f"[{tag}] ghost B={b}, N={n}, bf16, block {bb}: forward "
              f"{median_ms(ghost_forward)!r} ms per call; "
              f"{cs._pass_split(torch, ghost_forward, 5, layers, cs.FWD_PASSES)}"
              f"; backward {median_ms(ghost_backward)!r} ms per call; "
              f"{cs._pass_split(torch, ghost_backward, 5, layers)}",
              flush=True)
        if b == GHOST[0][0]:
            fwd = pmt.point_mlp_train_fwd_cuda(xd, ws, gs, bes, 1e-5, bb,
                                               True)
            bwd = pmt.point_mlp_train_bwd_cuda(xd, ws, gs, bes, 1e-5, bb,
                                               True, fwd[3], g)
            print(f"[{tag}] bits of the ghost chain: forward {digest(fwd)}, "
                  f"backward {digest(bwd)}", flush=True)
            del fwd, bwd
        del saved, x, params, g, ws, gs, bes, xd
        torch.cuda.empty_cache()
    print(f"[{tag}] chip_smoke.py's digests: {cs._chain_digests(torch)}",
          flush=True)
    wide_chains(torch, cs, tag, inputs, median_ms, digest)
    return 0


def wide_chains(torch, cs, tag, inputs, median_ms, digest) -> None:
    """The wide chains' backward: times, the chunked layer alone, and the
    digests of its dz and dh_prev in each backward mode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt

    def layer_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.self_device_time_total / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and WIDE_CHUNKED in e.name]
        return (sum(times) / len(times), len(times)) if times else (None, 0)

    def recorded(fn):
        made, real = [], torch.empty

        def empty(*args, **kwargs):
            t = real(*args, **kwargs)
            made.append(t)
            return t

        torch.empty = empty
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.empty = real
        return out, made

    def layer_bits(fn, rows, cout, cin_pad):
        out, made = recorded(fn)
        f32 = [t for t in made if t.dtype == torch.float32]
        dz = next(i for i, t in enumerate(f32) if tuple(t.shape) == (rows, cout))
        dh = next(t for t in f32[dz + 1:] if tuple(t.shape) == (rows, cin_pad))
        return f"dz {digest(f32[dz])}, dh_prev {digest(dh)}, gradients " \
               f"{digest(out)}"

    for name, b, n in (("WIDE", 1024, 1024), ("WIDE", 32, 1024),
                       ("WIDE_AE", 50, 2048)):
        widths = getattr(cs, name)
        x, params, g = inputs(b, n, widths)
        ws, _, gs, bes = [[t.detach() for t in grp] for grp in params]
        xd = x.detach()
        rows, cout, cin_pad = b * n, widths[-1], -(-widths[-2] // 4) * 4
        saved = pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5)[3]

        def backward(saved=saved, cap=None):
            kw = {} if cap is None else {"oc_cap": cap}
            return pme.point_mlp_exact_bwd_cuda(xd, ws, gs, bes, saved, g,
                                                **kw)

        layers = len(widths) - 1
        per_call = median_ms(backward)
        split = cs._pass_split(torch, backward, 5, layers)
        one, launches = layer_ms(backward)
        dz = torch.randn(rows, cout, device="cuda")
        wt = ws[-1]
        torch.backends.cuda.matmul.allow_tf32 = False
        mm = median_ms(lambda: torch.matmul(dz, wt.t()))
        del dz
        print(f"[{tag}] {name} B={b}, N={n}, widths {widths}: f32 backward "
              f"{per_call!r} ms per call; {split}; the chunked layer "
              f"{one!r} ms device a launch ({launches} launches in 5 "
              f"calls); torch.matmul dz W^T (f32, not the same function) "
              f"{mm!r} ms ({cs.card_line()})", flush=True)
        bits = [f"mode 0 {layer_bits(backward, rows, cout, cin_pad)}",
                f"mode 0 under chunks of {cs.WIDE_OC_CAP} "
                + layer_bits(lambda: backward(cap=cs.WIDE_OC_CAP), rows,
                             cout, cin_pad)]
        del saved
        saved16 = pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5,
                                               True)[3]
        bits.append("mode 2 " + layer_bits(
            lambda: pme.point_mlp_exact_bwd_cuda(xd, ws, gs, bes, saved16,
                                                 g, True),
            rows, cout, cin_pad))
        del saved16
        bb = 4 if b % 4 == 0 else 5
        ghost = pmt.point_mlp_train_fwd_cuda(xd, ws, gs, bes, 1e-5, bb,
                                             True)[3]
        bits.append(f"mode 1 (blocks of {bb}) " + layer_bits(
            lambda: pmt.point_mlp_train_bwd_cuda(xd, ws, gs, bes, 1e-5, bb,
                                                 True, ghost, g),
            rows, cout, cin_pad))
        del ghost, x, params, g, ws, gs, bes, xd
        torch.cuda.empty_cache()
        print(f"[{tag}] bits of the chunked layer of {name} B={b}: "
              + "; ".join(bits), flush=True)


if __name__ == "__main__":
    sys.exit(main())
