#!/usr/bin/env python3
"""On-card smoke run of samplenet_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a). It imports torch, numpy and the port, never
jax. It drives the port's three paths: the serving path (the SampleNet
eval forward with on-device hard matching, 1024 -> 32 points, bottleneck
128, B=1024), the classification-track train step (SampleNet, k=7,
sigma = t^2, against a frozen vanilla PointNet with 40 classes, B=1024),
and the reconstruction track at the reference AE configuration (2048-point
clouds, B=50; the AE 3->64->128->128->256->128 + FC 256->256->6144 on the
EMD loss; the reconstruction sampler, m=64, k=16, against it), and:

  1. prints the card (nvidia-smi name and power limit), nvcc and triton;
  2. builds the CUDA kernels from csrc/ and prints the build time;
  3. holds each kernel against its plain PyTorch version on the card, at
     the serving path's shapes and at a ragged shape: nn_direction and FPS
     bit for bit, point_mlp_max within rtol = atol = 1e-4 (f32 sums taken
     in another order);
  4. checks the eval forward of the kernel path against the plain path,
     then resets the launch counters, serves B=1024 clouds through
     BatchedSampler, and requires every kernel to have launched;
  5. starts `python -m samplenet_tpu_torch.serve` on port 0, posts 4
     concurrent requests (64 clouds) and requires answers bit-equal to a
     direct BatchedSampler call and kernel launches in the server;
  6. holds the train kernels against their plain versions: point_mlp_exact
     (exact-BN conv chain + max, forward and backward) and soft_projection
     (k-NN softmax mixture, forward and backward), at the train step's
     shapes and at ragged ones; both backward kernels bit for bit from run
     to run;
  7. runs one train step on the kernel path and on the plain path from
     the same state, holds both against the plain path in float64, then
     resets the launch counters, runs five augmented train steps and
     requires every train kernel, and nn_direction, to have launched;
  8. runs `python -m samplenet_tpu_torch.train.train_samplenet` for one
     epoch of 3 steps and again with --resume;
  9. (compare_recon) holds the EMD kernel against its plain version at
     B=50, 2048 x 2048 and at (n, m) = (96, 160), (128, 64), (2048, 64),
     with and without gradients, point_mlp_exact at the track's widths
     at B=50, N=2048, and through their own wrappers at the track's
     shapes point_mlp_max (B=50, 2048 points, its widths), fps (2048 ->
     64), nn_direction (64 -> 2048 and back) and soft_projection (k=16);
 10. (recon_train) runs one AE step and one sampler step on the kernel
     path, the plain path and the plain path in float64 from the same
     state, the SampleNet and FPS-baseline eval steps and evaluate_nre on
     the kernel and the plain path (per-cloud losses and NRE within rtol
     1e-4), then resets the launch counters, runs three AE steps, three
     sampler steps against the AE, one NRE evaluation and one FPS-baseline
     evaluation, and requires each of the track's kernels to have launched;
 11. (recon_cli) runs `python -m samplenet_tpu_torch.train.
     train_reconstruction` --phase ae (EMD loss), then --phase samplenet
     on its checkpoint with --fps-baseline;
 12. times each kernel, the eval forward and the train steps against the
     plain versions, per call with CUDA events and as device time with
     torch.profiler, and computes each kernel's bound from its inputs.

Tolerances of the train kernels against their plain versions: outputs and
batch statistics rtol = atol = 1e-4 (point_mlp_exact) and 1e-5 with idx
bit-equal (soft_projection); gradients rtol 1e-3 / atol 1e-5
(point_mlp_exact, at the ragged shape) and rtol 1e-4 / atol 1e-5
(soft_projection). At the train shape the exact-BN chain's lower-layer
gradients are sums over 1M points that BN's correction makes nearly
cancel, so neither f32 path holds an elementwise 1e-3 there; the kernel
is held instead to at least the plain f32 version's accuracy (within 2x)
against the plain version run in float64 on the card; at the
reconstruction track's B*N = 102400 points both f32 paths land about 1e-6
to 1e-4 of scale from f64, and per tensor either can be several times the
other, so there the floor under "2x" is 1e-4 of scale. The EMD kernel, as
tests/test_emd_kernel.py holds the TPU kernel: its cost within rtol 2e-4
of the plain version in float64, and each gradient no further from that
than 1.5x the plain f32 version's own error (or 5e-4 of its scale), by
the largest entry's error and norm-wise; where
the steep auction levels meet near-ties both f32 paths drift from the f64
match. The reconstruction steps: loss terms within rtol 2e-4 of the plain
path (EMD), every gradient's norm-wise error against the f64 path at most
twice the plain f32 path's (or 1e-4).

Any failure raises and exits non-zero; so does a run without CUDA or
outside a checkout. The last three lines are the kernels' JSON summary,
the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, M = 1024, 1024, 32                 # the serving path's shape
WIDTHS = (3, 64, 64, 64, 128, 128)       # per-point MLP at bottleneck 128
RAGGED_B, RAGGED_N, RAGGED_M = 3, 1000, 33
SEED = 0
DEVICE = "cuda"
K = 7                                    # the classification track's k
NUM_CLASSES = 40
TRAIN_STEPS = 5
KERNELS = {   # name -> (source, the Pallas entry point it replaces)
    "nn_direction": ("samplenet_tpu_torch/csrc/nn_direction.cu",
                     "samplenet_tpu/ops/pallas/chamfer_kernel.py:176"),
    "fps": ("samplenet_tpu_torch/csrc/fps.cu",
            "samplenet_tpu/ops/pallas/fps_kernel.py:230"),
    "point_mlp_max": ("samplenet_tpu_torch/csrc/point_mlp_max.cu",
                      "samplenet_tpu/ops/pallas/point_mlp_kernel.py:128"),
}
TRAIN_KERNELS = {  # forward and backward counted apart
    "point_mlp_exact_fwd": (
        "samplenet_tpu_torch/csrc/point_mlp_exact.cu",
        "samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499"),
    "point_mlp_exact_bwd": (
        "samplenet_tpu_torch/csrc/point_mlp_exact.cu",
        "samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499"),
    "soft_projection_fwd": (
        "samplenet_tpu_torch/csrc/soft_projection.cu",
        "samplenet_tpu/ops/pallas/soft_projection_kernel.py:161"),
    "soft_projection_bwd": (
        "samplenet_tpu_torch/csrc/soft_projection.cu",
        "samplenet_tpu/ops/pallas/soft_projection_kernel.py:161"),
}
RECON_KERNELS = {
    "emd": ("samplenet_tpu_torch/csrc/emd.cu",
            "samplenet_tpu/ops/pallas/emd_kernel.py:269"),
}
# zero gradient in exact arithmetic: dense biases followed by BN, and the
# last conv BN's beta (a shift of every pooled feature that fc1's BN undoes)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
# the reconstruction track (train/reconstruction.py:36-55, 141-156 of the
# JAX package): B=50 clouds of 2048 points, the AE's and the sampler's
# conv widths, m=64 sampled points, k=16
RECON_B, RECON_N, RECON_M, RECON_K = 50, 2048, 64, 16
RECON_WIDTHS = (3, 64, 128, 128, 256, 128)
RECON_STEPS = 3
RECON_PATH = ("emd", "point_mlp_exact_fwd", "point_mlp_exact_bwd",
              "point_mlp_max", "nn_direction", "fps", "soft_projection_fwd",
              "soft_projection_bwd")
# the card's published peaks (NVIDIA H100 SXM data sheet), and its
# special-function rate: 16 exp2 / rsqrt / rcp results
# per SM per clock on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OP_PER_S = 16 * 132 * 1.98e9


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ phases

def phase_env(torch) -> str:
    card = card_line()
    log("env", f"card: {card}")
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"cuda {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)}, "
               f"count {torch.cuda.device_count()}")
    from samplenet_tpu_torch.ops.cuda._build import find_nvcc

    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    log("env", f"nvcc {nvcc}: {ver[-1]}")
    try:
        import triton
        log("env", f"triton {triton.__version__} imports")
    except ImportError as exc:
        log("env", f"triton does not import ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", "TF32 off for matmul and cuDNN")
    return card


def phase_build() -> None:
    from samplenet_tpu_torch.ops.cuda import _build

    path, seconds = _build.build()
    log("build", f"{path.relative_to(HERE)} built from "
                 f"{[s.name for s in _build._sources()]} in {seconds:.1f} s "
                 f"(one nvcc {' '.join(_build.NVCC_FLAGS)} -c per source, "
                 f"all at once, then nvcc {' '.join(_build.LINK_FLAGS)})")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("build", line.strip())
    _build.library()


def _mlp_weights(torch, rng, device, widths=WIDTHS):
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        wbs += [torch.from_numpy(w).to(device), torch.from_numpy(b).to(device)]
    return tuple(wbs)


def _inputs(torch, rng, device, b, n, m):
    x = torch.from_numpy(rng.standard_normal((b, m, 3)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    given = torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32))
    count = torch.from_numpy(rng.integers(1, m + 1, b).astype(np.int32))
    return [t.to(device) for t in (x, y, given, count)]


def phase_compare(torch) -> dict[str, float]:
    """Kernel vs plain on the card; returns max |error| at the main shape."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        nn_direction_plain,
        point_mlp_max,
        point_mlp_max_plain,
    )

    rng = np.random.default_rng(SEED)
    errs = {}
    for label, (b, n, m) in (("main", (B, N, M)),
                             ("ragged", (RAGGED_B, RAGGED_N, RAGGED_M))):
        x, y, given, count = _inputs(torch, rng, DEVICE, b, n, m)
        dk, ik = nn_direction(x, y)
        dp, ip = nn_direction_plain(x, y)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
            raise AssertionError(
                f"nn_direction {label}: kernel != plain "
                f"({int((ik != ip).sum())} idx differ, max |d| "
                f"{float((dk - dp).abs().max())})")
        log("compare", f"nn_direction {label} x{tuple(x.shape)} "
                       f"y{tuple(y.shape)}: dist and idx bit-equal")

        ik2, xk = fps(y, given, count, m)
        ip2, xp = fps_plain(y, given, count, m)
        torch.cuda.synchronize()
        if not (torch.equal(ik2, ip2) and torch.equal(xk, xp)):
            raise AssertionError(
                f"fps {label}: kernel != plain "
                f"({int((ik2 != ip2).sum())} idx differ)")
        log("compare", f"fps {label} points{tuple(y.shape)} k={m}, count "
                       f"{int(count.min())}..{int(count.max())}: idx and "
                       f"xyz bit-equal")

        wbs = _mlp_weights(torch, rng, DEVICE)
        pk = point_mlp_max(y, wbs)
        pp = point_mlp_max_plain(y, wbs)
        torch.cuda.synchronize()
        torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
        err = float((pk - pp).abs().max())
        log("compare", f"point_mlp_max {label} x{tuple(y.shape)} widths "
                       f"{WIDTHS}: max |kernel - plain| {err!r} "
                       f"(rtol = atol = 1e-4)")
        if label == "main":
            errs = {"nn_direction": float((dk - dp).abs().max()),
                    "fps": float((xk - xp).abs().max()),
                    "point_mlp_max": err}
    return errs


def make_model(torch, device):
    """SampleNet(32, 128) with seeded weights and perturbed BN statistics,
    so eval BN is not the identity."""
    from samplenet_tpu_torch.models import SampleNet
    from samplenet_tpu_torch.nn.layers import BatchNorm

    net = SampleNet(num_out_points=M, bottleneck_size=128,
                    generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)

    def noise(c: int):
        return torch.from_numpy(
            (0.1 * rng.standard_normal(c)).astype(np.float32))

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.weight.add_(noise(c))
                mod.bias.add_(noise(c))
                mod.running_mean.add_(noise(c))
                mod.running_var.copy_((mod.running_var + noise(c)).abs() + 0.5)
    return net.to(device).eval()


def phase_end_to_end(torch, model, clouds) -> dict[str, int]:
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.fps import gather_point
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds
    from samplenet_tpu_torch.serving import BatchedSampler

    x = torch.from_numpy(clouds).to(DEVICE)
    with torch.inference_mode():
        simp_k, matched_k = model(x)
        pts_k, idx_k = nn_match_from_clouds(x, simp_k, M)
        with plain_on_cuda():
            simp_p = model.simplify(x)
            pts_p, idx_p = nn_match_from_clouds(x, simp_k, M)
    torch.cuda.synchronize()
    if simp_k.shape != (B, M, 3) or matched_k.shape != (B, M, 3) \
            or not bool(torch.isfinite(simp_k).all()):
        raise AssertionError(f"bad shapes or values: {simp_k.shape}, "
                             f"{matched_k.shape}")
    torch.testing.assert_close(simp_k, simp_p, rtol=1e-4, atol=1e-4)
    log("e2e", f"simplified [B={B}, {M}, 3]: kernel vs plain path max |d| "
               f"{float((simp_k - simp_p).abs().max())!r} (tol 1e-4)")
    if not (torch.equal(idx_k, idx_p) and torch.equal(pts_k, pts_p)
            and torch.equal(matched_k, pts_k)):
        raise AssertionError("matching: kernel path != plain matcher")
    if not torch.equal(gather_point(x, idx_k), pts_k):
        raise AssertionError("matched points are not the input's rows")
    uniq = min(len(torch.unique(r)) for r in idx_k.cpu())
    log("e2e", f"matched idx and points equal the plain matcher's on the "
               f"kernel path's simplified cloud; every matched point is an "
               f"input row; min unique per cloud {uniq}/{M}")
    # a simplified cloud whose second half repeats its first: the matcher
    # de-duplicates and the FPS kernel completes by argmax picks
    dup = torch.cat([simp_k[:, : M // 2], simp_k[:, : M // 2]], dim=1)
    with torch.inference_mode():
        pts_dk, idx_dk = nn_match_from_clouds(x, dup, M)
        with plain_on_cuda():
            pts_dp, idx_dp = nn_match_from_clouds(x, dup, M)
    if not (torch.equal(idx_dk, idx_dp) and torch.equal(pts_dk, pts_dp)):
        raise AssertionError("matching with FPS completion: kernel != plain")
    log("e2e", f"with {M // 2} duplicated simplified points per cloud, the "
               f"FPS-completed idx and points equal the plain matcher's")

    # the serving path itself, with the launch counters read around it
    sampler = BatchedSampler(model, max_batch=B, num_points=N, device=DEVICE)
    reset_launch_counts()
    served = sampler(clouds)
    torch.cuda.synchronize()
    counts = launch_counts()
    log("e2e", f"BatchedSampler(max_batch={B}) on {len(clouds)} clouds: "
               f"kernel launches {counts}")
    missing = [k for k in KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if not np.array_equal(served, matched_k.cpu().numpy()):
        raise AssertionError("BatchedSampler != direct forward")
    return counts


def _start_server(weights: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "samplenet_tpu_torch.serve", "--weights",
         weights, "--device", DEVICE, "--num-points", str(N), "--max-batch", "256",
         "--port", "0"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()

    def pump():  # keeps the pipe drained for the server's whole life
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + 180
    seen = []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        seen.append(line)
        if line.startswith("serving sampler"):
            return proc, int(line.rsplit(":", 1)[1])
    proc.kill()
    raise RuntimeError("serve did not start:\n" + "".join(seen[-40:]))


def phase_serve(torch, model, weights: str) -> None:
    from samplenet_tpu_torch.serving import BatchedSampler

    proc, port = _start_server(weights)
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        log("serve", f"GET /healthz: {meta}")
        rng = np.random.default_rng(SEED + 2)
        reqs = [rng.standard_normal((16, N, 3)).astype("<f4")
                for _ in range(4)]

        def post(c):
            req = urllib.request.Request(f"{base}/sample", data=c.tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return np.frombuffer(r.read(), "<f4").reshape(len(c), M, 3)

        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(post, reqs))
        direct = BatchedSampler(model, max_batch=256, num_points=N,
                                device=DEVICE)
        for i, (c, got) in enumerate(zip(reqs, answers)):
            if not np.array_equal(got, direct(c)):
                raise AssertionError(f"request {i}: served != direct")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        counts = meta["kernel_launches"]
        missing = [k for k in KERNELS if counts.get(k, 0) < 1]
        if missing or meta["requests_served"] != 64:
            raise AssertionError(f"server: missing {missing}, meta {meta}")
        log("serve", f"{len(reqs)} concurrent POST /sample, "
                     f"{sum(len(c) for c in reqs)} clouds: bit-equal to a "
                     f"direct BatchedSampler call; server kernel launches "
                     f"{counts}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pair_ms(torch, kernel_fn, plain_fn, iters):
    """Alternating plain, kernel, kernel, plain; mean of each pair."""
    p1 = _time_ms(torch, plain_fn, iters)
    k1 = _time_ms(torch, kernel_fn, iters)
    k2 = _time_ms(torch, kernel_fn, iters)
    p2 = _time_ms(torch, plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the CUDA kernels' own time under
    torch.profiler, free of the host's launch overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler now and then records no kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("torch.profiler recorded no device time, 3 times")


def _profile_top(torch, fn, iters: int, top: int = 8) -> str:
    """The `top` CUDA kernels by device time per call under torch.profiler,
    and the rest, as "name ms (share)"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / iters / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(ms for ms, _ in rows)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    parts = [f"{name[:60]} {ms!r} ms ({ms / total:.1%})"
             for ms, name in rows[:top]]
    rest = sum(ms for ms, _ in rows[top:])
    return (f"{total!r} ms device per call: " + "; ".join(parts)
            + f"; {len(rows) - top} other kernels {rest!r} ms "
              f"({rest / total:.1%})")


def phase_times(torch, model, clouds, card) -> dict[str, tuple]:
    """Per kernel and for the forward: CUDA-event time per call over
    back-to-back calls (what a caller pays, host launch time included where
    the host is the slower side) and device time from the profiler."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        nn_direction_plain,
        point_mlp_max,
        point_mlp_max_plain,
    )
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    rng = np.random.default_rng(SEED + 3)
    x, y, given, count = _inputs(torch, rng, DEVICE, B, N, M)
    wbs = _mlp_weights(torch, rng, DEVICE)
    cases = {
        "nn_direction": (lambda: nn_direction(x, y),
                         lambda: nn_direction_plain(x, y), 50),
        "fps": (lambda: fps(y, given, count, M),
                lambda: fps_plain(y, given, count, M), 20),
        "point_mlp_max": (lambda: point_mlp_max(y, wbs),
                          lambda: point_mlp_max_plain(y, wbs), 20),
    }
    times = {}
    for name, (kernel_fn, plain_fn, iters) in cases.items():
        times[name] = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        log("times", f"{name} at the main shape: kernel {times[name][0]!r} "
                     f"ms per call, {k_dev!r} ms device; plain "
                     f"{times[name][1]!r} ms per call, {p_dev!r} ms device "
                     f"({card})")
    xc = torch.from_numpy(clouds).to(DEVICE)

    def plain_forward():
        with plain_on_cuda():
            model(xc)

    with torch.inference_mode():
        k, p = _pair_ms(torch, lambda: model(xc), plain_forward, 10)
        k_dev = _device_ms(torch, lambda: model(xc), 10)
        p_dev = _device_ms(torch, plain_forward, 10)
    log("times", f"eval forward + matching, B={B}, {N}->{M}: kernel path "
                 f"{k!r} ms = {B / k * 1e3!r} clouds/s, {k_dev!r} ms device "
                 f"(busy {k_dev / k!r}); plain path {p!r} ms = "
                 f"{B / p * 1e3!r} clouds/s, {p_dev!r} ms device "
                 f"(busy {p_dev / p!r}) ({card})")
    return times


# --------------------------------------------------------- train path phases

def _rel_err(t, ref) -> float:
    """max |t - ref| / max |ref|, in float64."""
    ref = ref.double()
    return float((t.double() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30))


def _norm_err(t, ref) -> float:
    """|t - ref| / |ref| over the whole tensor, in float64."""
    ref = ref.double()
    return float((t.double() - ref).norm() / ref.norm().clamp_min(1e-30))


def _share_off(t, ref, frac=1e-3) -> float:
    """Share of entries further from ref than frac of ref's largest."""
    ref = ref.double()
    return float(((t.double() - ref).abs() > frac * ref.abs().max())
                 .double().mean())


def _outside(a, b, rtol=1e-3, atol=1e-5) -> float:
    """Share of elements of a outside rtol/atol of b."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() > atol + rtol * b.abs()).double().mean())


def _no_worse_than_plain(name, k, p, ref, floor=1e-5) -> tuple[float, float]:
    """The kernel's error against the float64 reference, as a share of the
    reference's largest entry, is at most twice the plain f32 version's,
    or `floor` where both are below that."""
    ek, ep = _rel_err(k, ref), _rel_err(p, ref)
    if not ek <= max(2 * ep, floor):
        raise AssertionError(f"{name}: kernel error {ek!r} of the f64 scale, "
                             f"plain f32 {ep!r}")
    return ek, ep


def _ctx(plain: bool):
    import contextlib

    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    return plain_on_cuda() if plain else contextlib.nullcontext()


def _exact_inputs(torch, rng, b, n, widths=WIDTHS):
    x = torch.from_numpy(rng.standard_normal((b, n, widths[0]))
                         .astype(np.float32)).to(DEVICE)
    groups = [[], [], [], []]          # weights, biases, gammas, betas
    for cin, cout in zip(widths[:-1], widths[1:]):
        vals = ((rng.standard_normal((cin, cout)) / np.sqrt(cin)),
                0.1 * rng.standard_normal(cout),
                1 + 0.1 * rng.standard_normal(cout),
                0.1 * rng.standard_normal(cout))
        for g, v in zip(groups, vals):
            g.append(torch.from_numpy(v.astype(np.float32)).to(DEVICE))
    g = torch.from_numpy(rng.standard_normal((b, widths[-1]))
                         .astype(np.float32)).to(DEVICE)
    return x, groups, g


def _exact_call(torch, x, groups, g, *, plain=False, dtype=None):
    """(pooled, stats, grads): grads are dx, then dW, d bias, d gamma,
    d beta per layer."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_train_max

    dtype = dtype or x.dtype
    x = x.to(dtype).clone().requires_grad_(True)
    groups = [[t.to(dtype).clone().requires_grad_(True) for t in grp]
              for grp in groups]
    with _ctx(plain):
        pooled, means, vars_ = point_mlp_exact_train_max(x, *groups)
    (pooled * g.to(dtype)).sum().backward()
    torch.cuda.synchronize()
    return (pooled.detach(), [*means, *vars_],
            [x.grad] + [t.grad for grp in groups for t in grp])


def _soft_inputs(torch, rng, b, n, m):
    pts, qs, cot = (torch.from_numpy(rng.standard_normal(shape)
                                     .astype(np.float32)).to(DEVICE)
                    for shape in ((b, n, 3), (b, m, 3), (b, m, 3)))
    return pts, qs, torch.tensor(0.7, device=DEVICE), cot


def _soft_call(torch, pts, qs, sigma, k, cot, *, plain=False):
    from samplenet_tpu_torch.ops.cuda import soft_project

    p, q, s = (t.clone().requires_grad_(True) for t in (pts, qs, sigma))
    with _ctx(plain):
        out, idx = soft_project(p, q, s, k)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), idx, [p.grad, q.grad, s.grad]


def phase_compare_train(torch) -> dict[str, float]:
    """The train kernels against their plain versions; returns max |error|
    at the train step's shapes."""
    rng = np.random.default_rng(SEED + 10)
    errs = {}
    nl = len(WIDTHS) - 1
    for label, (b, n) in (("main", (B, N)), ("ragged", (RAGGED_B, RAGGED_N))):
        x, groups, g = _exact_inputs(torch, rng, b, n)
        pk, sk, gk = _exact_call(torch, x, groups, g)
        pp, sp, gp = _exact_call(torch, x, groups, g, plain=True)
        torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
        for a, c in zip(sk, sp):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
        for grads in (gk, gp):
            if any(t.any() for t in grads[1 + nl:1 + 2 * nl]):
                raise AssertionError("a dense bias got a nonzero gradient")
        _, _, gk2 = _exact_call(torch, x, groups, g)
        if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
            raise AssertionError("point_mlp_exact backward is not "
                                 "deterministic")
        graded = [i for i in range(len(gk)) if not 1 + nl <= i < 1 + 2 * nl]
        if label == "ragged":
            for i in graded:
                torch.testing.assert_close(gk[i], gp[i], rtol=1e-3, atol=1e-5)
            log("compare", f"point_mlp_exact ragged x{tuple(x.shape)}: "
                           f"pooled, means, vars within 1e-4; dx, dW, "
                           f"dgamma, dbeta within rtol 1e-3 / atol 1e-5; "
                           f"dense-bias gradients 0; backward bit-equal "
                           f"across two runs")
            continue
        _, _, gr = _exact_call(torch, x, groups, g, plain=True,
                               dtype=torch.float64)
        worst = (0.0, 0.0)
        for i in graded:
            ek, ep = _no_worse_than_plain(f"point_mlp_exact grad {i}",
                                          gk[i], gp[i], gr[i])
            worst = max(worst, (ek, ep))
        log("compare", f"point_mlp_exact main x{tuple(x.shape)} widths "
                       f"{WIDTHS}: pooled max |k - p| "
                       f"{float((pk - pp).abs().max())!r}, stats within "
                       f"1e-4; gradients against the f64 plain version: "
                       f"worst kernel error {worst[0]!r} of scale (plain "
                       f"f32 {worst[1]!r}); elements outside rtol 1e-3 / "
                       f"atol 1e-5: kernel vs plain "
                       f"{max(_outside(gk[i], gp[i]) for i in graded)!r}"
                       f", plain f32 vs f64 "
                       f"{max(_outside(gp[i], gr[i]) for i in graded)!r}"
                       f"; dense-bias gradients 0; backward bit-equal")
        errs["point_mlp_exact_fwd"] = float((pk - pp).abs().max())
        errs["point_mlp_exact_bwd"] = max(
            float((gk[i] - gp[i]).abs().max()) for i in graded)

    for label, (b, n, m, k) in (("main", (B, N, M, K)),
                                ("ragged", (RAGGED_B, RAGGED_N, RAGGED_M,
                                            16))):
        pts, qs, sigma, cot = _soft_inputs(torch, rng, b, n, m)
        ok, ik, gk = _soft_call(torch, pts, qs, sigma, k, cot)
        op, ip, gp = _soft_call(torch, pts, qs, sigma, k, cot, plain=True)
        if not torch.equal(ik, ip):
            raise AssertionError(f"soft_projection {label}: idx differ in "
                                 f"{int((ik != ip).sum())} places")
        torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
        for a, c in zip(gk, gp):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        _, _, gk2 = _soft_call(torch, pts, qs, sigma, k, cot)
        if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
            raise AssertionError("soft_projection backward is not "
                                 "deterministic")
        log("compare", f"soft_projection {label} points{tuple(pts.shape)} "
                       f"queries{tuple(qs.shape)} k={k}: idx bit-equal, out "
                       f"max |k - p| {float((ok - op).abs().max())!r} "
                       f"(atol 1e-5), d points / d queries / d sigma^2 "
                       f"within rtol 1e-4 / atol 1e-5, backward bit-equal "
                       f"across two runs")
        if label == "main":
            errs["soft_projection_fwd"] = float((ok - op).abs().max())
            errs["soft_projection_bwd"] = max(
                float((a - c).abs().max()) for a, c in zip(gk, gp))
    return errs


def make_train_setup(torch):
    """The procedural data (B clouds of N points from SEED) and a seeded
    frozen vanilla PointNet(40)."""
    from samplenet_tpu_torch.data import make_dataset
    from samplenet_tpu_torch.models import PointNetClassifier

    data, labels = make_dataset(B, N, seed=SEED)
    classifier = PointNetClassifier(
        NUM_CLASSES, generator=torch.Generator().manual_seed(SEED + 5))
    return data, labels.astype(np.int64), classifier.to(DEVICE)


def _train_step(torch, classifier, *, dtype=None, augment=False):
    """A fresh sampler state from SEED and its train step; with `dtype`
    the sampler and a copy of the classifier run in that dtype."""
    import copy

    from samplenet_tpu_torch.train.classification import (
        SampleNetConfig,
        create_samplenet_state,
        make_samplenet_train_step,
    )

    scfg = SampleNetConfig(batch_size=B)
    net, state = create_samplenet_state(scfg, device=DEVICE, seed=SEED)
    if dtype is not None:
        net.to(dtype)             # in place: the optimiser keeps its params
        classifier = copy.deepcopy(classifier).to(dtype)
    step = make_samplenet_train_step(net, classifier, scfg,
                                     augment_data=augment)
    return net, state, step


def phase_train_step(torch, data, labels, classifier) -> dict[str, int]:
    """One step on the kernel path and on the plain path from the same
    state, both held against the plain path in float64; then the main
    path: TRAIN_STEPS augmented steps with the launch counters around."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    x = torch.from_numpy(data).to(DEVICE)
    y = torch.from_numpy(labels).to(DEVICE)
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("plain", True, None),
                               ("f64", True, torch.float64)):
        net, state, step = _train_step(torch, classifier, dtype=dtype)
        with _ctx(plain):
            metrics = step(state, x if dtype is None else x.to(dtype), y)
        torch.cuda.synchronize()
        runs[name] = (
            metrics,
            {k: p.grad.detach().clone() for k, p in net.named_parameters()},
            {k: v.detach().clone() for k, v in net.named_buffers()
             if "running_" in k})
        del net, state, step
    (mk, gk, sk), (mp, gp, sp), (_, gr, _) = (runs["kernel"], runs["plain"],
                                             runs["f64"])
    for k in ("loss", "task", "simplification", "projection"):
        if not bool(torch.isfinite(mk[k])):
            raise AssertionError(f"train step {k} is not finite")
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=0)
    scale = max(float(g.abs().max()) for g in gr.values())
    worst = (0.0, 0.0, "")
    for name in gk:
        if name in CANCELLED:
            for g in (gk[name], gp[name]):
                if float(g.abs().max()) > 1e-4 * scale:
                    raise AssertionError(f"{name}: gradient not round-off")
            if name.startswith("conv") and bool(gk[name].any()):
                raise AssertionError(f"{name}: kernel gradient is not 0")
            continue
        ek, ep = _no_worse_than_plain(name, gk[name], gp[name], gr[name])
        worst = max(worst, (ek, ep, name))
    for name in sk:
        torch.testing.assert_close(sk[name], sp[name], rtol=1e-3, atol=1e-5)
    log("train", f"one step at B={B}, {N}->{M}, k={K}, augmentation off: "
                 f"loss {float(mk['loss'])!r} (plain {float(mp['loss'])!r}); "
                 f"task, simplification, projection within rtol 1e-4; "
                 f"gradients against the f64 plain path: worst kernel "
                 f"error {worst[0]!r} of scale at {worst[2]} (plain f32 "
                 f"{worst[1]!r}); BN-cancelled gradients round-off, conv "
                 f"biases 0; new running stats within rtol 1e-3 / atol 1e-5")

    net, state, step = _train_step(torch, classifier, augment=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    reset_launch_counts()
    losses = [step(state, x, y, gen)["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or state.optimizer.count != TRAIN_STEPS:
        raise AssertionError(f"train steps: losses {losses}, applied "
                             f"{state.optimizer.count}")
    missing = [k for k in (*TRAIN_KERNELS, "nn_direction")
               if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the train path launched no {missing}")
    log("train", f"{TRAIN_STEPS} augmented steps on the kernel path: "
                 f"losses {losses}; kernel launches {counts}")
    return counts


def phase_train_cli(torch, classifier) -> None:
    """The train CLI on the card, then resumed from its snapshot."""
    with tempfile.TemporaryDirectory() as tmp:
        cls_path = os.path.join(tmp, "classifier.pth")
        torch.save({k: v.cpu() for k, v in classifier.state_dict().items()},
                   cls_path)
        log_dir = os.path.join(tmp, "log")
        cmd = [sys.executable, "-m", "samplenet_tpu_torch.train.train_samplenet",
               "--device", "cuda", "--dataset", "procedural", "--epochs", "1",
               "--steps-per-epoch", "3", "--train-size", "256",
               "--test-size", "64", "--classifier-weights", cls_path,
               "--log-dir", log_dir, "--seed", str(SEED)]
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        outs = []
        for extra in ([], ["--resume"]):
            t0 = time.monotonic()
            proc = subprocess.run(cmd + extra, cwd=HERE, env=env,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"train CLI {extra} exited "
                                   f"{proc.returncode}:\n"
                                   f"{(proc.stdout + proc.stderr)[-4000:]}")
            outs.append((proc.stdout, time.monotonic() - t0))
        acc = [line.split("eval_acc@32=")[1].split()[0]
               for line in outs[0][0].splitlines() if "eval_acc@32=" in line]
        if len(acc) != 1 or not np.isfinite(float(acc[0])):
            raise AssertionError(f"train CLI logged no eval_acc: {outs[0][0]}")
        for rel in ("snap_last/state.pt", "ckpt/sampler.pth"):
            if not os.path.exists(os.path.join(log_dir, rel)):
                raise AssertionError(f"train CLI wrote no {rel}")
        if "at epoch 1" not in outs[1][0]:
            raise AssertionError(f"--resume did not start at epoch 1: "
                                 f"{outs[1][0]}")
    log("train-cli", f"train_samplenet --device cuda, 1 epoch of 3 steps: "
                     f"exit 0 in {outs[0][1]:.1f} s, eval_acc@32={acc[0]}, "
                     f"snap_last and ckpt written; --resume started at "
                     f"epoch 1 (exit 0 in {outs[1][1]:.1f} s)")


def phase_times_train(torch, data, labels, classifier, card
                      ) -> dict[str, tuple]:
    """The train kernels fwd and bwd and the train step, each against the
    plain versions: CUDA-event time per call and profiler device time."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    rng = np.random.default_rng(SEED + 11)
    x, (ws, _, gs, bes), g = _exact_inputs(torch, rng, B, N)
    saved_k = pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5)[3]
    saved_p = pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5)[3]
    pts, qs, sigma, cot = _soft_inputs(torch, rng, B, N, M)
    sigma = sigma.reshape(1)
    idx_k = spk.soft_project_fwd_cuda(pts, qs, sigma, K)[1]
    cases = {
        "point_mlp_exact_fwd": (
            lambda: pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5),
            lambda: pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5), 10),
        "point_mlp_exact_bwd": (
            lambda: pme.point_mlp_exact_bwd_cuda(x, ws, gs, bes, saved_k, g),
            lambda: pme.point_mlp_exact_bwd_plain(x, ws, gs, bes, saved_p, g),
            10),
        "soft_projection_fwd": (
            lambda: spk.soft_project_fwd_cuda(pts, qs, sigma, K),
            lambda: spk.soft_project_fwd_plain(pts, qs, sigma, K), 20),
        "soft_projection_bwd": (
            lambda: spk.soft_project_bwd_cuda(pts, qs, sigma, idx_k, cot),
            lambda: spk.soft_project_bwd_plain(pts, qs, sigma, idx_k, cot),
            20),
    }
    times = {}
    for name, (kernel_fn, plain_fn, iters) in cases.items():
        times[name] = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        log("times", f"{name} at the train shape: kernel {times[name][0]!r} "
                     f"ms per call, {k_dev!r} ms device; plain "
                     f"{times[name][1]!r} ms per call, {p_dev!r} ms device "
                     f"({card})")
    del saved_k, saved_p

    xd = torch.from_numpy(data).to(DEVICE)
    yd = torch.from_numpy(labels).to(DEVICE)
    _, kstate, kstep = _train_step(torch, classifier, augment=True)
    _, pstate, pstep = _train_step(torch, classifier, augment=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def kernel_step():
        kstep(kstate, xd, yd, gen)

    def plain_step():
        with plain_on_cuda():
            pstep(pstate, xd, yd, gen)

    k, p = _pair_ms(torch, kernel_step, plain_step, 5)
    k_dev = _device_ms(torch, kernel_step, 3)
    p_dev = _device_ms(torch, plain_step, 3)
    log("times", f"train step, B={B}, {N}->{M}, k={K}, augmented: kernel "
                 f"path {k!r} ms = {B / k * 1e3!r} clouds/s, {k_dev!r} ms "
                 f"device (busy {k_dev / k!r}); plain path {p!r} ms = "
                 f"{B / p * 1e3!r} clouds/s, {p_dev!r} ms device (busy "
                 f"{p_dev / p!r}) ({card})")
    return times


# ------------------------------------------------- reconstruction track phases

def _randn(torch, rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(DEVICE)


def _emd_check(torch, label, x1, x2) -> float:
    """The EMD kernel against its plain version in f32 and f64; returns
    max |kernel - plain| over the cost and both gradients."""
    from samplenet_tpu_torch.ops.cuda import emd_cost, emd_cost_plain
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    ck, g1k, g2k = emd_cost(x1, x2)
    with plain_on_cuda():
        cp, g1p, g2p = emd_cost(x1, x2)
    cr, g1r, g2r = emd_cost_plain(x1.double(), x2.double())
    torch.cuda.synchronize()
    cost_k = float(((ck.double() - cr).abs() / cr.abs()).max())
    cost_p = float(((cp.double() - cr).abs() / cr.abs()).max())
    if not cost_k <= 2e-4:
        raise AssertionError(f"emd {label}: cost {cost_k!r} from f64 "
                             f"(plain f32 {cost_p!r}), above rtol 2e-4")
    grads = []
    for name, k, p, r in (("g1", g1k, g1p, g1r), ("g2", g2k, g2p, g2r)):
        ek, ep = _rel_err(k, r), _rel_err(p, r)
        nk, np_ = _norm_err(k, r), _norm_err(p, r)
        if not (ek <= max(1.5 * ep, 5e-4) and nk <= max(1.5 * np_, 5e-4)):
            raise AssertionError(f"emd {label} {name}: kernel error {ek!r} "
                                 f"of the f64 scale, {nk!r} of its norm; "
                                 f"plain f32 {ep!r}, {np_!r}")
        grads.append(f"{name} max {ek!r} / norm {nk!r} / share off "
                     f"{_share_off(k, r)!r} (plain {ep!r} / {np_!r} / "
                     f"{_share_off(p, r)!r})")
    c0, z1, z2 = emd_cost(x1, x2, with_grads=False)
    again = emd_cost(x1, x2)
    torch.cuda.synchronize()
    if not (torch.equal(c0, ck) and not z1.any() and not z2.any()):
        raise AssertionError(f"emd {label}: without gradients the cost "
                             f"differs or the gradients are not 0")
    if not all(torch.equal(a, c) for a, c in zip(again, (ck, g1k, g2k))):
        raise AssertionError(f"emd {label}: two runs differ")
    log("compare", f"emd {label} xyz1{tuple(x1.shape)} xyz2{tuple(x2.shape)}:"
                   f" cost rel err against f64 {cost_k!r} (plain f32 "
                   f"{cost_p!r}, rtol 2e-4); gradients against f64, max "
                   f"error as a share of the largest entry / norm-wise "
                   f"error / share of entries off by more than 1e-3 of the "
                   f"largest: {', '.join(grads)} (max and norm-wise: "
                   f"kernel <= 1.5x plain or 5e-4); cost bit-equal without "
                   f"gradients, gradients then 0; bit-equal across two runs")
    return max(float((a - c).abs().max())
               for a, c in ((ck, cp), (g1k, g1p), (g2k, g2p)))


def phase_compare_recon(torch) -> dict[str, float]:
    """The EMD kernel at the track's shape and at ragged ones, and the
    exact-BN chain at the track's widths, against their plain versions."""
    rng = np.random.default_rng(SEED + 20)
    errs = {}
    for label, (b, n, m) in (("main", (RECON_B, RECON_N, RECON_N)),
                             ("ragged", (3, 96, 160)),
                             ("n=2m", (3, 128, 64)),
                             ("2048x64", (3, 2048, 64))):
        err = _emd_check(torch, label, _randn(torch, rng, b, n, 3),
                         _randn(torch, rng, b, m, 3))
        if label == "main":
            errs["emd"] = err
        torch.cuda.empty_cache()
    x, groups, g = _exact_inputs(torch, rng, RECON_B, RECON_N, RECON_WIDTHS)
    nl = len(RECON_WIDTHS) - 1
    pk, sk, gk = _exact_call(torch, x, groups, g)
    pp, sp, gp = _exact_call(torch, x, groups, g, plain=True)
    _, _, gr = _exact_call(torch, x, groups, g, plain=True,
                           dtype=torch.float64)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    for a, c in zip(sk, sp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    worst = (0.0, 0.0)
    for i in range(len(gk)):
        if 1 + nl <= i < 1 + 2 * nl:
            if gk[i].any() or gp[i].any():
                raise AssertionError("a dense bias got a nonzero gradient")
            continue
        # floor 1e-4: at B*N = 102400 both f32 paths land about 1e-6 to
        # 1e-4 of scale from f64, either one ahead per tensor (PERF.md)
        worst = max(worst, _no_worse_than_plain(
            f"point_mlp_exact (recon widths) grad {i}", gk[i], gp[i], gr[i],
            floor=1e-4))
    _, _, gk2 = _exact_call(torch, x, groups, g)
    if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
        raise AssertionError("point_mlp_exact backward (recon widths) is "
                             "not deterministic")
    log("compare", f"point_mlp_exact x{tuple(x.shape)} widths {RECON_WIDTHS}"
                   f" (pme_bwd in input-channel slabs): pooled max |k - p| "
                   f"{float((pk - pp).abs().max())!r}, stats within 1e-4; "
                   f"gradients against the f64 plain version: worst kernel "
                   f"error {worst[0]!r} of scale (plain f32 {worst[1]!r}); "
                   f"dense-bias gradients 0; backward bit-equal")
    del x, groups, g, pk, pp, gk, gp, gr, gk2
    torch.cuda.empty_cache()
    _compare_recon_shapes(torch, rng)
    return errs


def _compare_recon_shapes(torch, rng) -> None:
    """point_mlp_max, fps, nn_direction and soft_projection through their
    own wrappers at the shapes the reconstruction path gives them, each
    against its plain version, with the tolerances of the serving and
    classification phases."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        nn_direction_plain,
        point_mlp_max,
        point_mlp_max_plain,
    )

    b, n, m, k = RECON_B, RECON_N, RECON_M, RECON_K
    q, pts, given, count = _inputs(torch, rng, DEVICE, b, n, m)
    wbs = _mlp_weights(torch, rng, DEVICE, RECON_WIDTHS)
    pk, pp = point_mlp_max(pts, wbs), point_mlp_max_plain(pts, wbs)
    torch.cuda.synchronize()
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    log("compare", f"point_mlp_max x{tuple(pts.shape)} widths {RECON_WIDTHS}"
                   f" (the AE encoder and the sampler at eval): max |kernel "
                   f"- plain| {float((pk - pp).abs().max())!r} (rtol = atol "
                   f"= 1e-4)")
    ik, xk = fps(pts, given, count, m)
    ip, xp = fps_plain(pts, given, count, m)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(xk, xp)):
        raise AssertionError(f"fps {n}->{m}: kernel != plain "
                             f"({int((ik != ip).sum())} idx differ)")
    log("compare", f"fps points{tuple(pts.shape)} k={m} (matching completion "
                   f"and the FPS baseline), count {int(count.min())}.."
                   f"{int(count.max())}: idx and xyz bit-equal")
    for a, c in ((q, pts), (pts, q)):
        dk, ik = nn_direction(a, c)
        dp, ip = nn_direction_plain(a, c)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
            raise AssertionError(
                f"nn_direction {a.shape[1]}->{c.shape[1]}: kernel != plain "
                f"({int((ik != ip).sum())} idx differ)")
    log("compare", f"nn_direction {m}->{n} and {n}->{m} at B={b} (the "
                   f"simplification loss, matching): dist and idx bit-equal")
    pts, qs, sigma, cot = _soft_inputs(torch, rng, b, n, m)
    ok, ik, gk = _soft_call(torch, pts, qs, sigma, k, cot)
    op, ip, gp = _soft_call(torch, pts, qs, sigma, k, cot, plain=True)
    if not torch.equal(ik, ip):
        raise AssertionError(f"soft_projection (recon): idx differ in "
                             f"{int((ik != ip).sum())} places")
    torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
    for a, c in zip(gk, gp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
    log("compare", f"soft_projection points{tuple(pts.shape)} queries"
                   f"{tuple(qs.shape)} k={k}: idx bit-equal, out max |k - p| "
                   f"{float((ok - op).abs().max())!r} (atol 1e-5), d points "
                   f"/ d queries / d sigma^2 within rtol 1e-4 / atol 1e-5")


def _recon_state(torch, which, ae=None, *, dtype=None):
    """A seeded AE (which="ae") or reconstruction sampler and its train
    step; with `dtype` the model (and a copy of the AE) runs in it."""
    import copy

    from samplenet_tpu_torch.train import reconstruction as rec

    if which == "ae":
        cfg = rec.AEConfig(loss="emd", batch_size=RECON_B)
        model, state = rec.create_ae_state(cfg, device=DEVICE, seed=SEED)
        if dtype is not None:
            model.to(dtype)
        return model, state, rec.make_ae_train_step(model, cfg)
    cfg = rec.SampleNetAEConfig(batch_size=RECON_B)
    model, state = rec.create_sampler_ae_state(cfg, device=DEVICE,
                                               seed=SEED + 1)
    if dtype is not None:
        model.to(dtype)
        ae = copy.deepcopy(ae).to(dtype)
    return model, state, rec.make_sampler_ae_train_step(model, ae, cfg,
                                                         "emd")


def _recon_step_check(torch, which, x, ae=None) -> str:
    """One step on the kernel path, the plain path and the plain path in
    f64 from the same seeded state."""
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("plain", True, None),
                               ("f64", True, torch.float64)):
        model, state, step = _recon_state(torch, which, ae, dtype=dtype)
        with _ctx(plain):
            out = step(state, x if dtype is None else x.to(dtype))
        torch.cuda.synchronize()
        metrics = out if isinstance(out, dict) else {"loss": out}
        runs[name] = (metrics, {k: p.grad.detach().clone()
                                for k, p in model.named_parameters()
                                if p.grad is not None})
        del model, state, step
    (mk, gk), (mp, gp), (_, gr) = runs["kernel"], runs["plain"], runs["f64"]
    for k in mk:
        if not bool(torch.isfinite(mk[k])):
            raise AssertionError(f"{which} step: {k} is not finite")
        torch.testing.assert_close(mk[k], mp[k], rtol=2e-4, atol=0)
    worst = (0.0, 0.0, "")
    for name, ref in gr.items():
        if not ref.any():       # conv biases before BN: 0 on every path
            if gk[name].any() or gp[name].any():
                raise AssertionError(f"{which} {name}: gradient not 0")
            continue
        ek, ep = _norm_err(gk[name], ref), _norm_err(gp[name], ref)
        if not ek <= max(2 * ep, 1e-4):
            raise AssertionError(f"{which} {name}: kernel error {ek!r} of "
                                 f"the f64 norm, plain f32 {ep!r}")
        worst = max(worst, (ek, ep, name))
    torch.cuda.empty_cache()
    return (f"{which} step: " + ", ".join(
        f"{k} {float(v)!r} (plain {float(mp[k])!r})" for k, v in mk.items())
        + f"; gradients' norm-wise error against f64: worst kernel "
          f"{worst[0]!r} at {worst[2]} (plain f32 {worst[1]!r})")


def _recon_eval_check(torch, data, x, ae) -> str:
    """The SampleNet and FPS-baseline eval steps, and evaluate_nre over
    both, on the kernel path and the plain path: per-cloud losses and NRE
    within rtol 1e-4 (point_mlp_max's f32 sums run in another order)."""
    from samplenet_tpu_torch.train import reconstruction as rec

    sampler, state, _ = _recon_state(torch, "sampler", ae)
    parts = []
    for name, step in (
            ("samplenet", rec.make_sampler_ae_eval_step(sampler, ae)),
            ("fps", rec.make_fps_ae_eval_step(ae, RECON_M))):
        runs = []
        for plain in (False, True):
            with _ctx(plain):
                losses = step(state, x)
                nre = rec.evaluate_nre(step, state, data, RECON_B,
                                       device=DEVICE)
            torch.cuda.synchronize()
            runs.append((losses, nre))
        (lk, nk), (lp, np_) = runs
        for a, c in zip(lk, lp):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=0)
        for key in nk:
            if not abs(nk[key] - np_[key]) <= 1e-4 * abs(np_[key]):
                raise AssertionError(f"{name} eval: {key} {nk[key]!r} on "
                                     f"the kernel path, {np_[key]!r} plain")
        diff = max(float(((a - c) / c).abs().max()) for a, c in zip(lk, lp))
        parts.append(f"{name}: per-cloud losses max rel diff {diff!r}, NRE "
                     f"{nk['nre']!r} (plain {np_['nre']!r})")
    return ("eval steps and evaluate_nre, kernel path vs plain path "
            "(rtol 1e-4): " + "; ".join(parts))


def make_recon_data(torch):
    from samplenet_tpu_torch.data import make_dataset

    data, _ = make_dataset(RECON_B, RECON_N, seed=SEED)
    return data, torch.from_numpy(data).to(DEVICE)


def phase_recon_train(torch, data, x) -> dict[str, int]:
    """Kernel vs plain vs f64 for one step of each phase; then the track's
    main path with the launch counters around it."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import reconstruction as rec

    log("recon", _recon_step_check(torch, "ae", x))
    ae, _, _ = _recon_state(torch, "ae")
    log("recon", _recon_step_check(torch, "sampler", x, ae=ae))
    log("recon", _recon_eval_check(torch, data, x, ae))

    reset_launch_counts()
    ae, ae_state, ae_step = _recon_state(torch, "ae")
    ae_losses = [ae_step(ae_state, x) for _ in range(RECON_STEPS)]
    sampler, s_state, s_step = _recon_state(torch, "sampler", ae)
    s_metrics = [s_step(s_state, x) for _ in range(RECON_STEPS)]
    nre = rec.evaluate_nre(rec.make_sampler_ae_eval_step(sampler, ae),
                           s_state, data, RECON_B, device=DEVICE)
    fps = rec.evaluate_nre(rec.make_fps_ae_eval_step(ae, RECON_M), s_state,
                           data, RECON_B, device=DEVICE)
    torch.cuda.synchronize()
    counts = launch_counts()
    ae_losses = [float(v) for v in ae_losses]
    s_losses = [float(m["loss"]) for m in s_metrics]
    values = ae_losses + s_losses + [nre["nre"], fps["nre"],
                                     nre["loss_full_mean"]]
    if not all(np.isfinite(values)) or ae_state.optimizer.count != RECON_STEPS \
            or s_state.optimizer.count != RECON_STEPS:
        raise AssertionError(f"recon path: AE losses {ae_losses}, sampler "
                             f"losses {s_losses}, NRE {nre}, FPS {fps}")
    missing = [k for k in RECON_PATH if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the reconstruction path launched no {missing}")
    log("recon", f"{RECON_STEPS} AE steps (EMD) at B={RECON_B}, "
                 f"{RECON_N} points: losses {ae_losses}; {RECON_STEPS} "
                 f"sampler steps against it (m={RECON_M}, k={RECON_K}): "
                 f"losses {s_losses}; NRE {nre['nre']!r}, FPS-baseline NRE "
                 f"{fps['nre']!r}; kernel launches {counts}")
    return counts


def phase_recon_cli(torch) -> None:
    """Both phases of the reconstruction CLI on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m",
            "samplenet_tpu_torch.train.train_reconstruction", "--device",
            "cuda", "--epochs", "1", "--steps-per-epoch", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        ae_dir, sn_dir = os.path.join(tmp, "ae"), os.path.join(tmp, "sn")
        runs = [("ae", ["--phase", "ae", "--loss", "emd", "--log-dir",
                        ae_dir]),
                ("samplenet", ["--phase", "samplenet", "--ae-ckpt",
                               os.path.join(ae_dir, "ckpt"), "--fps-baseline",
                               "--log-dir", sn_dir])]
        outs = {}
        for name, extra in runs:
            t0 = time.monotonic()
            proc = subprocess.run(base + extra, cwd=HERE, env=env,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"train_reconstruction --phase {name} "
                                   f"exited {proc.returncode}:\n"
                                   f"{(proc.stdout + proc.stderr)[-4000:]}")
            outs[name] = (proc.stdout, time.monotonic() - t0)
        for rel in ("ae/ckpt/ae.pth", "ae/ckpt/config.json",
                    "sn/ckpt/sampler.pth"):
            if not os.path.exists(os.path.join(tmp, rel)):
                raise AssertionError(f"the reconstruction CLI wrote no {rel}")
    ae_line = [ln for ln in outs["ae"][0].splitlines() if "epoch 0:" in ln]
    sn_lines = [ln for ln in outs["samplenet"][0].splitlines()
                if "| NRE=" in ln or "FPS baseline" in ln]
    if len(ae_line) != 1 or len(sn_lines) != 2 or "nan" in " ".join(
            ae_line + sn_lines):
        raise AssertionError(f"the reconstruction CLI logged: "
                             f"{outs['ae'][0]}\n{outs['samplenet'][0]}")
    log("recon-cli", f"--phase ae --loss emd: exit 0 in "
                     f"{outs['ae'][1]:.1f} s, {ae_line[0].split('] ')[-1]}; "
                     f"--phase samplenet --fps-baseline: exit 0 in "
                     f"{outs['samplenet'][1]:.1f} s, "
                     + "; ".join(ln.split("] ")[-1] for ln in sn_lines))


def phase_times_recon(torch, x, card) -> dict[str, tuple]:
    """On one line: the EMD kernel and the exact-BN chain at the track's
    shapes, and both train steps, each against the plain path."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda.emd_kernel import (
        emd_cost_cuda,
        emd_cost_plain,
    )
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    rng = np.random.default_rng(SEED + 21)
    x1 = _randn(torch, rng, RECON_B, RECON_N, 3)
    x2 = _randn(torch, rng, RECON_B, RECON_N, 3)
    parts, times = [], {}
    cases = {"emd": (lambda: emd_cost_cuda(x1, x2, True),
                     lambda: emd_cost_plain(x1, x2, True), 3)}
    xe, (ws, _, gs, bes), g = _exact_inputs(torch, rng, RECON_B, RECON_N,
                                            RECON_WIDTHS)
    saved_k = pme.point_mlp_exact_fwd_cuda(xe, ws, gs, bes, 1e-5)[3]
    saved_p = pme.point_mlp_exact_fwd_plain(xe, ws, gs, bes, 1e-5)[3]
    cases["point_mlp_exact_fwd (recon widths)"] = (
        lambda: pme.point_mlp_exact_fwd_cuda(xe, ws, gs, bes, 1e-5),
        lambda: pme.point_mlp_exact_fwd_plain(xe, ws, gs, bes, 1e-5), 10)
    cases["point_mlp_exact_bwd (recon widths)"] = (
        lambda: pme.point_mlp_exact_bwd_cuda(xe, ws, gs, bes, saved_k, g),
        lambda: pme.point_mlp_exact_bwd_plain(xe, ws, gs, bes, saved_p, g),
        10)
    exact_fwd, exact_bwd = _exact_bounds(RECON_B, RECON_N, RECON_WIDTHS)
    bounds = [_emd_bound(RECON_B, RECON_N, RECON_N), exact_fwd, exact_bwd]
    for (name, (kernel_fn, plain_fn, iters)), bound in zip(cases.items(),
                                                           bounds):
        k, p = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        times[name] = (k, p)
        parts.append(f"{name}: kernel {k!r} ms per call, {k_dev!r} ms "
                     f"device; plain {p!r} ms, {p_dev!r} ms device; bound "
                     f"{bound[0]!r} ms ({bound[1]})")
    del saved_k, saved_p
    torch.cuda.empty_cache()
    steps = {}
    for which in ("ae", "sampler"):
        ae = None if which == "ae" else _recon_state(torch, "ae")[0]
        _, kstate, kstep = _recon_state(torch, which, ae)
        _, pstate, pstep = _recon_state(torch, which, ae)

        def kernel_step(kstep=kstep, kstate=kstate):
            kstep(kstate, x)

        def plain_step(pstep=pstep, pstate=pstate):
            with plain_on_cuda():
                pstep(pstate, x)

        k, p = _pair_ms(torch, kernel_step, plain_step, 3)
        k_dev = _device_ms(torch, kernel_step, 3)
        p_dev = _device_ms(torch, plain_step, 3)
        steps[which] = (k, p)
        log("profile", f"{which} train step, kernel path: "
                       f"{_profile_top(torch, kernel_step, 3)} ({card})")
        parts.append(
            f"{which} train step, B={RECON_B}, {RECON_N} points, EMD: kernel "
            f"path {k!r} ms = {RECON_B / k * 1e3!r} clouds/s, {k_dev!r} ms "
            f"device (busy {k_dev / k!r}); plain path {p!r} ms = "
            f"{RECON_B / p * 1e3!r} clouds/s, {p_dev!r} ms device (busy "
            f"{p_dev / p!r})")
        torch.cuda.empty_cache()
    log("times-recon", " | ".join(parts) + f" ({card})")
    return {"emd": times["emd"]}


# -------------------------------------------------------------- the bounds

def _bound(nbytes: float, *ops: tuple[float, float]) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and each type's operations over that type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(count / rate for count, rate in ops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _exact_bounds(b: int, n: int, widths) -> tuple[tuple, tuple]:
    """Bounds of the exact-BN chain's forward and backward over B*N points:
    2 (forward) or 4 (backward: dW and dh) FLOP per multiply-add, and BN,
    ReLU and statistics per channel; x and the parameters in, the pooled
    features and statistics (forward) or dx and the parameters' gradients
    (backward) out."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = sum(a * c for a, c in pairs)
    params = sum(a * c + 4 * c for a, c in pairs)
    chans = sum(widths[1:])
    p, f = b * n, 4
    return (_bound(f * (p * widths[0] + params + b * widths[-1] + 2 * chans),
                   (p * (2.0 * macs + 7 * chans), FP32_FLOP_PER_S)),
            _bound(f * (2 * p * widths[0] + 2 * params + b * widths[-1]),
                   (p * (4.0 * macs + 12 * chans), FP32_FLOP_PER_S)))


def _emd_bound(b: int, n: int, m: int) -> tuple[float, str]:
    """What the function needs, each level's arithmetic once per pair (an
    FMA counts 2 FLOP): d2 (8 FLOP) and one rsqrt giving d and 1/d (1 SFU
    op, 1 FLOP) per pair; per pair and level L != 0 (10 levels), one exp
    (1 SFU op) and 24 FLOP: L * d2, * satr, the row sum, * satl / rowsum,
    the column sum, * ratio, the row sum of the level's mass, the cost
    (FMA), u = wr / d, the sums of u over the row and the column and of u
    times the other cloud's xyz (6 FMA); level 0 needs no exp and no
    product with L or satr (22 FLOP). The clouds in, the cost and both
    gradients out."""
    pairs = b * n * m
    flop = 8 + 1 + 10 * 24 + 22
    return _bound(4 * (2 * b * (n + m) * 3 + b),
                  (flop * float(pairs), FP32_FLOP_PER_S),
                  (11.0 * pairs, SFU_OP_PER_S))


def kernel_bounds() -> dict[str, tuple[float, str]]:
    """Each kernel's bound at the shapes its times are taken at: each
    input read once, each output written once, and the operations the
    algorithm needs on these inputs (FP32 on the SIMT pipes; the EMD's
    exp and rsqrt on the special-function units)."""
    f = 4                                          # bytes of f32 and i32
    exact_fwd, exact_bwd = _exact_bounds(B, N, WIDTHS)
    pairs = list(zip(WIDTHS[:-1], WIDTHS[1:]))
    macs = sum(a * c for a, c in pairs)
    params = sum(a * c + c for a, c in pairs)
    return {
        # M queries against N points: 3 sub, 3 mul, 2 add, 1 compare
        "nn_direction": _bound(f * (B * M * 3 + B * N * 3 + 2 * B * M),
                               (9.0 * B * M * N, FP32_FLOP_PER_S)),
        # M picks, each updating N min-distances and an argmax
        "fps": _bound(f * (B * N * 3 + B * M * 2 + B + B * M * 3),
                      (10.0 * B * M * N, FP32_FLOP_PER_S)),
        "point_mlp_max": _bound(
            f * (B * N * 3 + params + B * WIDTHS[-1]),
            (B * N * (2.0 * macs + 3 * sum(WIDTHS[1:])), FP32_FLOP_PER_S)),
        "point_mlp_exact_fwd": exact_fwd,
        "point_mlp_exact_bwd": exact_bwd,
        "soft_projection_fwd": _bound(
            f * (B * N * 3 + 2 * B * M * 3 + B * M * K + 1),
            (9.0 * B * M * N + 20.0 * B * M * K, FP32_FLOP_PER_S)),
        "soft_projection_bwd": _bound(
            f * (2 * B * N * 3 + 3 * B * M * 3 + B * M * K + 2),
            (40.0 * B * M * K, FP32_FLOP_PER_S)),
        "emd": _emd_bound(RECON_B, RECON_N, RECON_N),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import samplenet_tpu_torch

    pkg = os.path.dirname(os.path.abspath(samplenet_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"run chip_smoke.py from a checkout: "
                           f"samplenet_tpu_torch came from {pkg}")
    t0 = time.monotonic()
    card = phase_env(torch)
    phase_build()
    errs = phase_compare(torch)
    model = make_model(torch, DEVICE)
    clouds = np.random.default_rng(SEED + 4).standard_normal(
        (B, N, 3)).astype(np.float32)
    counts = phase_end_to_end(torch, model, clouds)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "sampler.pth")
        torch.save({f"sampler.{k}": v.cpu() for k, v in
                    model.state_dict().items()}, weights)
        phase_serve(torch, model, weights)
    train_errs = phase_compare_train(torch)
    data, labels, classifier = make_train_setup(torch)
    train_counts = phase_train_step(torch, data, labels, classifier)
    phase_train_cli(torch, classifier)
    errs.update(phase_compare_recon(torch))
    recon_data, recon_x = make_recon_data(torch)
    recon_counts = phase_recon_train(torch, recon_data, recon_x)
    phase_recon_cli(torch)
    times = phase_times(torch, model, clouds, card)
    times.update(phase_times_train(torch, data, labels, classifier, card))
    times.update(phase_times_recon(torch, recon_x, card))
    counts = {**counts, **{k: train_counts[k] for k in TRAIN_KERNELS},
              **{k: recon_counts[k] for k in RECON_KERNELS}}
    errs.update(train_errs)
    bounds = kernel_bounds()
    # no single PyTorch call computes any of these functions (a distance
    # matrix, a top-k or a matmul is one step of each), so library_ms is null
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, (src, rep) in {**KERNELS, **TRAIN_KERNELS,
                                 **RECON_KERNELS}.items()]}
    log("done", f"all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
