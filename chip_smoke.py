#!/usr/bin/env python3
"""On-card smoke run of samplenet_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a). It imports torch, numpy and the port, never
jax. It drives the port's two paths at 1024 -> 32 points, bottleneck 128,
B=1024: the serving path (the SampleNet eval forward with on-device hard
matching) and the classification-track train step (SampleNet, k=7,
sigma = t^2, against a frozen vanilla PointNet with 40 classes), and:

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
  9. times each kernel, the eval forward and the train step against the
     plain versions, per call with CUDA events and as device time with
     torch.profiler.

Tolerances of the train kernels against their plain versions: outputs and
batch statistics rtol = atol = 1e-4 (point_mlp_exact) and 1e-5 with idx
bit-equal (soft_projection); gradients rtol 1e-3 / atol 1e-5
(point_mlp_exact, at the ragged shape) and rtol 1e-4 / atol 1e-5
(soft_projection). At the train shape the exact-BN chain's lower-layer
gradients are sums over 1M points that BN's correction makes nearly
cancel, so neither f32 path holds an elementwise 1e-3 there; the kernel
is held instead to at least the plain f32 version's accuracy (within 2x)
against the plain version run in float64 on the card.

Any failure raises and exits non-zero; so does a run without CUDA or
outside a checkout. The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}, after the card's name and power limit.
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
# zero gradient in exact arithmetic: dense biases followed by BN, and the
# last conv BN's beta (a shift of every pooled feature that fc1's BN undoes)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}


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


def _mlp_weights(torch, rng, device):
    wbs = []
    for cin, cout in zip(WIDTHS[:-1], WIDTHS[1:]):
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


def _outside(a, b, rtol=1e-3, atol=1e-5) -> float:
    """Share of elements of a outside rtol/atol of b."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() > atol + rtol * b.abs()).double().mean())


def _no_worse_than_plain(name, k, p, ref) -> tuple[float, float]:
    """The kernel's error against the float64 reference, as a share of the
    reference's largest entry, is at most twice the plain f32 version's,
    or 1e-5 where both are below that."""
    ek, ep = _rel_err(k, ref), _rel_err(p, ref)
    if not ek <= max(2 * ep, 1e-5):
        raise AssertionError(f"{name}: kernel error {ek!r} of the f64 scale, "
                             f"plain f32 {ep!r}")
    return ek, ep


def _ctx(plain: bool):
    import contextlib

    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    return plain_on_cuda() if plain else contextlib.nullcontext()


def _exact_inputs(torch, rng, b, n):
    x = torch.from_numpy(rng.standard_normal((b, n, WIDTHS[0]))
                         .astype(np.float32)).to(DEVICE)
    groups = [[], [], [], []]          # weights, biases, gammas, betas
    for cin, cout in zip(WIDTHS[:-1], WIDTHS[1:]):
        vals = ((rng.standard_normal((cin, cout)) / np.sqrt(cin)),
                0.1 * rng.standard_normal(cout),
                1 + 0.1 * rng.standard_normal(cout),
                0.1 * rng.standard_normal(cout))
        for g, v in zip(groups, vals):
            g.append(torch.from_numpy(v.astype(np.float32)).to(DEVICE))
    g = torch.from_numpy(rng.standard_normal((b, WIDTHS[-1]))
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
    times = phase_times(torch, model, clouds, card)
    times.update(phase_times_train(torch, data, labels, classifier, card))
    counts = {**counts, **{k: train_counts[k] for k in TRAIN_KERNELS}}
    errs.update(train_errs)
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in {**KERNELS, **TRAIN_KERNELS}.items()]}
    log("done", f"all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
