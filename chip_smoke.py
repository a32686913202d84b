#!/usr/bin/env python3
"""On-card smoke run of samplenet_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a). It imports torch, numpy and the port, never
jax. It drives the port's serving path, the SampleNet eval forward with
on-device hard matching at 1024 -> 32 points, bottleneck 128, B=1024, and:

  1. prints the card (nvidia-smi name and power limit), nvcc and triton;
  2. builds the three CUDA kernels from csrc/ and prints the build time;
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
  6. times each kernel and the forward against the plain versions, per
     call with CUDA events and as device time with torch.profiler.

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
KERNELS = {   # name -> (source, the Pallas entry point it replaces)
    "nn_direction": ("samplenet_tpu_torch/csrc/nn_direction.cu",
                     "samplenet_tpu/ops/pallas/chamfer_kernel.py:176"),
    "fps": ("samplenet_tpu_torch/csrc/fps.cu",
            "samplenet_tpu/ops/pallas/fps_kernel.py:230"),
    "point_mlp_max": ("samplenet_tpu_torch/csrc/point_mlp_max.cu",
                      "samplenet_tpu/ops/pallas/point_mlp_kernel.py:128"),
}


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
                 f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


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
    times = phase_times(torch, model, clouds, card)
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()]}
    log("done", f"all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
