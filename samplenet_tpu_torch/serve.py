"""Sampler serving daemon: HTTP front-end over the MicroBatcher engine.

Mirrors samplenet_tpu/serve.py:1-163 with the same wire format:

    python -m samplenet_tpu_torch.serve --weights sampler.pth \
        --device cuda --num-points 1024 --port 8471

  POST /sample   body = float32 little-endian bytes of shape [n, N, 3]
                 (n inferred from the byte length)
                 -> 200, body = float32 bytes of shape [n, m, 3]
  GET  /healthz  -> 200, JSON {model config, max_batch, requests_served,
                 device, kernel launch counts}

`--weights` is a reference-keyed SampleNet state_dict (.pth), with or
without the "sampler." prefix (interop/jax_import.py); the model's widths
and m are read off it. `--device cuda` needs a card and raises without
one: nothing carries on on the CPU. Each POSTed cloud is submitted to the
MicroBatcher alone, so clouds of concurrent clients share one dispatch.
`--artifact` and `--export-artifact` wait for a later slice.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from samplenet_tpu_torch.interop.jax_import import (
    infer_samplenet_config,
    load_sampler_weights,
)
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.ops.dispatch import launch_counts
from samplenet_tpu_torch.serving import BatchedSampler, MicroBatcher


def resolve_device(name: str) -> torch.device:
    """The serving device; raises where a CUDA device is asked for and
    there is none."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"serve: --device {name} but CUDA is not "
                             "available")
        # full f32 matmuls in the FC head, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise SystemExit(f"serve: unsupported --device {name}")
    return device


def load_model(path: str, device: torch.device
               ) -> tuple[SampleNet, dict]:
    """(eval SampleNet on `device`, its constructor config) from weights."""
    sd = load_sampler_weights(path)
    config = infer_samplenet_config(sd)
    net = SampleNet(**config, device=device)
    net.load_state_dict(sd)
    return net.eval(), config


def make_server(batcher, args, stats, config):
    num_points = args.num_points
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            with lock:
                served = stats["served"]
            body = json.dumps({
                "num_points": num_points,
                "num_out_points": config["num_out_points"],
                "bottleneck_size": config["bottleneck_size"],
                "max_batch": args.max_batch,
                "requests_served": served,
                "device": str(args.device),
                "kernel_launches": launch_counts(),
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/sample":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            item = num_points * 3 * 4
            if length == 0 or length % item:
                self.send_error(400, f"body must be n*{item} bytes "
                                     f"(float32 [n, {num_points}, 3])")
                return
            clouds = np.frombuffer(raw, "<f4").reshape(-1, num_points, 3)
            futures = [batcher.submit(c) for c in clouds]
            out = np.stack([f.result(timeout=60) for f in futures])
            body = out.astype("<f4").tobytes()
            with lock:
                stats["served"] += len(clouds)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((args.host, args.port), Handler)


def parse_args(argv=None):
    p = argparse.ArgumentParser("samplenet_tpu_torch.serve")
    p.add_argument("--weights", required=True,
                   help="SampleNet state_dict (.pth) with reference keys")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    return p.parse_args(argv)


def main(argv=None, *, serve_forever=True):
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    net, config = load_model(args.weights, args.device)
    sampler = BatchedSampler(net, max_batch=args.max_batch,
                             num_points=args.num_points, device=args.device)
    batcher = MicroBatcher(sampler, max_wait_ms=args.max_wait_ms)
    stats = {"served": 0}
    server = make_server(batcher, args, stats, config)
    print(f"serving sampler ({args.num_points}->{net.num_out_points}) on "
          f"{args.device} at {args.host}:{server.server_address[1]}",
          flush=True)
    if serve_forever:
        try:
            server.serve_forever()
        finally:
            batcher.close()
    return server, batcher


if __name__ == "__main__":
    main()
