"""The port's serving engine and HTTP daemon on the CPU.

BatchedSampler's padding and chunking, MicroBatcher's coalescing and
close(), and `samplenet_tpu_torch.serve` on --device cpu, port 0. The
daemon's answer must equal, byte for byte, a BatchedSampler of the same
shape on the same weights: both pad to max_batch, so every matmul sees
the same shape. Against the model's direct call on an unpadded batch,
the CPU matmul may pick another blocking, so that comparison allows
1e-5.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from samplenet_tpu_torch import serve
from samplenet_tpu_torch.models import SampleNet
from samplenet_tpu_torch.serving import BatchedSampler, MicroBatcher

torch.set_num_threads(1)

N, M = 64, 8


@pytest.fixture(scope="module")
def model():
    return SampleNet(M, 32, generator=torch.Generator().manual_seed(3)).eval()


def _clouds(n, seed):
    return np.random.RandomState(seed).randn(n, N, 3).astype(np.float32)


def test_batched_sampler_pads_and_chunks(model):
    sampler = BatchedSampler(model, max_batch=4, num_points=N, device="cpu")
    for b in (3, 4, 10):                   # padded, exact, chunked 4+4+2
        clouds = _clouds(b, b)
        got = sampler(clouds)
        assert got.shape == (b, M, 3) and got.dtype == np.float32
        with torch.no_grad():
            want = model(torch.from_numpy(clouds))[1].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        sampler.dispatch(_clouds(5, 0))
    with pytest.raises(ValueError):
        sampler.dispatch(np.zeros((2, N + 1, 3), np.float32))


class _RecordingSampler:
    """Stands in for BatchedSampler: records every dispatched batch size."""

    max_batch, num_points = 8, 4

    def __init__(self):
        self.sizes = []

    def dispatch(self, clouds):
        self.sizes.append(len(clouds))
        return clouds * 2.0

    def fetch(self, handle):
        return handle


def test_micro_batcher_coalesces_and_closes():
    rec = _RecordingSampler()
    batcher = MicroBatcher(rec, max_wait_ms=200)
    clouds = [np.full((4, 3), i, np.float32) for i in range(12)]
    futures = [batcher.submit(c) for c in clouds]
    outs = [f.result(timeout=10) for f in futures]
    for c, out in zip(clouds, outs):
        np.testing.assert_array_equal(out, c * 2.0)
    assert sum(rec.sizes) == 12 and len(rec.sizes) < 12
    assert max(rec.sizes) <= rec.max_batch
    batcher.close()
    assert not batcher._thread.is_alive()
    with pytest.raises(RuntimeError):
        batcher.submit(clouds[0])
    other = MicroBatcher(rec)
    with pytest.raises(ValueError):
        other.submit(np.zeros((5, 3), np.float32))
    other.close()
    assert not other._thread.is_alive()


@pytest.fixture(scope="module")
def daemon(model, tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "sampler.pth"
    torch.save(model.state_dict(), path)
    server, batcher = serve.main(
        ["--weights", str(path), "--device", "cpu", "--num-points", str(N),
         "--max-batch", "4", "--port", "0"], serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    batcher.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_healthz(daemon):
    with urllib.request.urlopen(f"http://127.0.0.1:{daemon}/healthz",
                                timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["num_points"] == N and meta["num_out_points"] == M
    assert meta["device"] == "cpu" and meta["kernel_launches"] == {}


def test_sample_bytes_equal_batched_sampler(daemon, model):
    clouds = _clouds(3, 7).astype("<f4")
    req = urllib.request.Request(f"http://127.0.0.1:{daemon}/sample",
                                 data=clouds.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
    direct = BatchedSampler(model, max_batch=4, num_points=N, device="cpu")
    assert body == direct(clouds).astype("<f4").tobytes()


def test_bad_body_rejected(daemon):
    req = urllib.request.Request(f"http://127.0.0.1:{daemon}/sample",
                                 data=b"123", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_cuda_device_without_card_raises(tmp_path, model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "sampler.pth"
    torch.save(model.state_dict(), path)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        serve.main(["--weights", str(path), "--device", "cuda", "--port",
                    "0"], serve_forever=False)
