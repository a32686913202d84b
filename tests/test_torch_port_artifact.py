"""The port's serving artifact on the CPU: torch.export of the eval forward,
the versioned artifact file, ArtifactSampler and `serve --artifact`.

An exported and reloaded program runs the same ops on the same inputs as
the eager model, so on the same weights it must be bit-equal to a
BatchedSampler (both pad to the same batch). The clouds have N = 128
points, the least at which the eval chain is `point_mlp_max`
(nn/layers.py::use_eval_kernel), so that the program holds all three
samplenet:: ops. Against the JAX package's StableHLO artifact on weights
carried by `samplenet_state_dict_from_jax`: the simplified clouds at
rtol 1e-4 / atol 1e-5, the served points exactly on every cloud without a
near-tie (as tests/test_torch_port_samplenet.py).
"""

import io
import json
import struct
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models import SampleNet as JaxSampleNet
from samplenet_tpu.serving import load_stablehlo
from samplenet_tpu.serving import save_exported as jax_save_exported
from samplenet_tpu.serving import export_stablehlo
from samplenet_tpu_torch import serve
from samplenet_tpu_torch.interop import (
    infer_samplenet_config,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import SampleNet
from samplenet_tpu_torch.nn.layers import BatchNorm
from samplenet_tpu_torch.serving import (
    ARTIFACT_MAGIC,
    ArtifactSampler,
    BatchedSampler,
    export_program,
    load_exported,
    load_program,
    save_exported,
)
from tests.test_torch_port_samplenet import _near_tie

torch.set_num_threads(1)

B, N, M, BOTTLENECK = 4, 128, 8, 32
OPS = {"samplenet.point_mlp_max.default", "samplenet.nn_direction.default",
       "samplenet.fps.default"}


def _model(seed):
    """SampleNet(M, 32) from `seed`, its BN statistics perturbed so that
    eval BN is not the identity."""
    net = SampleNet(M, BOTTLENECK,
                    generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                for t in (mod.weight, mod.bias, mod.running_mean):
                    t.add_(torch.from_numpy(
                        0.1 * rng.randn(c).astype(np.float32)))
                mod.running_var.add_(torch.from_numpy(
                    np.abs(rng.randn(c)).astype(np.float32)))
    return net.eval()


@pytest.fixture(scope="module")
def model():
    return _model(3)


def _clouds(n, seed):
    return np.random.RandomState(seed).randn(n, N, 3).astype(np.float32)


def _direct(model, clouds):
    return BatchedSampler(model, max_batch=B, num_points=N,
                          device="cpu")(clouds)


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    path = tmp_path_factory.mktemp("artifact") / "sampler.sntpt"
    save_exported(str(path), model, batch=B, num_points=N,
                  freeze_params=True, device="cpu",
                  metadata={"num_out_points": M})
    return path


def _op_nodes(program) -> set[str]:
    return {str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("samplenet.")}


@pytest.mark.parametrize("b", [3, B, 10])          # padded, exact, chunked
def test_frozen_artifact_bit_equal_to_batched_sampler(artifact, model, b):
    sampler = ArtifactSampler(str(artifact))
    clouds = _clouds(b, b)
    got = sampler(clouds)
    assert got.shape == (b, M, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _direct(model, clouds))
    assert sampler.header["num_out_points"] == M
    assert sampler.header["device"] == "cpu"
    assert sampler.header["frozen_params"] is True
    assert sampler.header["torch_version"] == torch.__version__


def test_unfrozen_program_takes_any_weights(model):
    """Without freeze_params the program holds no weights and takes a
    state_dict: two models' weights through one program give each model's
    own BatchedSampler bits."""
    blob = export_program(model, batch=B, num_points=N, freeze_params=False,
                          device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    assert program.state_dict == {} and program.constants == {}
    fn = load_program(blob)
    clouds = _clouds(B, 1)
    other = _model(4)
    for net in (model, other):
        with torch.inference_mode():
            got = fn(dict(net.state_dict()), torch.from_numpy(clouds))
        np.testing.assert_array_equal(got.numpy(), _direct(net, clouds))


@pytest.mark.parametrize("freeze", [True, False])
def test_program_graph_holds_the_three_ops(model, freeze):
    blob = export_program(model, batch=B, num_points=N, freeze_params=freeze,
                          device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    assert _op_nodes(program) == OPS


def test_load_exported_returns_program_and_header(artifact, model):
    fn, header = load_exported(str(artifact))
    assert header["batch"] == B and header["num_points"] == N
    assert header["artifact_version"] == 1
    clouds = _clouds(B, 5)
    with torch.inference_mode():
        got = fn(torch.from_numpy(clouds)).numpy()
    np.testing.assert_array_equal(got, _direct(model, clouds))


def _rewrite(src, dst, *, magic=None, version=None, header=None):
    raw = src.read_bytes()
    off = len(ARTIFACT_MAGIC)
    v, hlen = struct.unpack_from("<II", raw, off)
    old = json.loads(raw[off + 8:off + 8 + hlen])
    hbytes = json.dumps({**old, **(header or {})}).encode()
    dst.write_bytes((magic or ARTIFACT_MAGIC)
                    + struct.pack("<II", version or v, len(hbytes)) + hbytes
                    + raw[off + 8 + hlen:])
    return str(dst)


def test_refuses_newer_version_and_bad_magic(artifact, tmp_path):
    newer = _rewrite(artifact, tmp_path / "v2.sntpt", version=2)
    with pytest.raises(ValueError, match="newer"):
        load_exported(newer)
    with pytest.raises(ValueError, match="newer"):
        ArtifactSampler(newer)
    bad = _rewrite(artifact, tmp_path / "bad.sntpt", magic=b"XXXXX")
    with pytest.raises(ValueError, match="not a samplenet_tpu_torch"):
        load_exported(bad)


def test_refuses_jax_artifact(tmp_path):
    net = JaxSampleNet(num_out_points=M, bottleneck_size=BOTTLENECK,
                       group_size=4)
    x = jnp.zeros((B, N, 3), jnp.float32)
    v = net.init(jax.random.PRNGKey(0), x, training=False)
    path = str(tmp_path / "jax.sntpu")
    jax_save_exported(path, net, v, batch=B, num_points=N,
                      freeze_params=True)
    with pytest.raises(ValueError, match="JAX package"):
        load_exported(path)
    with pytest.raises(ValueError, match="JAX package"):
        ArtifactSampler(path)


def test_artifact_sampler_refuses_unfrozen(model, tmp_path):
    path = str(tmp_path / "unfrozen.sntpt")
    save_exported(path, model, batch=B, num_points=N, freeze_params=False,
                  device="cpu")
    with pytest.raises(ValueError, match="without freeze_params"):
        ArtifactSampler(path)


def test_artifact_sampler_refuses_other_device(artifact, tmp_path,
                                               monkeypatch):
    with pytest.raises(ValueError, match="bound to its export device"):
        ArtifactSampler(str(artifact), "cuda")
    with pytest.raises(ValueError, match="not all on cuda"):
        export_program(_model(3), batch=B, num_points=N, device="cuda")
    on_card = _rewrite(artifact, tmp_path / "card.sntpt",
                       header={"device": "cuda:0"})
    with pytest.raises(ValueError, match="bound to its export device"):
        ArtifactSampler(on_card, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ArtifactSampler(on_card)


@pytest.fixture(scope="module")
def daemon(model, tmp_path_factory):
    """serve --export-artifact on weights, then serve --artifact on it."""
    tdir = tmp_path_factory.mktemp("serve")
    weights, art = tdir / "sampler.pth", tdir / "sampler.sntpt"
    torch.save(model.state_dict(), weights)
    assert serve.main(
        ["--weights", str(weights), "--device", "cpu", "--num-points",
         str(N), "--max-batch", str(B), "--export-artifact", str(art)],
        serve_forever=False) == (None, None)
    server, batcher = serve.main(
        ["--artifact", str(art), "--device", "cpu", "--port", "0"],
        serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    batcher.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_served_artifact_bytes_equal_batched_sampler(daemon, model):
    clouds = _clouds(3, 7).astype("<f4")
    req = urllib.request.Request(f"http://127.0.0.1:{daemon}/sample",
                                 data=clouds.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
    assert body == _direct(model, clouds).astype("<f4").tobytes()
    with urllib.request.urlopen(f"http://127.0.0.1:{daemon}/healthz",
                                timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["num_points"] == N and meta["num_out_points"] == M
    assert meta["max_batch"] == B and meta["bottleneck_size"] == BOTTLENECK
    assert meta["artifact"]["frozen_params"] is True
    assert meta["artifact"]["device"] == "cpu"
    assert meta["requests_served"] == 3


@pytest.mark.parametrize("argv,message", [
    ([], "exactly one of --weights / --artifact"),
    (["--weights", "w.pth", "--artifact", "a.sntpt"],
     "exactly one of --weights / --artifact"),
    (["--artifact", "a.sntpt", "--export-artifact", "b.sntpt"],
     "--export-artifact requires --weights"),
])
def test_serve_source_flags(argv, message):
    with pytest.raises(SystemExit, match=message):
        serve.main(argv + ["--device", "cpu"], serve_forever=False)


def test_artifact_matches_jax_artifact():
    """The port's artifact against the JAX package's on carried weights."""
    net = JaxSampleNet(num_out_points=M, bottleneck_size=BOTTLENECK,
                       group_size=4)
    x = _clouds(B, 11)
    v = net.init(jax.random.PRNGKey(1), jnp.asarray(x), training=False)
    rs = np.random.RandomState(2)
    bs = jax.tree_util.tree_map(
        lambda a: jnp.abs(a + 0.1 * rs.randn(*a.shape).astype(np.float32))
        + 0.5, v["batch_stats"])
    v = {"params": v["params"], "batch_stats": bs}
    want = np.asarray(load_stablehlo(export_stablehlo(
        net, v, batch=B, num_points=N, freeze_params=True))(jnp.asarray(x)))
    sd = samplenet_state_dict_from_jax(v)
    port = SampleNet(**infer_samplenet_config(sd), group_size=4)
    port.load_state_dict({k: torch.tensor(np.array(a)) for k, a in sd.items()})
    port.eval()
    got = load_program(export_program(port, batch=B, num_points=N,
                                      freeze_params=True, device="cpu"))
    with torch.inference_mode():
        got = got(torch.from_numpy(x)).numpy()
        simp = port.simplify(torch.from_numpy(x)).numpy()
    simp_j, _ = net.apply(v, jnp.asarray(x), training=False)
    np.testing.assert_allclose(simp, np.asarray(simp_j), rtol=1e-4,
                               atol=1e-5)
    idx = np.array([[np.flatnonzero((x[b] == p).all(-1))[0] for p in got[b]]
                    for b in range(B)])
    clear = ~_near_tie(x, simp, idx, M)
    assert clear.sum() >= 2
    np.testing.assert_array_equal(got[clear], want[clear])
