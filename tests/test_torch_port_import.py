"""The port stands alone: importing it pulls in no JAX and builds nothing,
and a tensor it cannot run raises instead of falling back."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import samplenet_tpu_torch
from samplenet_tpu_torch.ops import dispatch
from samplenet_tpu_torch.ops.cuda import (
    _build,
    chamfer_kernel,
    emd_kernel,
    fps_kernel,
    point_mlp_exact_kernel,
    point_mlp_kernel,
    point_mlp_train_kernel,
    soft_projection_kernel,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(samplenet_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "samplenet_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import samplenet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(samplenet_tpu_torch.__path__,
                                               "samplenet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from samplenet_tpu_torch.ops.cuda import _build
print(json.dumps({"modules": names, "loaded": sorted(sys.modules),
                  "lib": _build._lib is not None}))
"""


def test_import_pulls_in_no_jax_and_needs_no_nvcc():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)   # no nvcc reachable
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "samplenet_tpu_torch.serve" in out["modules"]
    assert "samplenet_tpu_torch.ops.cuda.fps_kernel" in out["modules"]
    for name in ("ops.cuda.emd_kernel", "models.autoencoder",
                 "train.reconstruction", "train.train_reconstruction",
                 "data.shapenet", "data.plyio",
                 "ops.cuda.point_mlp_train_kernel", "train.progressive",
                 "train.train_progressive"):
        assert f"samplenet_tpu_torch.{name}" in out["modules"]
    leaked = [m for m in out["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert leaked == []
    assert out["lib"] is False


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from) (jax|flax|optax|orbax|samplenet_tpu)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [str(f) for f in files if pattern.search(f.read_text())]
    assert hits == []


def test_other_devices_raise():
    x = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        dispatch.use_kernel(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        chamfer_kernel.nn_direction(x, x)


@pytest.mark.parametrize("module,call", [
    (chamfer_kernel, lambda x: chamfer_kernel.nn_direction(x, x)),
    (fps_kernel, lambda x: fps_kernel.fps(
        x, torch.zeros(2, 4, dtype=torch.int32),
        torch.ones(2, dtype=torch.int32), 4)),
    (point_mlp_kernel, lambda x: point_mlp_kernel.point_mlp_max(
        x, (torch.zeros(3, 4), torch.zeros(4)))),
    (point_mlp_exact_kernel,
     lambda x: point_mlp_exact_kernel.point_mlp_exact_train_max(
         x, [torch.zeros(3, 4)], *([torch.zeros(4)],) * 3)),
    (soft_projection_kernel, lambda x: soft_projection_kernel.soft_project(
        x, x[:, :2], torch.ones(()), 2)),
    (chamfer_kernel, lambda x: chamfer_kernel.nn_snap(x, x)),
    (point_mlp_train_kernel,
     lambda x: point_mlp_train_kernel.point_mlp_train_max(
         x, [torch.zeros(3, 4)], *([torch.zeros(4)],) * 3, block_b=1)),
    (emd_kernel, lambda x: emd_kernel.emd_cost(x, x[:, :4])),
    (emd_kernel, lambda x: emd_kernel.emd_cost_autograd(
        x.requires_grad_(True), x[:, :4])),
])
def test_wrappers_do_not_fall_back(module, call, monkeypatch):
    """Where dispatch picks the kernel, a wrapper that cannot launch it
    raises; it never returns the plain version's result instead."""
    monkeypatch.setattr(module, "use_kernel", lambda t: True)
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros(2, 8, 3))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert list(tmp_path.iterdir()) == []


_FAKE_NVCC = """#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.path.join(os.path.dirname(sys.argv[0]), "calls.jsonl"), "a") as f:
    f.write(json.dumps(args) + "\\n")
fail = os.environ.get("FAKE_NVCC_FAIL")
if fail and any(a.endswith(fail) for a in args):
    sys.exit(3)
open(args[args.index("-o") + 1], "w").close()
"""


@pytest.mark.parametrize("fail", [None, "soft_projection.cu"])
def test_build_compiles_each_source_apart_then_links(fail, tmp_path,
                                                     monkeypatch):
    """One nvcc -c per source (started together), then one -shared link of
    the objects; the objects are removed, and a failed compile raises and
    leaves no library."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", fail)
    sources = [str(s) for s in _build._sources()]
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed \\(3\\)"):
            _build.build()
    else:
        path, _ = _build.build()
        assert path == _build.library_path() and path.exists()
    calls = [json.loads(line) for line in
             (nvcc.parent / "calls.jsonl").read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    assert sorted(c[-1] for c in compiles) == sorted(sources)
    assert all(list(_build.NVCC_FLAGS) == c[:len(_build.NVCC_FLAGS)]
               for c in compiles)
    links = [c for c in calls if "-c" not in c]
    if fail:
        assert links == []
    else:
        objs = [c[c.index("-o") + 1] for c in compiles]
        assert len(links) == 1 and links[0][0] == "-shared"
        assert sorted(links[0][3:]) == sorted(objs)
    left = sorted(p.name for p in _build.library_path().parent.iterdir())
    assert left == (["build.log"] if fail else
                    ["build.log", _build.LIB_NAME])


def test_plain_on_cuda_scope_and_launch_counters():
    cpu = torch.zeros(1)
    assert dispatch.use_kernel(cpu) is False
    with dispatch.plain_on_cuda():
        assert dispatch._mode.plain_on_cuda
    assert not dispatch._mode.plain_on_cuda
    before = dispatch.launch_counts()
    try:
        dispatch.reset_launch_counts()
        dispatch.count_launch("k")
        dispatch.count_launch("k")
        assert dispatch.launch_counts() == {"k": 2}
        dispatch.reset_launch_counts()
        assert dispatch.launch_counts() == {}
    finally:
        for name, n in before.items():
            for _ in range(n):
                dispatch.count_launch(name)
