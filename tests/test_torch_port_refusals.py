"""Inputs the JAX package takes that the port's kernels once refused, on
the CPU: the plans and routing that now take them.

- point_mlp_max at any number of layers: the plan refuses by shared
  memory alone (as VMEM bounds the TPU kernel), in f32 and bf16; a 9-layer
  PointMLP of the port (BN folded, the plain version here) against the
  JAX package's PointMLP with the fused Pallas kernel in interpret mode
  and against its XLA chain, from the same numpy weights, at rtol 1e-4 /
  atol 1e-5 (the layers' tolerance: the fold reorders f32 roundings);
- the EMD past 65,535 clouds: the chunks of clouds its wrapper launches;
- the soft projection's backward past 2^31 - 32,769 entries a cloud: the
  plan takes it, its point kernel counting entries in 64 bits;
- strided inputs: the 1-NN ops and point_mlp_max give the contiguous
  input's bits (on the card the kernels' entries make them contiguous).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.nn.layers import PointMLP as JaxPointMLP
from samplenet_tpu_torch.nn.layers import PointMLP
from samplenet_tpu_torch.ops.cuda import emd_kernel as ek
from samplenet_tpu_torch.ops.cuda import point_mlp_plan as mp
from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
from samplenet_tpu_torch.ops.cuda import (
    nn_direction,
    nn_snap,
    point_mlp_max,
)
from tests.test_torch_port_layers import _load, _random_bn

torch.set_num_threads(1)

H100_SMEM = 232448
DEEP = (64, 64, 64, 128, 64, 64, 96, 64, 128)      # 9 layers


@pytest.mark.parametrize("layers", [9, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_plan_max_takes_any_number_of_layers(layers, bf16):
    widths = (3,) + (64, 128) * (layers // 2) + (64,) * (layers % 2)
    assert len(widths) - 1 == layers > mp.PARAM_LAYERS
    plan = mp.plan_max(widths, H100_SMEM, bf16)
    assert plan is not None and plan.widths == widths
    assert plan.smem == mp.max_smem(widths, bf16) <= H100_SMEM
    # shared memory alone refuses: a deep chain with one layer too wide
    wide = widths[:-1] + (4096,) * 2
    assert mp.max_smem(mp.kernel_widths(wide), bf16) > H100_SMEM
    assert mp.plan_max(wide, H100_SMEM, bf16) is None


def test_deep_point_mlp_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(3, 160, 3).astype(np.float32)
    jm = JaxPointMLP(features=DEEP)
    v = _random_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])), 2)
    tm = _load(PointMLP(3, DEEP), v, conv=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pool_max=True).numpy()
    fused = JaxPointMLP(features=DEEP, use_pallas=True).apply(
        v, jnp.asarray(x), pool_max=True)                # interpreted kernel
    xla = jm.apply(v, jnp.asarray(x), pool_max=True)
    assert got.shape == (3, DEEP[-1])
    np.testing.assert_allclose(got, np.asarray(fused), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,want", [
    (65535, [(0, 65535)]),
    (65536, [(0, 65535), (65535, 65536)]),
    (131071, [(0, 65535), (65535, 131070), (131070, 131071)]),
    (1, [(0, 1)]),
])
def test_emd_launches_chunks_of_clouds(b, want):
    assert ek.MAX_CLOUDS == 65535
    assert ek.cloud_chunks(b) == want


@pytest.mark.parametrize("m,k", [(2**26, 32), (2**31, 1), (67108865, 32),
                                 (2**27, 17)])
def test_backward_plan_past_int_entries(m, k):
    """Past INT_ENTRIES entries a cloud the plan takes the shape, and the
    point kernel counts them in 64 bits; below, in int, as it did."""
    assert m * k > spp.INT_ENTRIES and spp.counts_in_64_bits(m, k)
    plan = spp.plan_bwd(1, 1024, m, k, sms=132)
    assert plan == spp.BwdPlan(tile=spp.MAX_TILE, threads=256, span=256,
                               count64=True)
    assert spp.bwd_smem(plan.threads, plan.span, m * k) <= H100_SMEM
    assert not spp.counts_in_64_bits(1024, 32)
    assert not spp.counts_in_64_bits(spp.INT_ENTRIES, 1)
    # the grids' limits stay: the JAX package shares them
    with pytest.raises(ValueError, match="grids"):
        spp.plan_bwd(2**31, 1024, 64, 16, sms=132)


def test_strided_inputs_give_the_contiguous_bits():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 90)).astype(
        np.float32)).transpose(1, 2)
    y = torch.from_numpy(rng.standard_normal((2, 70, 6)).astype(
        np.float32))[..., ::2]
    assert not x.is_contiguous() and not y.is_contiguous()
    for fn in (nn_direction, nn_snap):
        got, want = fn(x, y), fn(x.contiguous(), y.contiguous())
        assert all(torch.equal(a, c) for a, c in zip(got, want))
    wbs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((3, 16), (16,), (16, 8), (8,))]
    for bf16 in (False, True):
        assert torch.equal(point_mlp_max(x, wbs, bf16=bf16),
                           point_mlp_max(x.contiguous(), wbs, bf16=bf16))
