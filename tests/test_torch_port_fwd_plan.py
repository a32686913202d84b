"""The forward kernels' launch plans (`samplenet_tpu_torch/ops/cuda/
point_mlp_plan.py`) and the 3xTF32 arithmetic of point_mlp_max's
tensor-core tile (`csrc/mma_tile.cuh`), on the CPU.

The plans are pure Python, and the CUDA wrappers check on the card that
pmt_dense and point_mlp_max count shared memory as they do. Over every
width set the port runs (the classification sampler, bottleneck 64, the
reconstruction AE encoder and sampler, and a 3-12-20 chain whose widths
are not multiples of the K step), on an H100 (232,448 bytes of shared
memory per block): both kernels fit and leave room for at least two blocks
per SM. Every width the earlier kernels took (their shared memory: two
[c_max, 68] float buffers for point_mlp_max, [cin + cout, 68] floats and
2 cout doubles for pmt_dense) is still taken, and what they refused for
its size is still refused. An output width that is not a multiple of 4
(a bottleneck of 130) plans at the next multiple of 4, which the wrappers
pad it to; a bottleneck of 1024 plans too.

The tile splits each f32 operand v into hi = tf32(v) and lo = tf32(v - hi)
as cvt.rna rounds (to nearest, ties away from zero, to 10 mantissa bits)
and sums a_lo*b_hi + a_hi*b_lo + a_hi*b_hi per K step of 8, then adds the
step into the f32 accumulator. The emulation below rounds by bit
arithmetic on an int32 view (TF32 products are exact in f32) at the
classification and reconstruction layer shapes: the tile's three products
land within 2x of the plain f32 matmul's error against float64, by the
largest entry and norm-wise, and one TF32 product (the control) does not.
"""

import numpy as np
import pytest
import torch

from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan

H100_SMEM = 232448
WIDTH_SETS = {
    "classification": (3, 64, 64, 64, 128, 128),
    "bottleneck 64": (3, 64, 64, 64, 128, 64),
    "reconstruction AE encoder and sampler": (3, 64, 128, 128, 256, 128),
    "3-12-20": (3, 12, 20),
    "bottleneck 130": (3, 64, 64, 64, 128, 130),
    "bottleneck 1024": (3, 64, 64, 64, 128, 1024),
}
PAIRS = sorted({p for w in WIDTH_SETS.values() for p in zip(w[:-1], w[1:])})


def _old_max_smem(widths) -> int:
    """The SIMT point_mlp_max's shared memory: two [c_max, 68] buffers and
    the per-channel max."""
    return 4 * (2 * max(widths) * 68 + widths[-1])


def _old_dense_smem(cin: int, cout: int) -> int:
    """The SIMT pmt_dense's shared memory: [cin + cout, 68] floats and the
    f64 sums [2, cout]."""
    return 4 * (cin + cout) * 68 + 16 * cout


@pytest.mark.parametrize("name", list(WIDTH_SETS))
def test_max_plan_fits(name):
    widths = WIDTH_SETS[name]
    p = plan.plan_max(widths, H100_SMEM)
    kernel = plan.kernel_widths(widths)
    assert p is not None and p.widths == kernel
    assert p.smem == plan.max_smem(kernel) <= H100_SMEM
    assert p.blocks_per_sm >= 2
    # each buffer holds every layer input it takes, to the K step
    for layer, c in enumerate(widths[:-1]):
        assert p.rows[layer % 2] >= plan.tile_rows(c, c >= 8) >= c
    assert p.rows[0] % 4 == 0 and p.rows[1] % 8 == 0


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_dense_plan_fits(cin, cout):
    p = plan.plan_dense(cin, cout, H100_SMEM)
    assert p is not None and p.cout == plan.pad4(cout) and p.cin == cin
    assert p.smem == plan.dense_smem(cin, p.cout, p.stage)
    assert p.smem <= H100_SMEM and p.blocks_per_sm >= 2
    # cp.async stages 16-byte pieces of rows of cin floats
    assert p.stage == (cin % 4 == 0 and plan.blocks_per_sm(
        plan.dense_smem(cin, cout, True), plan.FWD_THREADS, H100_SMEM) >= 2)
    # a row a channel, the rows covering 4 channels a float4
    rows = plan.tile_rows(cin, False)
    assert rows >= cin and rows % 4 == 0 and rows - cin < 4


@pytest.mark.parametrize("c_max", [8, 64, 128, 256, 404, 424])
def test_point_mlp_max_takes_every_width_it_took(c_max):
    """Chains of 1 to 8 layers whose widths reach c_max at each position
    (and 4, 12 or c_max elsewhere): where the SIMT kernel fitted, the plan
    fits."""
    for layers in range(1, plan.PARAM_LAYERS + 1):
        for at in range(layers + 1):
            for other in (4, 12, c_max):
                widths = [3 if layers > 1 else other] + [other] * layers
                widths[at] = c_max
                if _old_max_smem(widths) <= H100_SMEM:
                    assert plan.plan_max(widths, H100_SMEM) is not None, \
                        widths


def test_point_mlp_max_refuses_what_it_refused():
    # 6 % 4: planned at 8, the width the wrapper pads it to
    assert plan.plan_max((3, 64, 6), H100_SMEM) == plan.plan_max(
        (3, 64, 8), H100_SMEM)
    # 9 layers: taken since the layer table moved to device memory
    assert plan.plan_max((3,) + (64,) * 9, H100_SMEM) is not None
    assert plan.plan_max((3, 64, 2048), H100_SMEM) is not None
    assert plan.plan_max((3, 1024, 1024, 8), H100_SMEM) is None   # smem
    assert _old_max_smem((3, 1024, 1024, 8)) > H100_SMEM


@pytest.mark.parametrize("cin", [1, 3, 4, 7, 8, 12, 64, 128, 256, 415, 800])
def test_pmt_dense_takes_every_width_it_took(cin):
    for cout in range(4, 1025, 4):
        if _old_dense_smem(cin, cout) <= H100_SMEM:
            assert plan.plan_dense(cin, cout, H100_SMEM) is not None, \
                (cin, cout)
    # 6 % 4: planned at 8, the width the wrapper pads it to
    assert plan.plan_dense(cin, 6, H100_SMEM) == plan.plan_dense(
        cin, 8, H100_SMEM)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: to nearest, ties away from zero, keeping 10
    mantissa bits (on the int32 view, the magnitude rounds alone)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)


def _mma_f32(a: torch.Tensor, w: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ w as the tile sums it: per K step of 8, the split products in
    f32 from zero, smallest first, then the step added into an f32
    accumulator. terms=3: a_lo*b_hi, a_hi*b_lo, a_hi*b_hi (3xTF32, the
    tile's); 1: a_hi*b_hi, one TF32 product."""
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    pairs = {3: [(al, wh), (ah, wl), (ah, wh)],
             1: [(ah, wh)]}[terms]
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        step = torch.zeros_like(acc)
        for x, y in pairs:
            step = step + x[:, k] @ y[k]
        acc = acc + step
    return acc


def _errors(t: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(largest entry's error, norm-wise error) against ref, relative."""
    d = t.double() - ref
    return (float(d.abs().max() / ref.abs().max()),
            float(d.norm() / ref.norm()))


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0]
    assert _tf32(v).tolist() == want
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000)
                         .astype(np.float32))
    hi = _tf32(x)
    assert ((hi.view(torch.int32) & 0x1fff) == 0).all()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("terms", [3, 1], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 128),
                                      (128, 256), (256, 128)])
def test_tf32_products_keep_f32_accuracy(cin, cout, terms):
    """Post-ReLU activations (a 64-tile's worth of them 64 times over) and
    weights at their init scale: the split sums against the f64 product,
    beside the plain f32 matmul's; one TF32 product, the control, lands
    about a thousand times further."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(cin + cout)
    a = torch.from_numpy(np.maximum(rng.standard_normal((4096, cin)), 0)
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cin, cout)) / np.sqrt(cin))
                         .astype(np.float32))
    ref = a.double() @ w.double()
    plain = _errors(a @ w, ref)
    tile = _errors(_mma_f32(a, w, terms), ref)
    within = all(t <= 2 * p for t, p in zip(tile, plain))
    assert within == (terms > 1), (tile, plain)
