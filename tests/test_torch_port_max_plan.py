"""point_mlp_max's split on the CPU: its launch plan (`max_splits`), the
tiles each block of a split walks, and the fold of the blocks' maxima.

Where B clouds leave the card's block slots idle, csrc/point_mlp_max.cu
gives each cloud S blocks: block (b, s) walks the 64-point tiles s, s + S,
... of cloud b, keeps each channel's max over them, and folds it into the
output, zeroed first, by atomicMax on the int bit pattern. The plan is
pure Python; the walk and the fold are emulated here in numpy on the plain
version's per-point activations, against one block a cloud (bit for bit)
and against the JAX package's point_mlp_max in interpret mode (rtol 1e-5,
atol 1e-6: both f32, their matmuls summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.pallas.point_mlp_kernel import (
    point_mlp_max as jax_point_mlp_max,
)
from samplenet_tpu_torch.ops.cuda import point_mlp_plan as mp
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import (
    full_f32_matmul,
    point_mlp_max,
)

torch.set_num_threads(1)

H100_SMS = 132
WIDTHS = (3, 64, 64, 64, 128, 128)


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
@pytest.mark.parametrize("extra", [0, 1, 500])
def test_one_block_a_cloud_where_the_clouds_fill_the_card(resident, extra):
    b = H100_SMS * resident + extra
    for n in (1, 64, 1024, 2048, 100003):
        assert mp.max_splits(b, n, sms=H100_SMS, resident=resident) == 1
    # the eval path's B=1024 launches as it did before the split
    assert mp.max_splits(1024, 1024, sms=H100_SMS, resident=resident) == 1


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("resident", [1, 2, 4])
def test_split_is_at_least_one_and_never_more_blocks_than_tiles(sms,
                                                                resident):
    for b in (1, 2, 3, 31, 32, 50, 131, 133, 263):
        for n in (1, 63, 64, 65, 77, 1000, 1024, 2048, 4097):
            s = mp.max_splits(b, n, sms=sms, resident=resident)
            assert 1 <= s <= -(-n // mp.TILE), (b, n, s)
            assert s <= mp.MAX_SPLITS
            # a function of its arguments: the same plan again
            assert s == mp.max_splits(b, n, sms=sms, resident=resident)


@pytest.mark.parametrize("b,n,resident,want", [
    (32, 1024, 2, 8),      # the registration eval: 256 blocks, 2 tiles each
    (32, 1024, 4, 16),     # 512 blocks, a tile each
    (50, 2048, 2, 5),      # the NRE eval: 250 blocks, 6 or 7 tiles
    (1, 77, 2, 2),         # a ragged cloud of two tiles
    (3, 1000, 2, 16),      # every tile its own block
])
def test_split_at_the_paths_shapes(b, n, resident, want):
    assert mp.max_splits(b, n, sms=H100_SMS, resident=resident) == want


def test_split_finishes_no_later_than_one_block_a_cloud():
    """By the plan's own cost (waves of the card's slots, ceil(tiles / S)
    tiles a block plus its own work), the chosen S is never worse than
    S = 1, and strictly better wherever a split fills idle slots."""
    def cost(b, n, s, slots):
        tiles = -(-n // mp.TILE)
        return -(-b * s // slots) * (-(-tiles // s) + mp.SPLIT_BLOCK_COST)

    for resident in (1, 2, 4):
        slots = H100_SMS * resident
        for b in (1, 3, 32, 50, 100):
            for n in (128, 1024, 2048):
                s = mp.max_splits(b, n, sms=H100_SMS, resident=resident)
                assert cost(b, n, s, slots) <= cost(b, n, 1, slots)
                if 2 * b <= slots:
                    assert s > 1 and cost(b, n, s, slots) < cost(b, n, 1,
                                                                  slots)


def test_split_refuses_sizes_below_one():
    for bad in ((0, 64, 132, 2), (1, 0, 132, 2), (1, 64, 0, 2),
                (1, 64, 132, 0)):
        with pytest.raises(ValueError, match="positive"):
            mp.max_splits(bad[0], bad[1], sms=bad[2], resident=bad[3])


def _walks(n: int, s: int) -> list[list[int]]:
    """The first points of the tiles block (b, r) walks, r < s, as the
    kernel's loop steps: p0 = r * 64, p0 < n, p0 += s * 64."""
    return [list(range(r * mp.TILE, n, s * mp.TILE)) for r in range(s)]


@pytest.mark.parametrize("n", [1, 63, 64, 77, 1000, 1024, 2048])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 16, 40])
def test_the_blocks_of_a_split_walk_every_tile_once(n, s):
    tiles = sorted(p0 for walk in _walks(n, s) for p0 in walk)
    assert tiles == list(range(0, n, mp.TILE))


def _activations(x, wbs):
    """The plain version's per-point output of the last layer, before the
    max: [B, N, C]."""
    h = x
    with full_f32_matmul():
        for i in range(0, len(wbs), 2):
            h = torch.relu(torch.matmul(h, wbs[i]) + wbs[i + 1])
    return h.numpy()


def _split_fold(h: np.ndarray, s: int) -> np.ndarray:
    """The kernel's result under S = s, emulated: each block's max over
    its tiles' points (the shared per-channel max, from +0), folded into an
    output of zeros by an int max on the bit patterns."""
    b, n, c = h.shape
    out = np.zeros((b, c), dtype=np.int32)
    for walk in _walks(n, s):
        block = np.zeros((b, c), dtype=np.float32)
        for p0 in walk:
            block = np.maximum(block, h[:, p0:p0 + mp.TILE].max(axis=1))
        out = np.maximum(out, block.view(np.int32))
    return out.view(np.float32)


def _weights(rng, widths):
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [(rng.standard_normal((cin, cout)) / np.sqrt(cin)
                 ).astype(np.float32),
                (0.1 * rng.standard_normal(cout)).astype(np.float32)]
    return wbs


@pytest.mark.parametrize("b,n", [(1, 77), (3, 200), (2, 64), (5, 130)])
def test_split_fold_is_one_block_a_cloud_and_the_jax_kernel(b, n):
    rng = np.random.default_rng(b * 100 + n)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    wbs = _weights(rng, WIDTHS)
    tx, twbs = torch.from_numpy(x), [torch.from_numpy(a) for a in wbs]
    one = point_mlp_max(tx, twbs).numpy()
    h = _activations(tx, twbs)
    np.testing.assert_array_equal(h.max(axis=1), one)
    for s in (1, 2, 3, 4, 16):
        np.testing.assert_array_equal(_split_fold(h, s), one)
    want = np.asarray(jax_point_mlp_max(
        jnp.asarray(x), tuple(jnp.asarray(a) for a in wbs), bf16=False,
        interpret=True))
    np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-6)


def test_int_max_orders_nonnegative_floats_as_floats():
    """The fold's rule: on floats >= +0 (and +inf) the int bit patterns
    order as the floats do, so an int max is the float max."""
    rng = np.random.default_rng(5)
    v = np.abs(rng.standard_normal((1000, 2)).astype(np.float32)) * \
        np.float32(10.0) ** rng.integers(-40, 38, (1000, 2))
    v = np.concatenate([v, [[0.0, np.inf], [np.inf, 1e-45], [0.0, 0.0]]]
                       ).astype(np.float32)
    folded = np.maximum(v[:, 0].view(np.int32), v[:, 1].view(np.int32))
    np.testing.assert_array_equal(folded.view(np.float32), v.max(axis=1))
