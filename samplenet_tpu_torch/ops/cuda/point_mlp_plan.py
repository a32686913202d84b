"""Launch plan of the train MLP chains' backward kernels: pure Python, so
that the CPU tests reach it (csrc/point_mlp_train.cu, pmt_bwd_dz and
pmt_bwd_dw; the constants below are the kernels' own).

Per layer (cin -> cout) the backward runs two passes:

- `pmt_bwd_dz` walks the 64-point tiles (none crossing a ghost block) and
  writes dz and dh_prev = dz op(W)^T. A block holds the tile's
  dz, its ghost block's per-channel constants and `dz_kc` rows of op(W)^T
  at a time (all cout rows where they fit, else K chunks loaded per
  tile); with `dz_stage` also the next tile's raw z and dh rows, staged
  with cp.async while the tile's product runs. Staging costs 2 x 64 x cout
  floats, so it is taken only where two blocks still share an SM (the
  64-wide layers): a lone block per SM stalls between its phases, and two
  unstaged blocks overlap each other's. Each thread owns `dz_rp` points x
  4 channels of dh_prev. The grid only spreads work: dz and dh_prev do
  not depend on it.
- `pmt_bwd_dw` computes dW = op(act(h_prev))^T dz by split-K over the 64-
  point tiles: a grid of (output tiles of [cin_pad, cout]: 64 input x 64
  output channels at `dw_ri` = 4, 64 x 128 at 8) x `dw_splits` runs of
  consecutive tiles. Each tile is summed in f32, the tiles of a run in f64
  registers, and the runs' f64 partials by the caller in a fixed order;
  `dw_splits` depends only on the shape and the SM count, so the bits
  repeat from run to run.

Shared memory is counted as the kernels count it; a plan is refused
(None) where a pass does not fit the card's per-block limit (cout up to
about 770, as for the forward's pmt_dense).
"""

from __future__ import annotations

from dataclasses import dataclass

TILE = 64             # points per tile of the dW sums (kTileP)
DZ_THREADS = 256      # kDzThreads
DZ_RPS = (1, 2, 4, 8, 16)
DW_THREADS = 128      # kDwThreads
DW_TILE = 64          # kDwTile: input channels of a dW output tile


def dw_to(ri: int) -> int:
    """Output channels of a dW output tile (dw_to<kRI>)."""
    return DW_THREADS * ri * 8 // DW_TILE


def dw_ri(cout: int) -> int:
    """Input channels a dW thread owns (x 8 output channels): 8 where cout
    fills the 128-wide output tile that takes (4 FMA per float read from
    shared memory, against 2.7 at 4 x 8), else 4."""
    return 8 if cout >= dw_to(8) else 4


def dw_smem(ri: int) -> int:
    """Two stages of a 64-point tile of act(h_prev), 64 channels, and of
    dz, dw_to(ri) channels (snt_pmt_bwd_dw_smem)."""
    return 4 * 2 * TILE * (DW_TILE + dw_to(ri))


# blocks per SM the dW kernel is built for (its launch bounds), which its
# shared memory leaves room for in an H100 SM's 228 KB
DW_BLOCKS_PER_SM = {4: 3, 8: 2}
SMEM_RESERVED = 1024  # shared memory the card reserves per resident block
MAX_THREADS_PER_SM = 2048


@dataclass(frozen=True)
class LayerPlan:
    cin: int
    cout: int
    cin_pad: int
    dz_rp: int        # points per thread in its dh_prev product
    dz_kc: int        # rows of op(W)^T in shared memory at once
    dz_stage: bool    # cp.async stages the next tile's z and dh rows
    dz_smem: int      # bytes per block
    dz_grid: int
    dw_ri: int
    dw_out_tiles: int
    dw_splits: int
    dw_smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def dz_smem(cin_pad: int, cout: int, kc: int, stage: bool) -> int:
    """Bytes of a pmt_bwd_dz block (csrc: snt_pmt_bwd_dz_smem): op(W)^T
    rows [kc, cin_pad], 7 per-channel constants, dz channel-major
    [cout, 68], each point's cloud and index [2, 64], and with `stage` the
    raw z and dh rows [2, 64, cout]."""
    return 4 * (kc * cin_pad + 7 * cout + cout * (TILE + 4) + 2 * TILE
                + (2 * TILE * cout if stage else 0))


def blocks_per_sm(smem: int, threads: int,
                  limit: int = 232448) -> int:
    """Resident blocks per SM by shared memory and threads: an SM holds
    the per-block limit plus one reservation."""
    by_smem = (limit + SMEM_RESERVED) // (smem + SMEM_RESERVED)
    return max(0, min(by_smem, MAX_THREADS_PER_SM // threads))


def _dz_layout(cin_pad: int, cout: int, limit: int):
    """(kc, stage) for pmt_bwd_dz, the first that fits of: two blocks to an
    SM with op(W)^T whole and the rows staged; the same unstaged; two
    blocks with K chunks of at least 32 rows, unstaged; one block with
    chunks of at least 4 rows, staged, then unstaged. Chunks are the
    fewest equal multiples of 4 that fit."""
    half = (limit + SMEM_RESERVED) // 2 - SMEM_RESERVED
    for budget, stage, kc_min in ((half, True, cout), (half, False, cout),
                                  (half, False, min(cout, 32)),
                                  (limit, True, 4), (limit, False, 4)):
        room = (budget - dz_smem(cin_pad, cout, 0, stage)) // (4 * cin_pad)
        kc_max = min(cout, room // 4 * 4)
        if kc_max >= max(4, kc_min):
            chunks = _ceil(cout, kc_max)
            return min(kc_max, _ceil(_ceil(cout, chunks), 4) * 4), stage
    return None


def _dz_rp(cin_pad: int) -> int:
    """The fewest points per thread that cover a tile's dh_prev
    (64 x cin_pad, 4 channels a thread) with the block's threads; at most
    16 (wider layers take several passes)."""
    for rp in DZ_RPS:
        if (TILE // rp) * (cin_pad // 4) <= DZ_THREADS:
            return rp
    return DZ_RPS[-1]


def plan_layer(cin: int, cout: int, n_blocks: int, m: int, sms: int,
               limit: int) -> LayerPlan | None:
    """The plan of one layer for `n_blocks` ghost blocks of `m` points
    each, on a card with `sms` SMs and `limit` bytes of shared memory per
    block; None where a pass does not fit."""
    cin_pad = _ceil(cin, 4) * 4
    layout = _dz_layout(cin_pad, cout, limit)
    ri = dw_ri(cout)
    if layout is None or cout % 4 or dw_smem(ri) > limit:
        return None
    kc, stage = layout
    smem = dz_smem(cin_pad, cout, kc, stage)
    tiles = n_blocks * _ceil(m, TILE)
    dz_grid = max(1, min(tiles, blocks_per_sm(smem, DZ_THREADS, limit) * sms))
    out_tiles = _ceil(cin_pad, DW_TILE) * _ceil(cout, dw_to(ri))
    splits = max(1, min(tiles, _ceil(DW_BLOCKS_PER_SM[ri] * sms, out_tiles)))
    return LayerPlan(cin, cout, cin_pad, _dz_rp(cin_pad), kc, stage, smem,
                     dz_grid, ri, out_tiles, splits, dw_smem(ri))


def plan_bwd(widths, n_blocks: int, m: int, sms: int,
             limit: int) -> list[LayerPlan] | None:
    """One plan per layer of the chain `widths` (widths[0] is the input's),
    or None where any layer does not fit."""
    plans = [plan_layer(ci, co, n_blocks, m, sms, limit)
             for ci, co in zip(widths[:-1], widths[1:])]
    return None if None in plans else plans
