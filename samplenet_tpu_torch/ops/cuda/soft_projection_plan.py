"""Launch plans of the soft-projection kernels, forward and backward: pure
Python, so that the CPU tests reach them (csrc/soft_projection.cu; the
constants below are the kernels' own).

The forward kernel serves each query with `slices` adjacent lanes (a
power of two up to MAX_SLICES), which split each group of points it scans
between them. A block of 32 * warps lanes serves one cloud and 32 * warps /
slices of its queries, and stages the cloud in shared memory as float4
(16 bytes a point), `chunk` points at a time: the whole cloud where it
fits in MAX_CHUNK points, staged once for both passes; a longer cloud
chunk by chunk, for each pass. `chunk` is a multiple of 32.

`slices` trades parallelism against merging: the plan takes the fewest
that give the card LANES_PER_SM lanes an SM (30 warps), since every
doubling adds a round of shuffles and insertions to merge the query's
lanes. `warps` is the widest block the cloud's queries fill, up to
MAX_WARPS: a block stages its cloud once for all its queries, and wider
blocks also keep more warps on an SM within its shared memory. PERF.md
has the sweep of slices and warps on an H100 these rules were fitted to
(tools/time_soft_projection.py). The plan depends only on the shape and
the card, and the kernel's outputs do not depend on it.

The backward runs two kernels. The first takes one query a thread over a
flat grid of all B*M queries, `tile` a block (so where M is small a block
serves several clouds), and writes each entry's contribution to the
workspace; its tile is the largest that still gives every SM a block.
The second owns `span` consecutive points of one cloud a block, one to
MAX_PER a thread, and streams the cloud's M*k entries to find its own,
32 * UNROLL a warp a round; a last block a cloud sums d sigma^2. Its grid
is flat, B * (ranges + 1) blocks, so it caps neither B nor N. Every
block of the second kernel reads all of its cloud's entries, and waits on
memory and barriers in each round and slice of its own, so the rules
trade the number of blocks against the entries each reads: span is
SPAN points (fewer where the cloud is smaller), with a thread a point
where the clouds are fewer than the SMs, and four points a thread where
they are not (a block of 64 threads). PERF.md has the sweep of span and
threads on an H100 these rules were fitted to
(tools/time_soft_projection.py). The outputs do not depend on the plan.

Group sizes above MAX_REGISTER_K, and clouds of more queries than the
register forward's grid axis holds, take the wide forward kernel
(`takes_register_fwd`): one warp a query over a flat grid of all B*M
queries, WIDE_WARPS a block, a radix
histogram of RADIX_BINS counters a warp in static shared memory and
nothing that grows with N or k; its plan is that grid. The backward takes
any k under the plan above (its first kernel loops over k above
MAX_REGISTER_K).
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_REGISTER_K = 16  # kMaxK: the register kernels' k; above, the wide ones
MAX_WARPS = 8        # kMaxWarps: __launch_bounds__(256)
MAX_SLICES = 8       # kMaxSlices
LANES_PER_SM = 30 * 32
POINT_BYTES = 16     # a staged point: float4 (x, y, z, 0)
MAX_CHUNK = 4096     # points staged at once: 64 KB of shared memory
MAX_GRID_Y = 65535
MAX_GRID_X = 2**31 - 1


@dataclass(frozen=True)
class FwdPlan:
    chunk: int               # points staged at a time, a multiple of 32
    warps: int               # a block has 32 * warps lanes
    slices: int              # lanes a query
    grid: tuple[int, int]    # (clouds, query tiles)

    @property
    def smem(self) -> int:
        return fwd_smem(self.chunk)

    @property
    def tile(self) -> int:
        """Queries a block."""
        return 32 * self.warps // self.slices


def fwd_chunk(n: int) -> int:
    """Points staged at a time for a cloud of n: all of them, rounded up to
    32, up to MAX_CHUNK."""
    return min(-(-n // 32) * 32, MAX_CHUNK)


def fwd_smem(chunk: int) -> int:
    """Shared memory of one block, as the kernel counts it."""
    return chunk * POINT_BYTES


def _fwd_launch(b: int, m: int, sms: int) -> tuple[int, int, int]:
    """(slices, warps, query tiles) of the register forward."""
    slices = 1
    while slices < MAX_SLICES and b * m * slices < sms * LANES_PER_SM:
        slices *= 2
    warps = min(MAX_WARPS, -(-m * slices // 32))
    return slices, warps, -(-m * slices // (32 * warps))


def takes_register_fwd(b: int, m: int, k: int, *, sms: int) -> bool:
    """Whether the register forward takes the shape: k up to
    MAX_REGISTER_K and its query tiles within a grid axis (M up to
    16,776,960 a cloud). The wide forward takes the rest."""
    return k <= MAX_REGISTER_K and _fwd_launch(b, m, sms)[2] <= MAX_GRID_Y


def plan_fwd(b: int, n: int, m: int, *, sms: int) -> FwdPlan:
    """The plan for B clouds of n points and m queries each on a card of
    `sms` SMs."""
    if min(b, n, m, sms) < 1:
        raise ValueError(f"plan_fwd needs positive sizes, got b={b}, n={n}, "
                         f"m={m}, sms={sms}")
    slices, warps, grid_y = _fwd_launch(b, m, sms)
    if grid_y > MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    return FwdPlan(chunk=fwd_chunk(n), warps=warps, slices=slices,
                   grid=(b, grid_y))


WIDE_WARPS = 8       # kWideWarps: queries a block of the wide forward
RADIX_BINS = 256     # kRadixBins: 8 bits a pass


@dataclass(frozen=True)
class WideFwdPlan:
    warps: int       # queries a block, one a warp
    grid: int        # blocks: ceil(B * M / warps)

    @property
    def smem(self) -> int:
        """Static shared memory of a block: a histogram a warp."""
        return wide_smem(self.warps)


def wide_smem(warps: int) -> int:
    return warps * RADIX_BINS * 4


def plan_fwd_wide(b: int, n: int, m: int, k: int) -> WideFwdPlan:
    """The wide forward's plan for B clouds of n points and m queries, any
    1 <= k <= n."""
    if min(b, n, m, k) < 1 or k > n:
        raise ValueError(f"plan_fwd_wide needs positive sizes and k <= n, "
                         f"got b={b}, n={n}, m={m}, k={k}")
    grid = -(-b * m // WIDE_WARPS)
    if grid > MAX_GRID_X:
        raise ValueError(f"B={b} x M={m} queries exceed the wide kernel's "
                         f"grid")
    return WideFwdPlan(warps=WIDE_WARPS, grid=grid)


# the backward: soft_project_bwd_entries and soft_project_bwd_points
MAX_TILE = 256           # kMaxTile: queries a block of the first kernel
MAX_POINT_THREADS = 256  # kMaxPointThreads
MAX_PER = 4              # kMaxPer: points a thread
UNROLL = 4               # kUnroll: idx loads a lane holds a round
STRIPES = 256            # kStripes: d sigma^2's query stripes
SPAN = 256               # points a point block owns, at most
MAX_ENTRIES = 2**31 - 1 - 32 * UNROLL * MAX_POINT_THREADS   # M * k, int


@dataclass(frozen=True)
class BwdPlan:
    tile: int       # queries a block of the first kernel, one a thread
    threads: int    # a point block's threads
    span: int       # points a point block owns, a multiple of threads


def bwd_smem(threads: int, span: int, entries: int) -> int:
    """Dynamic shared memory of a point block, as the kernel counts it: the
    [span] hit flags and [warps, span] lane masks, then the larger of a
    round's list (a float4 contribution and a point each, at most
    min(round, entries) of them) and the block's staged rows of d points."""
    warps = threads // 32
    cap = min(32 * UNROLL * warps, entries)
    return (warps + 1) * span * 4 + max(cap * 20, span * 12)


def plan_bwd(b: int, n: int, m: int, k: int, *, sms: int) -> BwdPlan:
    """The backward's plan for B clouds of n points, m queries and k
    neighbours each, on a card of `sms` SMs."""
    if min(b, n, m, k, sms) < 1:
        raise ValueError(f"plan_bwd needs positive sizes, got b={b}, n={n}, "
                         f"m={m}, k={k}, sms={sms}")
    tile = MAX_TILE
    while tile > 32 and -(-b * m // tile) < sms:
        tile //= 2
    span = min(SPAN, max(32, 1 << (n - 1).bit_length()))
    threads = span if b < sms else max(32, span // MAX_PER)
    if (m * k > MAX_ENTRIES or -(-b * m // tile) > MAX_GRID_X
            or b * (-(-n // span) + 1) > MAX_GRID_X):
        raise ValueError(f"B={b}, N={n}, M={m}, k={k} exceed the kernels' "
                         f"grids")
    return BwdPlan(tile=tile, threads=threads, span=span)
