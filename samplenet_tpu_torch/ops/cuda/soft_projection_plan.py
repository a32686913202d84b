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
register forward's grid axis holds, take the wide forward
(`takes_register_fwd`), whose plan (`plan_fwd_wide`) picks one of its two
kernels. The pruned kernel, for k up to PRUNE_MAX_K and at most a quarter
of N: each query's points split over S = ws * cs warp-slices (ws warps of
a block, cs blocks of a thread-block cluster), S the fewest that give the
card FILL_WARPS warps an SM and leave no lane more than MAX_VISITS keys to
cache, while each slice keeps at least 32 * SLOTS points; the blocks of a
cluster before the warps of a block, so that a block's queries share its
staged points, but never more queries a block than the cloud has. G =
max(64, 2k rounded up to a power of two) group minima a query, a buffer of
2G candidates. The radix kernel takes the rest: one warp a query over a
flat grid of all B*M queries, WIDE_WARPS a block, a radix histogram of
RADIX_BINS counters a warp in static shared memory and nothing that grows
with N or k. The outputs do not depend on the plan. The backward takes any
k under the plan above (its first kernel loops over k above
MAX_REGISTER_K), and any M * k: past INT_ENTRIES entries a cloud its
point kernel counts them in 64 bits.
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


WIDE_WARPS = 8       # kWideWarps: queries a block of the radix kernel
RADIX_BINS = 256     # kRadixBins: 8 bits a pass
PRUNE_WARPS = 8      # kPruneWarps: a pruned block's warps
SLOTS = 8            # kSlots: group minima a lane keeps
MAX_GROUPS = 128     # kMaxGroups
MAX_CAP = 256        # kMaxCap
MAX_CLUSTER = 8      # kMaxCluster: the portable cluster size
MAX_VISITS = 64      # kMaxVisits: keys a lane caches
PRUNE_CHUNK = 2048   # kMaxPruneChunk: points staged at a time
PRUNE_MAX_K = 64
FILL_WARPS = 16      # warps an SM that the pruned split aims for


@dataclass(frozen=True)
class WideFwdPlan:
    ws: int          # warps a query in a block; 0: the radix kernel
    cs: int          # blocks a cluster, each `span` points of the cloud
    groups: int      # group minima a query (G)
    cap: int         # candidates a query
    chunk: int       # points staged at a time
    span: int        # points a block
    grid: int        # blocks

    @property
    def radix(self) -> bool:
        return self.ws == 0

    @property
    def split(self) -> int:
        """Warp-slices a query: S = ws * cs."""
        return self.ws * self.cs

    @property
    def queries(self) -> int:
        """Queries a block (a cluster)."""
        return WIDE_WARPS if self.radix else PRUNE_WARPS // self.ws

    @property
    def visits(self) -> int:
        """Keys a lane caches: every visit of the block's chunks."""
        return -(-self.span // self.chunk) * self.chunk // (32 * self.ws)

    @property
    def smem(self) -> int:
        """Shared memory of a block, as the kernels count it: the radix
        kernel's static histograms, or the pruned kernel's dynamic layout
        (the staged chunks, which the queries' states reuse, then the
        warps' key caches)."""
        if self.radix:
            return wide_smem(WIDE_WARPS)
        staged = (2 if self.span > self.chunk else 1) * self.chunk * 16
        states = self.queries * (self.cap * 8 + 16)
        return max(staged, states) + PRUNE_WARPS * 32 * self.visits * 4


def wide_smem(warps: int) -> int:
    return warps * RADIX_BINS * 4


def _pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def pruned_split(b: int, n: int, m: int, *, sms: int) -> int:
    """S, the warp-slices a query of the pruned kernel (a power of two up
    to 64): the fewest that give the card FILL_WARPS warps an SM and no
    lane more than MAX_VISITS keys, each slice keeping 32 * SLOTS points."""
    s = 1
    while s < PRUNE_WARPS * MAX_CLUSTER and (
            b * m * s < sms * FILL_WARPS or -(-n // s) > 32 * MAX_VISITS) \
            and -(-n // (2 * s)) >= 32 * SLOTS:
        s *= 2
    return s


def plan_fwd_wide(b: int, n: int, m: int, k: int, *, sms: int) -> WideFwdPlan:
    """The wide forward's plan for B clouds of n points and m queries, any
    1 <= k <= n, on a card of `sms` SMs."""
    if min(b, n, m, k, sms) < 1 or k > n:
        raise ValueError(f"plan_fwd_wide needs positive sizes and k <= n, "
                         f"got b={b}, n={n}, m={m}, k={k}, sms={sms}")
    s = pruned_split(b, n, m, sms=sms)
    if k > PRUNE_MAX_K or 4 * k > n or -(-n // s) > 32 * MAX_VISITS:
        grid = -(-b * m // WIDE_WARPS)
        if grid > MAX_GRID_X:
            raise ValueError(f"B={b} x M={m} queries exceed the wide "
                             f"kernel's grid")
        return WideFwdPlan(0, 1, 0, 0, 0, 0, grid)
    cs = min(MAX_CLUSTER, s)
    ws = s // cs
    while cs > 1 and PRUNE_WARPS // ws > m:    # queries a block the cloud has
        cs //= 2
        ws *= 2
    return pruned_plan(b, n, m, k, ws, cs)


def pruned_plan(b: int, n: int, m: int, k: int, ws: int, cs: int
                ) -> WideFwdPlan:
    """The pruned kernel's plan at the split (ws, cs): G = max(64, 2k
    rounded up to a power of two), a buffer of 2G candidates, a block's
    span its share of the cloud rounded up to 32 * ws points, and the
    chunk the smallest multiple of 256 * ws (whole batches of 8 visits a
    lane) that holds the span, up to PRUNE_CHUNK points. A split that
    leaves a block no points is refused."""
    groups = max(64, _pow2(2 * k))
    span = -(-n // (cs * 32 * ws)) * 32 * ws
    chunk = min(-(-span // (256 * ws)) * 256 * ws, max(PRUNE_CHUNK, 256 * ws))
    grid = b * -(-m // (PRUNE_WARPS // ws)) * cs
    plan = WideFwdPlan(ws, cs, groups, 2 * groups, chunk, span, grid)
    if (groups > MAX_GROUPS or ws * cs > groups or plan.visits > MAX_VISITS
            or ws not in (1, 2, 4, 8) or cs not in (1, 2, 4, 8)
            or (cs - 1) * span >= n):
        raise ValueError(f"the pruned kernel does not take k={k}, n={n} at "
                         f"ws={ws}, cs={cs}")
    if grid > MAX_GRID_X:
        raise ValueError(f"B={b} x M={m} queries exceed the wide kernel's "
                         f"grid")
    return plan


# the backward: soft_project_bwd_entries and soft_project_bwd_points
MAX_TILE = 256           # kMaxTile: queries a block of the first kernel
MAX_POINT_THREADS = 256  # kMaxPointThreads
MAX_PER = 4              # kMaxPer: points a thread
UNROLL = 4               # kUnroll: idx loads a lane holds a round
STRIPES = 256            # kStripes: d sigma^2's query stripes
SPAN = 256               # points a point block owns, at most
# entries (M * k) a cloud the point kernel counts in int; past them, in
# 64 bits (kIntEntries)
INT_ENTRIES = 2**31 - 1 - 32 * UNROLL * MAX_POINT_THREADS


@dataclass(frozen=True)
class BwdPlan:
    tile: int       # queries a block of the first kernel, one a thread
    threads: int    # a point block's threads
    span: int       # points a point block owns, a multiple of threads
    count64: bool = False   # the point kernel counts entries in 64 bits


def counts_in_64_bits(m: int, k: int) -> bool:
    """Whether the point kernel must count a cloud's M * k entries in 64
    bits (soft_project_bwd_points64, at any k); a plan may ask for it at
    any size (the same sums in the same order)."""
    return m * k > INT_ENTRIES


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
    if (-(-b * m // tile) > MAX_GRID_X
            or b * (-(-n // span) + 1) > MAX_GRID_X):
        raise ValueError(f"B={b}, N={n}, M={m}, k={k} exceed the kernels' "
                         f"grids")
    return BwdPlan(tile=tile, threads=threads, span=span,
                   count64=counts_in_64_bits(m, k))
