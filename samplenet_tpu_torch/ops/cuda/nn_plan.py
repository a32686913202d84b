"""Launch plan of the 1-NN kernel (nn_direction and nn_snap): pure Python,
so that the CPU tests reach it (csrc/nn_direction.cu; the constants below
are the kernel's own).

The kernel serves each query with `lanes` (L) adjacent lanes, a power of
two up to 32: lane l of the group scans the database points p = l, l + L,
... in ascending order, and log2 L shuffle rounds merge the group. Each
thread holds `queries` (Q) queries in registers, so a point read from
shared memory serves Q pairs. A block of 32 * warps threads serves one
cloud and a tile of 32 * warps / L * Q of its queries; the grid is flat
over (cloud, tile), cloud-major, so it caps B * tiles at 2**31 - 1 and
nothing else. The block stages its cloud `chunk` points at a time as
float4 (16 bytes a point) with cp.async, the next chunk into a second
buffer while it scans the current one.

The rules: Q starts at PLAN_QUERIES (a point read from shared memory
serves four pairs); L = 1 where the queries alone fill the card with
THREADS_PER_SM threads an SM (a thread owns its queries and needs no
merge), and L doubles only while B * N1 * L / Q threads leave it short
and each lane keeps POINTS_PER_LANE points or more to scan (fewer, and
the merge's shuffle rounds cost more than the lanes save); where even so
fewer than MIN_THREADS_PER_SM threads an SM run, Q halves. The block is
as wide as one cloud's queries need, up to MAX_WARPS; the chunk holds the
whole cloud where it fits in MAX_CHUNK points. PERF.md has the sweep of
lanes, queries, chunks and block widths on an H100 these rules were
fitted to (tools/time_nn_direction.py). The plan depends only on the
shape and the card, and the kernel's outputs do not depend on it.
"""

from __future__ import annotations

from dataclasses import dataclass

LANES = (1, 2, 4, 8, 16, 32)    # the kernel's L, lanes a query
QUERIES = (1, 2, 4, 8)          # the kernel's Q, queries a thread
MAX_WARPS = 8                   # kMaxWarps: __launch_bounds__(256)
MAX_CHUNK = 1024                # kMaxChunk: 16 KB of float4 a buffer
POINT_BYTES = 16                # a staged point: float4 (x, y, z, -)
MAX_GRID = 2**31 - 1            # gridDim.x, and the kernel's int32 indices
PLAN_QUERIES = 4                # Q unless the card is short even so
THREADS_PER_SM = 1024           # L grows while fewer threads an SM run
MIN_THREADS_PER_SM = 128        # Q halves while fewer threads an SM run
POINTS_PER_LANE = 64            # L grows only while each lane keeps these


@dataclass(frozen=True)
class NnPlan:
    lanes: int       # L, lanes a query
    queries: int     # Q, queries a thread
    warps: int       # a block has 32 * warps threads
    chunk: int       # database points staged at a time, a multiple of 32

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def tile(self) -> int:
        """Queries a block."""
        return self.threads // self.lanes * self.queries

    def smem(self, n2: int) -> int:
        return nn_smem(self.chunk, n2)

    def tiles(self, n1: int) -> int:
        """Blocks a cloud."""
        return -(-n1 // self.tile)

    def grid(self, b: int, n1: int) -> int:
        return b * self.tiles(n1)


def nn_smem(chunk: int, n2: int) -> int:
    """Shared memory of one block, as the kernel counts it: a chunk of
    float4, two where the database takes more than one."""
    return (2 if n2 > chunk else 1) * chunk * POINT_BYTES


def nn_chunk(n2: int) -> int:
    """Points staged at a time for a database of n2: all of them, rounded
    up to 32, up to MAX_CHUNK."""
    return min(-(-n2 // 32) * 32, MAX_CHUNK)


def make(n1: int, n2: int, lanes: int, queries: int) -> NnPlan:
    """The plan with L = lanes and Q = queries: a block as wide as one
    cloud's queries need (up to MAX_WARPS), the chunk by `nn_chunk`."""
    need = -(-n1 // queries) * lanes            # lanes a cloud's queries take
    warps = max(1, min(MAX_WARPS, -(-need // 32)))
    return NnPlan(lanes, queries, warps, nn_chunk(n2))


def valid(plan: NnPlan, b: int, n1: int, n2: int) -> bool:
    """Whether the kernel takes `plan` for B clouds of n1 queries over n2
    points."""
    return (plan.lanes in LANES and plan.queries in QUERIES
            and 1 <= plan.warps <= MAX_WARPS
            and 32 <= plan.chunk <= MAX_CHUNK and plan.chunk % 32 == 0
            and min(b, n1, n2) >= 1 and plan.grid(b, n1) <= MAX_GRID
            and n1 <= MAX_GRID - 32 * MAX_WARPS * QUERIES[-1])


def candidates(b: int, n1: int, n2: int) -> list[NnPlan]:
    """Every (L, Q) the kernel takes, each with `make`'s block and chunk."""
    return [p for p in (make(n1, n2, lanes, q)
                        for lanes in LANES for q in QUERIES)
            if valid(p, b, n1, n2)]


def plan(b: int, n1: int, n2: int, sms: int) -> NnPlan:
    """The plan for B clouds of n1 queries over n2 points on a card of
    `sms` SMs."""
    if min(b, n1, n2, sms) < 1:
        raise ValueError(f"nn plan needs positive sizes, got b={b}, n1={n1}, "
                         f"n2={n2}, sms={sms}")
    most = 1                            # lanes that keep enough points
    while most < LANES[-1] and 2 * most * POINTS_PER_LANE <= n2:
        most *= 2
    lanes, queries = 1, PLAN_QUERIES
    while lanes < most and b * n1 * lanes < sms * THREADS_PER_SM * queries:
        lanes *= 2
    while queries > 1 and b * n1 * lanes < sms * MIN_THREADS_PER_SM * queries:
        queries //= 2
    out = make(n1, n2, lanes, queries)
    if not valid(out, b, n1, n2):
        raise ValueError(f"B={b} clouds of N1={n1} queries exceed the nn "
                         f"kernel's flat grid ({MAX_GRID} blocks)")
    return out
