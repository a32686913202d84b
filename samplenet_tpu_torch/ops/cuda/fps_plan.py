"""Launch plan of the seeded-FPS kernel: pure Python, so that the CPU tests
reach it (csrc/fps.cu; the constants below are the kernel's own).

The kernel runs one block of `warps` warps a cloud. Thread t of its T
threads holds `points` (R) points of the cloud, t, t + T, ..., in
registers with their running distances; R is one of REG_POINTS, and the
registers cap the block at `max_threads(R)`. A cloud longer than the
widest block can hold that way takes the `shared` variant: R =
SHARED_POINTS distances a thread, each point's xyz reread from shared
memory every step. Every block stages the whole cloud in shared memory
(12 bytes a point), which caps N.

The plan spreads a cloud over more warps, up to PLAN_WARPS and one a 32
points, while the batch leaves the card short of WARPS_PER_SM warps an SM
(two warps a cloud at B=1024 on 132 SMs, eight at B=50), then takes the
fewest points a thread that hold the cloud. PERF.md has the sweep of
warps and points on an H100 these rules were fitted to
(tools/time_fps.py). The kernel's outputs do not depend on the plan.

Where no such plan fits (N above 16,384, or the cloud and the picks beyond
a block's shared memory), the cluster variant takes the cloud:
CLUSTER_BLOCKS blocks of CLUSTER_THREADS a cloud (one thread-block cluster
of the portable size), each staging its slice of the cloud
(CLUSTER_THREADS * R points, 12 bytes each) in shared memory and holding R
running distances a thread in registers, R the fewest of CLUSTER_POINTS
that hold the cloud; past that (more than 131,072 points), `stream`: the
running distances in a [B, N] workspace in device memory and the xyz read
from it every step. k costs it no shared memory; every cloud it gets has
7,000 points or more. Only int32 indexing caps N.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_WARPS = 32                      # kMaxWarps: 1024 threads
REG_POINTS = (1, 2, 4, 8, 16, 32)   # the kernels' R with xyz held
SHARED_POINTS = 16                  # kSharedPoints
PLAN_WARPS = 8                      # the widest block the plan picks
WARPS_PER_SM = 12
SLOT_BYTES = 2 * MAX_WARPS * 8      # two rows of (bits, index) a warp
# the cluster variant (fps_cluster_kernel)
CLUSTER_BLOCKS = 8                  # kClusterBlocks: blocks a cloud
CLUSTER_THREADS = 1024              # kClusterThreads
GIVEN_CHUNK = 256                   # kGivenChunk: given points staged at once
CLUSTER_POINTS = (1, 2, 4, 8, 16)   # its R with the slice in shared memory
MAX_POINTS = 2**31 - 1              # int32 indexing


@dataclass(frozen=True)
class FpsPlan:
    warps: int       # a block has 32 * warps threads
    points: int      # R, points a thread (cluster variant: 0 streamed)
    shared: bool     # xyz reread from shared memory every step
    cluster: bool = False   # the cluster variant; else one block a cloud

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def stream(self) -> bool:
        """The cluster variant with the distances in device memory."""
        return self.cluster > 0 and self.points == 0

    @property
    def capacity(self) -> int:
        """Points a block holds (a cluster in the cluster variant; the
        streamed variant holds any cloud)."""
        if self.stream:
            return MAX_POINTS
        return self.threads * self.points * (
            CLUSTER_BLOCKS if self.cluster else 1)


def max_threads(points: int, shared: bool) -> int:
    """The widest block of the kernel with `points` a thread, as its
    __launch_bounds__ say."""
    if shared:
        return 1024
    return 256 if points >= 32 else (512 if points >= 16 else 1024)


def fps_smem(n: int, k: int) -> int:
    """Shared memory of one block, as the kernel counts it: the warps'
    slots, the cloud (3n floats, padded to 16 bytes), the given points'
    xyz (float4 each) and the picks (int32 each)."""
    return SLOT_BYTES + -(-12 * n // 16) * 16 + 20 * k


def cluster_smem(points: int) -> int:
    """Dynamic shared memory of a block of the cluster variant, as the
    kernel counts it: its slice of the cloud, 12 bytes a point."""
    return CLUSTER_THREADS * points * 12


def valid(plan: FpsPlan, n: int) -> bool:
    """Whether the kernel takes `plan` for a cloud of n points."""
    if plan.cluster:
        return (not plan.shared and plan.threads == CLUSTER_THREADS
                and (plan.stream or plan.points in CLUSTER_POINTS)
                and plan.capacity >= n)
    allowed = (SHARED_POINTS,) if plan.shared else REG_POINTS
    return (1 <= plan.warps <= MAX_WARPS and plan.points in allowed
            and plan.threads <= max_threads(plan.points, plan.shared)
            and plan.capacity >= n)


def candidates(n: int) -> list[FpsPlan]:
    """Every plan the kernel takes for a cloud of n points, the register
    variants first, narrow blocks first."""
    out = []
    warps = 1
    while warps <= MAX_WARPS:
        out += [p for p in (FpsPlan(warps, r, False) for r in REG_POINTS)
                if valid(p, n)]
        warps *= 2
    shared = FpsPlan(MAX_WARPS, SHARED_POINTS, True)
    return out + ([shared] if valid(shared, n) else [])


def plan_fps(b: int, n: int, k: int, *, sms: int,
             smem_limit: int) -> FpsPlan:
    """The plan for B clouds of n points and k picks on a card of `sms`
    SMs whose blocks may hold `smem_limit` bytes of shared memory."""
    if min(b, n, k, sms) < 1:
        raise ValueError(f"plan_fps needs positive sizes, got b={b}, n={n}, "
                         f"k={k}, sms={sms}")
    if max(n, k, b * CLUSTER_BLOCKS) > MAX_POINTS:
        raise ValueError(f"B={b}, N={n}, k={k} exceed int32 indexing")
    if fps_smem(n, k) <= smem_limit:
        floor = 1          # no wider than the cloud: a warp of 32 points
        while (floor < PLAN_WARPS and b * floor < sms * WARPS_PER_SM
               and 32 * floor < n):
            floor *= 2
        for plan in candidates(n):
            if plan.warps >= floor:
                return plan
    return plan_cluster(n, smem_limit=smem_limit)


def plan_cluster(n: int, *, smem_limit: int) -> FpsPlan:
    """The cluster variant's plan for a cloud of n points: the fewest
    points a thread that hold the cloud in registers, else streamed."""
    for r in CLUSTER_POINTS:
        plan = FpsPlan(CLUSTER_THREADS // 32, r, False, True)
        if valid(plan, n) and cluster_smem(r) <= smem_limit:
            return plan
    return FpsPlan(CLUSTER_THREADS // 32, 0, False, True)
