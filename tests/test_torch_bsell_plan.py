"""The host-side planning of the bsell kernels K9, K10 and K11, on the CPU.

K10 and K11 (``ops/bsell_spmv.py``, ``csrc/bsell_spmv.cu``) keep each
tile's window of x rows [wchunk W, wchunk W + 2W) in a ring of two W-row
chunks in shared memory, spread over a unit of several blocks (``cluster``)
where one block cannot hold it. Two pieces of their plan run on the host
and are held here to plain references:

* ``win_plan``: the unit's blocks, against a direct
  search over the shared-memory budget, at the stencil's W (168 at 100^3,
  640 at 200^3) and over every W up to a cluster of 8 and beyond;
* the kernels' walk of lane groups, steps and the chunk ring, written here
  in Python (``k10_schedule``). On the JAX package's layouts (its
  ``_build_arrays`` for klein, the test matrices and a random banded
  matrix; its analytic stencil window plan at 100^3 and 200^3, taken
  without building the device arrays) every block id that a step reads
  lies in a resident chunk, every lane group is computed once, a step never
  spans a chunk change, and a chunk is copied only when it is not
  resident, backward jumps included;
* K9's walk of lane groups (``k9_schedule``): persistent blocks of 8 warps,
  as many as its launcher starts, each a contiguous run of lane groups, a
  warp a lane group at a time; every lane group computed once, for tile
  counts that do not divide the blocks.
"""

from pathlib import Path
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats import bsell as jax_bsell  # noqa: E402
from sparsebench_tpu.host import HostCSR as JaxCSR  # noqa: E402
from sparsebench_tpu.host import read_mm as jax_read_mm  # noqa: E402
from sparsebench_tpu_torch.ops.bsell_spmv import (  # noqa: E402
    BAR_BYTES,
    LANES,
    MAX_CLUSTER,
    ROW_BUF_BYTES,
    SMEM_BYTES,
    SUBLANES,
    win_plan,
)

DATA = Path(__file__).parent / "data"
DT = {"f32": torch.float32, "f64": torch.float64}
WARPS = 32  # a K10/K11 block's warps (csrc/bsell_spmv.cu kWarpsWin)
WARPS_K9 = 8  # a K9 block's warps (kWarpsK9)
RING = 2    # chunks in a block's ring (kRing)
F32 = JaxPolicy.from_names("f32", "i32")


class Step(NamedTuple):
    """One step of a K10/K11 unit: lane groups [g0, g1), a warp each, all of
    tiles whose window starts at chunk ``chunk``, with ``resident`` the chunk
    in each ring slot and ``copied`` the chunks fetched for it."""
    g0: int
    g1: int
    chunk: int
    resident: tuple
    copied: tuple


def unit_range(u, units, total):
    """Lane groups [g0, g1) of unit u of ``units`` (the kernels' split)."""
    return u * total // units, (u + 1) * total // units


def k10_schedule(wchunk, units, cluster=1):
    """K10/K11's walk (csrc/bsell_spmv.cu bsell_spmv_win_kernel), in
    Python: for each unit, its steps in order. A step takes up to WARPS *
    cluster consecutive lane groups and ends early at the first tile whose
    chunk differs from the step's first; where the step's chunk c differs
    from the last one the unit claims chunks c and c + 1, chunk k in slot
    k % RING, and copies those not resident."""
    wchunk = [int(c) for c in wchunk]
    total = len(wchunk) * SUBLANES
    out = []
    for u in range(units):
        g0, g1 = unit_range(u, units, total)
        resident = [None] * RING
        steps, cur = [], None
        g = g0
        while g < g1:
            t = g // SUBLANES
            c = wchunk[t]
            end = min(g1, g + WARPS * cluster)
            tt = t + 1
            while tt * SUBLANES < end:
                if wchunk[tt] != c:
                    end = tt * SUBLANES
                    break
                tt += 1
            copied = ()
            if c != cur:
                for k in range(c, c + RING):
                    if resident[k % RING] != k:
                        resident[k % RING] = k
                        copied += (k,)
                cur = c
            steps.append(Step(g, end, c, tuple(resident), copied))
            g = end
        out.append(steps)
    return out


def check_walk(schedule, wchunk, blocks, w_blocks, cluster=1):
    """The plain reference of the walk on a layout's ``blocks`` (n_tiles,
    s_max, 8), window-relative: every lane group once, a step's tiles all on
    its chunk, every x row a step reads in a resident chunk of its window,
    copies only of chunks that were not resident, at a chunk change.
    Returns the chunks copied."""
    wchunk = np.asarray(wchunk, np.int64)
    blocks = np.asarray(blocks, np.int64)
    seen = np.zeros(len(wchunk) * SUBLANES, np.int64)
    copies = 0
    for steps in schedule:
        last = None
        for st in steps:
            assert 0 < st.g1 - st.g0 <= WARPS * cluster
            g = np.arange(st.g0, st.g1)
            t, s = g // SUBLANES, g % SUBLANES
            assert np.all(wchunk[t] == st.chunk)
            if st.copied:
                assert st.chunk != last
                assert last is None or all(
                    k not in range(last, last + RING) for k in st.copied)
            assert {st.chunk, st.chunk + 1} <= set(st.resident)
            assert len(set(st.resident)) == RING
            rows = wchunk[t][:, None] * w_blocks + blocks[t, :, s]
            assert rows.min() >= st.chunk * w_blocks
            assert rows.max() < (st.chunk + 2) * w_blocks
            assert set(np.unique(rows // w_blocks)) <= set(st.resident)
            seen[st.g0:st.g1] += 1
            copies += len(st.copied)
            last = st.chunk
    np.testing.assert_array_equal(seen, 1)
    return copies


def expected_copies(schedule):
    """Chunks a unit must fetch: the first window's ring, then at each
    chunk change the claimed chunks that the last claim did not hold."""
    total = 0
    for steps in schedule:
        held = set()
        for st in steps:
            claim = set(range(st.chunk, st.chunk + RING))
            if claim != held:
                total += len(claim - held)
                held = claim
    return total


def stencil_plan(nx, ny, nz):
    """The 27-point stencil's window plan and block table as the JAX
    package's ``from_stencil`` computes them (formats/bsell.py: the slice
    plan, W and wchunk, and ``_stencil_bsell_device``'s block ids), in
    numpy, without building the value and index planes. Returns
    (w_blocks, wchunk, blocks)."""
    nr, plane = nx * ny * nz, nx * ny
    specs = sorted(sz * plane + sy * nx + sx
                   for (sz, sy, sx) in jax_bsell._OFFSETS_27)
    slices = []
    for off in specs:
        q, r = divmod(off, LANES)
        slices.append((q, 0))
        if r:
            slices.append((q, 1))
    q_min = min(q for q, b in slices if not b)
    q_max_eff = max(q + b for q, b in slices)
    n_tiles = max(1, -(-nr // (SUBLANES * LANES)))
    nb = max(LANES, -(-nr // LANES) * LANES) // LANES
    w_blocks = -(-(SUBLANES + q_max_eff - q_min) // 8) * 8
    t = np.arange(n_tiles, dtype=np.int64)
    wchunk = np.maximum(SUBLANES * t + q_min, 0) // w_blocks
    qoff = np.array([q + b for q, b in slices], np.int64)
    absb = SUBLANES * t[:, None, None] + np.arange(SUBLANES)[None, None, :] \
        + qoff[None, :, None]
    rel = np.clip(absb, 0, nb - 1) - (wchunk * w_blocks)[:, None, None]
    return w_blocks, wchunk, np.clip(rel, 0, 2 * w_blocks - 1)


def plain_plan(w_blocks, itemsize, cluster=0):
    """The smallest unit of 1-8 blocks (or the one given) whose blocks hold
    two W-row chunks, split in ceil(W / C)-row stripes, beside their
    mbarriers and, in a unit of several, 32 warps' row buffers of 32 KB.
    None where none does."""
    for c in ([cluster] if cluster else range(1, 9)):
        need = (128 + 2 * -(-w_blocks // c) * 128 * itemsize
                + (32 * 1024 if c > 1 else 0))
        if need <= 232_448:
            return c
    return None


def banded_jax_csr(n, band, density, seed):
    rng = np.random.default_rng(seed)
    per_row = max(1, int(density * (2 * band + 1)))
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-band, band + 1, rows.size), 0, n - 1)
    keys = np.unique(np.concatenate([rows * n + cols,
                                     np.arange(n) * (n + 1)]))
    r, c = keys // n, keys % n
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=row_ptr[1:])
    return JaxCSR(row_ptr=row_ptr, col=c.astype(np.int64),
                  val=rng.standard_normal(r.size), nr=n, nc=n)


def jax_layout(name):
    """(wchunk, blocks, w_blocks) of the JAX package's host build."""
    if name == "banded":
        csr = banded_jax_csr(20_000, 300, 0.05, 3)
    else:
        csr = JaxCSR.from_coo(jax_read_mm(str(DATA / name)))
    out = jax_bsell._build_arrays(csr, F32)
    blocks, wchunk, w_blocks = out[2], out[4], out[8]
    return wchunk, blocks, w_blocks


# -- the plan --------------------------------------------------------------------


def test_stencil_window_plans_equal_the_jax_build():
    """The analytic plan equals the JAX package's from_stencil on a small
    grid, block table included, and gives W 168 at 100^3 and 640 at 200^3
    with the chunk advancing every 21 and 80 tiles."""
    A, _ = jax_bsell.BsellMatrix.from_stencil(20, 20, 12, impl="xla")
    w_blocks, wchunk, blocks = stencil_plan(20, 20, 12)
    assert w_blocks == A.w_blocks
    np.testing.assert_array_equal(wchunk, np.asarray(A.wchunk))
    np.testing.assert_array_equal(blocks, np.asarray(A.blocks))
    for n, w, every in ((100, 168, 21), (200, 640, 80)):
        w_blocks, wchunk, _ = stencil_plan(n, n, n)
        assert w_blocks == w
        steps = np.flatnonzero(np.diff(wchunk))
        assert np.all(np.diff(wchunk) <= 1)
        assert np.all(np.diff(steps) == every)


@pytest.mark.parametrize("w,dt,want", [
    (168, "f32", 1),    # 2W x 512 B = 172,032 B: one block
    (168, "f64", 2),    # 344,064 B: a unit of 2
    (640, "f32", 4),    # 655,360 B: 3 blocks hold it, not with buffers
    (640, "f64", 7),    # 1.31 MB: 7 blocks of 221,312 B
])
def test_win_plan_on_the_stencil(w, dt, want):
    plan = win_plan(w, DT[dt])
    assert plan.cluster == want
    assert plan.cluster == plain_plan(w, DT[dt].itemsize)
    assert plan.stripe == -(-w // plan.cluster)
    assert plan.smem <= SMEM_BYTES
    assert plan.smem == (BAR_BYTES + 2 * plan.stripe * LANES
                         * DT[dt].itemsize
                         + (ROW_BUF_BYTES if plan.cluster > 1 else 0))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_win_plan_equals_the_plain_search(dt):
    """Every W from 8 to 4000 rows (multiples of 8): the plan's unit equals
    the direct search, or both refuse."""
    itemsize = DT[dt].itemsize
    refused = 0
    for w_blocks in range(8, 4001, 8):
        want = plain_plan(w_blocks, itemsize)
        if want is None:
            refused += 1
            with pytest.raises(ValueError, match="cluster of 8"):
                win_plan(w_blocks, DT[dt])
        else:
            plan = win_plan(w_blocks, DT[dt])
            assert plan.cluster == want, w_blocks
    assert refused > 0


def test_win_plan_forced_cluster_and_refusals():
    # a forced unit of 2 where one block would do: half the rows a block
    plan = win_plan(168, torch.float32, cluster=2)
    assert (plan.cluster, plan.stripe) == (2, 84)
    assert plan.smem == BAR_BYTES + 2 * 84 * LANES * 4 + ROW_BUF_BYTES
    assert win_plan(640, torch.float32, cluster=8).stripe == 80
    with pytest.raises(ValueError, match="cluster of 3"):
        win_plan(640, torch.float32, cluster=3)
    # above a cluster of 8: the refusal names the bytes and the cluster
    with pytest.raises(ValueError, match=r"\d+ B of shared memory a block in "
                       r"a cluster of 8"):
        win_plan(4000, torch.float32)
    for bad in (9, -1):
        with pytest.raises(ValueError, match="cluster size"):
            win_plan(168, torch.float32, cluster=bad)
    with pytest.raises(ValueError, match="positive"):
        win_plan(0, torch.float32)
    assert MAX_CLUSTER == 8


# -- the persistent schedule -------------------------------------------------------


@pytest.mark.parametrize("n,units,cluster", [
    (100, 132, 1), (100, 3, 1), (100, 1, 1), (100, 66, 2), (100, 33, 4),
    (200, 132, 1), (200, 33, 4), (200, 2, 4), (200, 18, 7), (200, 16, 8)])
def test_schedule_on_the_stencil(n, units, cluster):
    """The analytic stencil layouts at 100^3 (977 tiles, W 168) and 200^3
    (7813 tiles, W 640) in the units the card runs (132 blocks, one an SM,
    in units of ``cluster``) and in fewer: one new chunk a chunk change,
    the upper half of the last window kept."""
    w_blocks, wchunk, blocks = stencil_plan(n, n, n)
    sched = k10_schedule(wchunk, units, cluster)
    copies = check_walk(sched, wchunk, blocks, w_blocks, cluster)
    assert copies == expected_copies(sched)
    changes = [len({st.chunk for st in steps}) for steps in sched]
    assert copies == sum(RING + ch - 1 for ch in changes)
    if units == 3:
        assert min(changes) >= 10


@pytest.mark.parametrize("name", [
    "matrix_band_klein.mtx", "testMatrices/test0.mtx",
    "testMatrices/test5.mtx", "testMatrices/test9.mtx", "banded"])
@pytest.mark.parametrize("units,cluster", [(1, 1), (5, 1), (40, 2), (7, 4)])
def test_schedule_on_jax_host_layouts(name, units, cluster):
    """The JAX package's host builds: klein, test matrices and a random
    banded matrix of 20k rows, whose chunks may stay, step or jump."""
    wchunk, blocks, w_blocks = jax_layout(name)
    sched = k10_schedule(wchunk, units, cluster)
    copies = check_walk(sched, wchunk, blocks, w_blocks, cluster)
    assert copies == expected_copies(sched)


def test_schedule_when_the_chunk_jumps():
    """A chunk plan that jumps ahead and back inside one unit's run, tile
    by tile: every step stops at a change, the window's chunks are resident
    at every step, and a chunk is fetched again only after it left the
    ring."""
    wchunk = np.array([0, 0, 1, 3, 2, 2, 7, 4, 4, 5, 4], np.int64)
    w_blocks = 16
    blocks = np.broadcast_to(np.arange(2 * w_blocks)[None, :, None],
                             (len(wchunk), 2 * w_blocks, SUBLANES))
    for cluster in (1, 2):
        sched = k10_schedule(wchunk, 1, cluster)
        assert [st.chunk for st in sched[0]] == [0, 1, 3, 2, 7, 4, 5, 4]
        copies = check_walk(sched, wchunk, blocks, w_blocks, cluster)
        assert copies == expected_copies(sched)
    # chunk 5 put chunk 6 into chunk 4's slot, so the step back to 4 copies
    # chunk 4 alone and keeps 5
    sched = k10_schedule(wchunk, 1)
    assert sched[0][-1].copied == (4,)
    assert sched[0][-1].resident == (4, 5)


@pytest.mark.parametrize("units", [1, 7, 132, 500])
def test_unit_ranges_split_the_lane_groups_evenly(units):
    total = 977 * SUBLANES
    ranges = [unit_range(u, units, total) for u in range(units)]
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [g1 - g0 for g0, g1 in ranges]
    assert max(sizes) - min(sizes) <= 1


def k9_grid(n_tiles, resident):
    """K9's blocks (csrc/bsell_spmv.cu launch): as many as fit the card at
    once, no more than it takes to give every warp a lane group."""
    return min(resident, -(-(n_tiles * SUBLANES) // WARPS_K9))


def k9_schedule(n_tiles, units):
    """K9's walk (bsell_spmv_kernel), in Python: for each block, the lane
    groups each of its warps computes, in order (warp w: g0 + w, g0 + w +
    8, ... below g1)."""
    total = n_tiles * SUBLANES
    return [[list(range(unit_range(u, units, total)[0] + w,
                        unit_range(u, units, total)[1], WARPS_K9))
             for w in range(WARPS_K9)] for u in range(units)]


@pytest.mark.parametrize("n_tiles", [1, 3, 13, 977, 7813])
@pytest.mark.parametrize("resident", [1, 5, 132 * 4, 132 * 8])
def test_k9_schedule_computes_every_lane_group_once(n_tiles, resident):
    """977 and 7813 tiles are the stencil's at 100^3 and 200^3; 528 and 1056
    blocks fill the card at 4 and 8 blocks an SM. Each block walks a
    contiguous run of lane groups, its warps in steps of 8 consecutive
    ones, and the runs tile the lane groups: each is computed once, the
    blocks' and the warps' shares differing by at most one."""
    units = k9_grid(n_tiles, resident)
    assert 1 <= units <= resident
    sched = k9_schedule(n_tiles, units)
    total = n_tiles * SUBLANES
    seen = np.zeros(total, np.int64)
    for u, warps in enumerate(sched):
        g0, g1 = unit_range(u, units, total)
        assert sorted(g for gs in warps for g in gs) == list(range(g0, g1))
        for gs in warps:
            assert all(b - a == WARPS_K9 for a, b in zip(gs, gs[1:]))
            seen[gs] += 1
        loads = [len(gs) for gs in warps]
        assert max(loads) - min(loads) <= 1 and sum(loads) > 0
    np.testing.assert_array_equal(seen, 1)
    sizes = [sum(map(len, warps)) for warps in sched]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n,w,cluster", [(100, 168, 1), (200, 640, 4)])
def test_auto_picks_k9_where_k10_could_run(n, w, cluster):
    """bsell's ``auto`` on a CUDA device is K9 (``kernel``) at the 100^3 and
    200^3 stencil shapes, where K10 would also run (one block, a unit of 4):
    K9 measured faster there (formats/bsell.py resolve_impl). On the CPU it
    is the plain version, and the kernels are refused."""
    from sparsebench_tpu_torch.formats.bsell import resolve_impl

    w_blocks, _, _ = stencil_plan(n, n, 1)
    assert w_blocks == w
    assert win_plan(w_blocks, torch.float32).cluster == cluster
    for dt in (torch.float32, torch.float64):
        win_plan(w_blocks, dt)  # K10 holds the window in f64 too
    assert resolve_impl("auto", torch.device("cuda")) == "kernel"
    assert resolve_impl("auto", torch.device("cuda", 0)) == "kernel"
    assert resolve_impl("auto", torch.device("cpu")) == "torch"
    with pytest.raises(ValueError, match="CUDA kernel"):
        resolve_impl("kernel_win2", torch.device("cpu"))
