"""The host-side planning of the bslab windowed kernel K7, on the CPU.

K7 (``ops/bslab_spmv.py``, ``csrc/bslab_spmv.cu``) keeps each tile's
window of x rows [wchunk W, wchunk W + 2W) in a ring of W-row chunks in
shared memory, spread over a thread-block cluster where one block cannot
hold it. Two pieces of its plan run on the host and are held here to plain
references:

* ``win_plan``: the unit's cluster size and ring depth, against a direct
  search over the shared-memory budget, on the JAX package's window plans
  (``_window_plan`` on the stencil's and the RGL matrix's slice ranges at
  100^3, 200^3 and RGL 2M, built from lo/hi arrays, not as matrices);
* the kernel's walk of lane groups, tiles and the chunk ring, written
  here in Python (``k7_schedule``). On JAX-built layouts every slice row
  that every step reads lies in its tile's window and in a resident chunk,
  every lane group is computed once, and a chunk is copied only when the
  tile's chunk changes, and then only the chunks that were not resident.
"""

from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.bslab import _OFFSETS_27  # noqa: E402
from sparsebench_tpu.formats.bslab import _window_plan as jax_window_plan  # noqa: E402
from sparsebench_tpu.formats.rgl_build import rgl_bslab as jax_rgl  # noqa: E402
from sparsebench_tpu_torch.ops.bslab_spmv import (  # noqa: E402
    BAR_BYTES,
    LANES,
    MAX_CLUSTER,
    SMEM_BYTES,
    Slices,
    win_plan,
)

DT = {"f32": torch.float32, "f64": torch.float64}
WARPS = 32  # a K7 block's warps (csrc/bslab_spmv.cu kThreadsK7 / 32)


class Step(NamedTuple):
    """One step of a K7 unit: lane groups [g0, g1) of tile ``tile``, whose
    window starts at chunk ``chunk``, with ``resident`` the chunk in each
    ring slot and ``copied`` the chunks fetched for it."""
    tile: int
    g0: int
    g1: int
    chunk: int
    resident: tuple
    copied: tuple


def unit_range(u, units, total):
    """Lane groups [g0, g1) of unit u of ``units`` (the kernels'
    unit_range)."""
    return u * total // units, (u + 1) * total // units


def k7_schedule(wchunk, sub, units, ring, cluster=1):
    """K7's walk (csrc/bslab_spmv.cu bslab_spmv_win_kernel), in Python: for
    each unit, its steps in order. A unit walks its lane groups a step of
    WARPS * cluster at a time, never crossing a tile; where a tile's chunk c
    differs from the last one it claims chunks c .. c + ring - 1, chunk k
    in slot k % ring, and copies those not resident."""
    wchunk = [int(c) for c in wchunk]
    total = len(wchunk) * sub
    out = []
    for u in range(units):
        g0, g1 = unit_range(u, units, total)
        resident = [-1] * ring
        steps, cur_t, cur_c = [], -1, -1
        g = g0
        while g < g1:
            t = g // sub
            end = min(g1, (t + 1) * sub, g + WARPS * cluster)
            copied = ()
            if t != cur_t:
                if wchunk[t] != cur_c:
                    cur_c = wchunk[t]
                    for k in range(cur_c, cur_c + ring):
                        if resident[k % ring] != k:
                            resident[k % ring] = k
                            copied += (k,)
                cur_t = t
            steps.append(Step(t, g, end, cur_c, tuple(resident), copied))
            g = end
        out.append(steps)
    return out


def stencil_meta(n, sub):
    """dbase (n_tiles, S) of the n^3 27-point stencil's slab slices, as the
    JAX package's ``from_stencil`` builds them, and lead."""
    nr = n ** 3
    plane, lead = n * n, sub
    specs = sorted((sz * plane + sy * n + sx) for (sz, sy, sx) in _OFFSETS_27)
    d = []
    for off in specs:
        q, r = divmod(off, LANES)
        d.append(q)
        if r:
            d.append(q + 1)
    n_tiles = -(-nr // (sub * LANES))
    x_rows = lead + -(-nr // LANES) + sub
    t = np.arange(n_tiles)[:, None]
    dbase = np.clip(sub * t + np.asarray(d)[None, :] + lead, 0, x_rows - sub)
    return dbase, lead


def stencil_window(n, sub):
    dbase, _ = stencil_meta(n, sub)
    return jax_window_plan(dbase.shape[0], dbase.min(1), dbase.max(1), sub)


def meta_slices(s_aff, s_gen=0, s_wide=0):
    """A one-tile Slices of empty planes with the given slice counts (the
    plan reads only the metadata size)."""
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt)  # noqa: E731
    i8 = torch.int8
    return Slices(z(1, s_aff, 2, dt=torch.int32), z(1, s_aff, 8, 0),
                  z(1, s_gen, 1, dt=torch.int32), z(1, s_gen, 8, 0),
                  z(1, s_gen, 8, 0, dt=i8), z(1, s_wide, 1, dt=torch.int32),
                  z(1, s_wide, 8, 0), z(1, s_wide, 8, 0, dt=i8),
                  z(1, s_wide, 8, 0, dt=i8))


def plain_plan(w_blocks, itemsize, meta, cluster=0):
    """(cluster, ring): the smallest cluster of 1-8 blocks (or the one
    given) whose blocks hold two W-row chunks, split in ceil(W / C)-row
    stripes, beside their mbarriers and the tile's metadata; three chunks
    where they fit in that cluster too. None where two do not fit."""
    def need(c, ring):
        return (BAR_BYTES + ring * -(-w_blocks // c) * 128 * itemsize
                + meta)
    for c in ([cluster] if cluster else range(1, 9)):
        if need(c, 2) <= 232_448:
            return c, 3 if need(c, 3) <= 232_448 else 2
    return None


# -- the window plan -------------------------------------------------------------


def test_stencil_window_plans_equal_the_measured_shapes():
    """The JAX package's chunk plan at 100^3 (sub 64) and 200^3 (sub 128):
    W 224 and 760 rows, 53 affine slices."""
    for n, sub, w in ((100, 64, 224), (200, 128, 760)):
        w_blocks, wchunk, _ = stencil_window(n, sub)
        assert w_blocks == w
        assert np.all(np.diff(wchunk) >= 0) and np.all(np.diff(wchunk) <= 1)
    assert stencil_meta(100, 64)[0].shape == (123, 53)


@pytest.mark.parametrize("n,sub,dt,want", [
    (100, 64, "f32", (1, 2)),    # 2W x 512 B = 224 KB: one block
    (100, 64, "f64", (2, 2)),
    (200, 128, "f32", (4, 2)),   # 778 KB: a cluster of 4
    (200, 128, "f64", (7, 2)),   # 1.56 MB: 7 blocks of 213 KB
])
def test_win_plan_on_the_stencil(n, sub, dt, want):
    w_blocks, _, _ = stencil_window(n, sub)
    sl = meta_slices(53)
    plan = win_plan(sl, w_blocks, DT[dt])
    assert (plan.cluster, plan.ring) == want
    assert (plan.cluster, plan.ring) == plain_plan(
        w_blocks, DT[dt].itemsize, 4 * 2 * 53)
    assert plan.stripe == -(-w_blocks // plan.cluster)
    assert plan.smem <= SMEM_BYTES


def test_win_plan_on_the_rgl_layout():
    """RGL at 2M (band 512, sub 64): the slice starts of a tile span the
    nine block diagonals, W = 72 rows, and one block holds a ring of
    three; the JAX package's small RGL layouts plan one block too."""
    d_min, d_max, sub = -4, 4, 64
    n_tiles = -(-2_000_000 // (sub * LANES))
    t = np.arange(n_tiles)
    lo, hi = sub * t + d_min + sub, sub * t + d_max + sub
    w_blocks, _, _ = jax_window_plan(n_tiles, lo, hi, sub)
    assert w_blocks == 72
    plan = win_plan(meta_slices(0, 107), w_blocks, torch.float32)
    assert (plan.cluster, plan.ring) == (1, 3)
    Aj, _ = jax_rgl(3000, band=200, deg=10.0, seed=5, sub=16,
                    policy=JaxPolicy.from_names("f32", "i32"))
    sl = meta_slices(Aj.s_aff, Aj.s_gen, Aj.s_wide)
    for dt in ("f32", "f64"):
        assert win_plan(sl, Aj.w_blocks, DT[dt]).cluster == 1


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("meta", [0, 424, 4096])
def test_win_plan_equals_the_plain_search(dt, meta):
    """Every W from 8 to 2000 rows (multiples of 8): the plan's cluster and
    ring equal the direct search, or both refuse."""
    sl = meta_slices(meta // 8)
    itemsize = DT[dt].itemsize
    for w_blocks in range(8, 2001, 8):
        want = plain_plan(w_blocks, itemsize, 4 * 2 * (meta // 8))
        if want is None:
            with pytest.raises(ValueError, match="cluster of 8"):
                win_plan(sl, w_blocks, DT[dt])
        else:
            plan = win_plan(sl, w_blocks, DT[dt])
            assert (plan.cluster, plan.ring) == want, w_blocks


def test_win_plan_forced_cluster_and_refusals():
    w100, _, _ = stencil_window(100, 64)
    w200, _, _ = stencil_window(200, 128)
    sl = meta_slices(53)
    # a forced cluster of 2 where one block would do: room for three chunks
    plan = win_plan(sl, w100, torch.float32, cluster=2)
    assert (plan.cluster, plan.ring, plan.stripe) == (2, 3, 112)
    # 200^3 with a third chunk: clusters of 6 and 8
    assert win_plan(sl, w200, torch.float32, cluster=6).ring == 3
    assert win_plan(sl, w200, torch.float32, cluster=8).ring == 3
    with pytest.raises(ValueError, match="cluster of 2"):
        win_plan(sl, w200, torch.float32, cluster=2)
    # above a cluster of 8: the refusal names the bytes and the cluster
    with pytest.raises(ValueError, match=r"\d+ B of shared memory a block in "
                       r"a cluster of 8"):
        win_plan(sl, 4000, torch.float32)
    for bad in (9, -1):
        with pytest.raises(ValueError, match="cluster size"):
            win_plan(sl, w100, torch.float32, cluster=bad)
    assert MAX_CLUSTER == 8


# -- the persistent schedule -------------------------------------------------------


def check_walk(schedule, wchunk, w_blocks, sub, ring, rows_of):
    """The plain reference of K7's walk: ``rows_of(t, s)`` are the x rows
    lane group s of tile t reads. Returns the chunks copied."""
    n_groups = len(wchunk) * sub
    seen = np.zeros(n_groups, np.int64)
    copies = 0
    for steps in schedule:
        last = None
        for st in steps:
            c = int(wchunk[st.tile])
            assert st.chunk == c
            assert st.tile * sub <= st.g0 < st.g1 <= (st.tile + 1) * sub
            # a chunk is copied only when the tile's chunk changes, and
            # only one that was not resident
            if st.copied:
                assert c != last
                assert last is None or all(
                    k not in range(last, last + ring) for k in st.copied)
            assert {c, c + 1} <= set(st.resident)
            assert len(set(st.resident)) == ring
            for g in range(st.g0, st.g1):
                rows = rows_of(st.tile, g - st.tile * sub)
                assert rows.min() >= c * w_blocks
                assert rows.max() < (c + 2) * w_blocks
                assert set(np.unique(rows // w_blocks)) <= set(st.resident)
            seen[st.g0:st.g1] += 1
            copies += len(st.copied)
            last = c
    np.testing.assert_array_equal(seen, 1)
    return copies


def expected_copies(schedule, wchunk, ring):
    """Chunks a unit must fetch: the first window's ring, then at each
    chunk change the claimed chunks that the last claim did not hold."""
    total = 0
    for steps in schedule:
        held = set()
        for c in [int(wchunk[st.tile]) for st in steps]:
            claim = set(range(c, c + ring))
            if claim != held:
                total += len(claim - held)
                held = claim
    return total


@pytest.mark.parametrize("units", [132, 33, 3])
@pytest.mark.parametrize("ring", [2, 3])
def test_schedule_on_the_stencil_at_100_cubed(units, ring):
    """The JAX package's 100^3 plan (123 tiles, 35 chunks): with 3 units a
    block's run crosses about 12 chunk changes."""
    dbase, _ = stencil_meta(100, 64)
    w_blocks, wchunk, _ = stencil_window(100, 64)
    sched = k7_schedule(wchunk, 64, units, ring)
    copies = check_walk(sched, wchunk, w_blocks, 64, ring,
                        lambda t, s: dbase[t] + s)
    assert copies == expected_copies(sched, wchunk, ring)
    if units == 3:
        changes = [len({int(wchunk[st.tile]) for st in steps})
                   for steps in sched]
        assert min(changes) >= 10
        # one new chunk a change of chunk: the upper half is reused
        assert copies == sum(ring + ch - 1 for ch in changes)


def test_schedule_at_200_cubed_in_clusters():
    """200^3 (489 tiles, W 760) in clusters of 4: 33 units, a step of 128
    lane groups (4 blocks of 32 warps), one tile a step."""
    dbase, _ = stencil_meta(200, 128)
    w_blocks, wchunk, _ = stencil_window(200, 128)
    sched = k7_schedule(wchunk, 128, 33, 2, cluster=4)
    assert all(st.g1 - st.g0 <= WARPS * 4 for steps in sched for st in steps)
    copies = check_walk(sched, wchunk, w_blocks, 128, 2,
                        lambda t, s: dbase[t] + s)
    assert copies == expected_copies(sched, wchunk, 2)


@pytest.mark.parametrize("layout", [
    (3000, 200, 10.0, 5, 16, {}),
    (900, 128, 10.0, 11, 8, dict(force_caps=(1,) * 3, force_span=2)),
])
@pytest.mark.parametrize("units", [5, 40])
def test_schedule_on_jax_rgl_layouts(layout, units):
    """The JAX package's RGL layouts, general and wide slices: the rows of
    every slice, with each lane's block delta, stay in the window."""
    n, band, deg, seed, sub, opts = layout
    A, _ = jax_rgl(n, band=band, deg=deg, seed=seed, sub=sub,
                   policy=JaxPolicy.from_names("f32", "i32"), **opts)
    mg = np.asarray(A.meta_gen)[:, :, 0]
    mw = np.asarray(A.meta_wide)[:, :, 0]
    dblk = np.asarray(A.dblk_wide).astype(np.int64)
    wchunk = np.asarray(A.wchunk)

    def rows_of(t, s):
        rows = [mg[t] + s]
        if A.s_wide:
            rows.append((mw[t][:, None] + s + dblk[t, :, s, :]).ravel())
        return np.concatenate(rows)

    for ring in (2, 3):
        sched = k7_schedule(wchunk, sub, units, ring)
        copies = check_walk(sched, wchunk, A.w_blocks, sub, ring, rows_of)
        assert copies == expected_copies(sched, wchunk, ring)
    if opts:
        assert A.s_wide > 0 and dblk.max() > 0


def test_schedule_when_the_chunk_jumps():
    """A chunk plan that jumps ahead and back inside one unit's run: the
    window's chunks are resident at every step and a chunk is fetched
    again only after it left the ring."""
    wchunk = np.array([0, 0, 1, 3, 2, 2, 7, 4, 4, 5], np.int32)
    w_blocks, sub = 16, 8
    for ring in (2, 3):
        sched = k7_schedule(wchunk, sub, 1, ring)
        copies = check_walk(sched, wchunk, w_blocks, sub, ring,
                            lambda t, s: np.array([wchunk[t] * w_blocks + s]))
        assert copies == expected_copies(sched, wchunk, ring)


@pytest.mark.parametrize("units", [1, 7, 132, 500])
def test_unit_ranges_split_the_lane_groups_evenly(units):
    total = 123 * 64
    ranges = [unit_range(u, units, total) for u in range(units)]
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [g1 - g0 for g0, g1 in ranges]
    assert max(sizes) - min(sizes) <= 1
