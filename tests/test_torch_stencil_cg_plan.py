"""The plan of the one-launch CG kernel K5 (sparsebench_tpu_torch
ops/stencil_cg_vmem.py ``cg_plan``, ``block_tiles``) and a torch emulation
of its schedule (csrc/stencil_cg_vmem.cu), on the CPU.

The kernel itself runs only on a CUDA card (tests/test_torch_kernels.py,
``cuda`` marker, which also holds the kernel to ``k5_emulate`` bit for
bit). Here: the plan gives every tile to exactly one block, at 100^3,
200^3, the shapes chip_smoke.py's phase 3b runs and forced R and tz, with
a partial a block for each dot; bad inputs raise; the wrapper passes the
plan to the C entry point and allocates what the design holds. And an
emulation of the kernel's schedule: phase A's tiles in the kernel's order,
each staging p' = r + beta p_old from the p buffer as it stands, the two p
buffers swapped by the parity of k, phase B's streaming pass, and the
partials summed in the kernel's fixed order (a thread's terms in order,
the block's threads by block_sum's tree, the blocks by grid_total). It is
held to the plain version ``stencil_cg_vmem_torch`` bit for bit
elementwise at equal alpha and beta and its history at the tolerances of
chip_smoke.py phase 3b, and to the JAX package's ``stencil_cg_vmem_pallas``
(interpret mode) as tests/test_torch_stencil.py holds the plain version;
the same schedule with one p buffer updated in place differs.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsebench_tpu_torch.formats.stencil import stencil_row_counts
from sparsebench_tpu_torch.ops import stencil as st
from sparsebench_tpu_torch.ops import stencil_cg_vmem as scv
from sparsebench_tpu_torch.ops.stencil import (
    MAX_SERIAL,
    PLAN_ROWS,
    THREADS,
    TILE_X,
    block_origin,
    march_smem,
    stencil_apply_torch,
)
from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
    block_tiles,
    cg_plan,
    stencil_cg_vmem_torch,
)

SMS = 132  # the H100's SMs
# co-resident blocks the plan may be given: 2, 3 and 4 blocks an SM
RESIDENT = (2 * SMS, 3 * SMS, 4 * SMS)
# 100^3, 200^3 and the shapes of chip_smoke.py phase 3b
SHAPES = [(100, 100, 100), (200, 200, 200), (37, 29, 23), (64, 8, 3),
          (130, 2, 3), (2, 2, 2), (1, 1, 1), (10, 9, 8), (8, 8, 8)]
# forced (R, tz): at 100^3 R 2 tz 16 gives 196 tiles, fewer than the
# blocks the card fits (396 in f32, 264 in f64), and R 1 tz 1 5200, many
# more
FORCED = [(2, 16), (1, 1), (8, 4), (2, 3), (4, 8), (1, 32), (8, 1)]


def tile_owners(plan):
    """How many blocks of ``plan`` march each tile."""
    owners = np.zeros(plan.tiles, np.int64)
    for b in range(plan.blocks):
        for t in block_tiles(plan, b):
            owners[t] += 1
    return owners


def coverage(plan, dims):
    """How many tiles of ``plan`` hold each grid point."""
    nx, ny, nz = dims
    hits = np.zeros((nz, ny, nx), np.int32)
    for t in range(plan.tiles):
        x0, y0, z0, z1 = block_origin(plan, nz, t)
        assert 0 <= x0 < nx and 0 <= y0 < ny and 0 <= z0 < z1 <= nz
        hits[z0:z1, y0:y0 + plan.tile_y, x0:x0 + plan.tile_x] += 1
    return hits


def ring_shape(dims, itemsize):
    """Whether the ring form applies to the grid (``ring_rows``)."""
    return scv.ring_rows(dims[0], dims[1], itemsize) is not None


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims", SHAPES)
def test_default_plan_gives_every_tile_to_one_block(dims, itemsize, resident):
    plan = cg_plan(*dims, itemsize, resident)
    assert plan.form == ("ring" if scv.ring_takes(*dims, itemsize)
                         else "march")
    if plan.form == "march":
        assert plan.r == st.plan_rows(dims[1]) and plan.r in PLAN_ROWS
        assert 1 <= plan.tz <= min(MAX_SERIAL // plan.r, dims[2])
        assert plan.smem == march_smem(plan.r, itemsize)
        assert (plan.tile_x, plan.tile_y) == (TILE_X, st.WARPS * plan.r)
    else:
        assert plan.r == plan.tile_y == scv.ring_rows(dims[0], dims[1],
                                                      itemsize)
        assert 1 <= plan.tz <= dims[2]
        assert plan.smem == scv.ring_smem(dims[0], plan.r, itemsize)
        assert plan.tile_x == dims[0] and plan.tiles_x == 1
    assert plan.tiles == plan.tiles_x * plan.tiles_y * plan.runs
    assert plan.runs == -(-dims[2] // plan.tz)
    assert plan.blocks == resident and plan.parts == 2 * resident
    assert (tile_owners(plan) == 1).all()
    assert (coverage(plan, dims) == 1).all()
    # no tz of the same R gives the busiest block fewer staged planes
    best = min(-(-plan.tiles_x * plan.tiles_y * -(-dims[2] // q) // resident)
               * (q + 2) for q in range(1, plan.tz + 1))
    assert -(-plan.tiles // resident) * (plan.tz + 2) <= best


@pytest.mark.parametrize("r,tz", FORCED)
@pytest.mark.parametrize("dims", [(100, 100, 100), (200, 200, 200),
                                  (37, 29, 23), (130, 2, 3), (2, 2, 2)])
def test_forced_plan_gives_every_tile_to_one_block(dims, r, tz):
    plan = cg_plan(*dims, 4, 3 * SMS, r=r, tz=tz)
    assert (plan.r, plan.tz) == (r, tz)
    assert plan.parts == 2 * plan.blocks
    assert (tile_owners(plan) == 1).all()
    assert (coverage(plan, dims) == 1).all()


def test_plan_at_the_main_sizes():
    """At 100^3 three blocks an SM (f32 at R 2 on the card) take the 364
    tiles of the march's runs of 8 planes, one each; at 200^3 two blocks
    an SM (the ring's f32 kernel at R 4 on the card) the ring's 250 tiles
    of 4 whole rows over 40 planes, one a block (the march's runs of 16
    planes gave three tiles a block). Fewer tiles than blocks and many
    more under forced plans."""
    p100 = cg_plan(100, 100, 100, 4, 3 * SMS)
    p200 = cg_plan(200, 200, 200, 4, 2 * SMS)
    m200 = cg_plan(200, 200, 200, 4, 3 * SMS, form="march")
    assert (p100.form, p100.r, p100.tz, p100.tiles) == ("march", 2, 8, 364)
    assert (p200.form, p200.r, p200.tile_y, p200.tz, p200.tiles,
            p200.smem) == ("ring", 4, 4, 40, 250, 19232)
    assert (m200.r, m200.tz, m200.tiles) == (2, 16, 1183)
    assert max(len(block_tiles(p100, b)) for b in range(p100.blocks)) == 1
    assert max(len(block_tiles(p200, b)) for b in range(p200.blocks)) == 1
    assert max(len(block_tiles(m200, b)) for b in range(m200.blocks)) == 3
    few = cg_plan(100, 100, 100, 8, 2 * SMS, r=2, tz=16)
    many = cg_plan(100, 100, 100, 4, 3 * SMS, r=1, tz=1)
    assert few.tiles < few.blocks and many.blocks < many.tiles
    assert len(block_tiles(few, few.blocks - 1)) == 0


@pytest.mark.parametrize("args,kw", [
    ((0, 5, 5, 4, 396), {}), ((5, -1, 5, 4, 396), {}),
    ((5, 5, 5, 2, 396), {}), ((5, 5, 5, 4, 0), {}),
    ((5.0, 5, 5, 4, 396), {}), ((True, 5, 5, 4, 396), {}),
    ((5, 5, 5, 4, 396), {"r": 3}), ((5, 5, 5, 4, 396), {"tz": 0}),
    ((5, 5, 5, 4, 396), {"r": 4, "tz": 9}),
    ((5, 5, 5, 4, 396), {"tz": 2.0}),
    ((2**16, 2**15, 1, 4, 396), {}),
])
def test_bad_plan_inputs_raise(args, kw):
    with pytest.raises(ValueError):
        cg_plan(*args, **kw)


class Recorder:
    """Stands in for the launch: records the entry point and its
    arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, lib, name, device, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("forced", [None, (8, 4)])
def test_wrapper_passes_the_plan(dt, forced, monkeypatch):
    """The launch passes the plan (R, tz, blocks, shared bytes) to the C
    entry point, with r0 and x0 copied, p0 zeros, p1 and w beside them and
    ``parts`` sized from the plan."""
    rec = Recorder()
    monkeypatch.setattr(st, "_call", rec)
    monkeypatch.setattr(scv, "_library", lambda: None)
    dims = (37, 29, 23)
    n = math.prod(dims)
    r0 = torch.ones(n, dtype=dt)
    x0 = torch.full((n,), 2.0, dtype=dt)
    plan = cg_plan(*dims, r0.element_size(), 3 * SMS, *(forced or ()))
    monkeypatch.setattr(scv, "device_cg_plan", lambda v, *a, **k: plan)
    x, hist = scv._launch(r0, x0, 0.5, *dims, 7, True,
                          plan if forced else None)
    (name, args), = rec.calls
    assert name == f"sb_stencil_cg_vmem_{'f32' if dt == torch.float32 else 'f64'}"
    r, p0, p1, w, xk, hk, parts, eps = args[:8]
    assert xk is x and hk is hist and hist.shape == (7,)
    assert torch.equal(r, r0) and r is not r0 and torch.equal(x, x0)
    assert torch.equal(p0, torch.zeros_like(r0))
    assert {p1.shape, w.shape} == {(n,)} and len({id(v) for v in (
        r, p0, p1, w, xk)}) == 5
    assert parts.shape == (plan.parts,) and parts.dtype == dt
    assert eps.dtype == dt and float(eps) == 0.5
    assert tuple(args[8:13]) == (*dims, 1, 7)
    assert tuple(args[13:]) == (plan.r, plan.tz, plan.blocks, plan.smem,
                                int(plan.form == "ring"))


def test_wrapper_memory_accounting():
    """Seven vectors a solve in device memory, five an iteration touches."""
    assert scv.VECTORS == 7 and scv.ITERATION_VECTORS == 5
    assert scv.vmem_cg_viable(200, 200, 200, 8, "cuda", 80 * 10**9)
    assert not scv.vmem_cg_viable(200, 200, 200, 8, "cuda",
                                  7 * 8 * 200**3 - 1)


# -- the emulation of the kernel's schedule --------------------------------


def block_tree(a):
    """block_sum over the last axis of (blocks, 256) values: red[t] +=
    red[t + s] for s = 128, 64, ..., 1; returns red[0] of each block."""
    red = a.clone()
    s = THREADS // 2
    while s:
        red[:, :s] = red[:, :s] + red[:, s:2 * s]
        s //= 2
    return red[:, 0]


def grid_total(parts):
    """Every block's sum of the partials: thread t adds parts[t], parts[t +
    256], ... in order, then the block tree."""
    acc = torch.zeros(THREADS, dtype=parts.dtype)
    for m in range(0, parts.numel(), THREADS):
        seg = parts[m:m + THREADS]
        acc[:seg.numel()] = acc[:seg.numel()] + seg
    return block_tree(acc[None])[0]


def stream_partials(terms, blocks, vec=True):
    """The partials of a streaming pass: thread gid adds its chunks' terms
    (chunk gid, gid + S, ... of V = 16 / itemsize values, in order), then its
    point of the tail; the block tree. ``vec`` False: one value a chunk."""
    n = terms.numel()
    threads = blocks * THREADS
    v = 16 // terms.element_size() if vec else 1
    acc = torch.zeros(threads, dtype=terms.dtype)
    chunks = n // v
    body = terms[:chunks * v].reshape(chunks, v)
    for m in range(0, chunks, threads):
        seg = body[m:m + threads]
        for j in range(v):
            acc[:seg.shape[0]] = acc[:seg.shape[0]] + seg[:, j]
    tail = terms[chunks * v:]
    acc[:tail.numel()] = acc[:tail.numel()] + tail
    return block_tree(acc.reshape(blocks, THREADS))


def march_order(plan, dims):
    """For each step of a thread's phase A serial sum (a tile round m, a
    plane dz of the tile, a row j of the thread's R), the (blocks, 256)
    flat point index each thread adds there, -1 where it adds nothing."""
    nx, ny, nz = dims
    b = torch.arange(plan.blocks)[:, None]
    lane = torch.arange(THREADS)[None] % 32
    warp = torch.arange(THREADS)[None] // 32
    steps = []
    for m in range(-(-plan.tiles // plan.blocks)):
        t = b + m * plan.blocks
        rest = t // plan.tiles_x
        x = (t % plan.tiles_x) * TILE_X + lane
        y0 = (rest % plan.tiles_y) * plan.tile_y + warp * plan.r
        z0 = (rest // plan.tiles_y) * plan.tz
        for dz in range(plan.tz):
            z = z0 + dz
            for j in range(plan.r):
                y = y0 + j
                ok = (t < plan.tiles) & (x < nx) & (y < ny) & (z < nz)
                steps.append(torch.where(ok, (z * ny + y) * nx + x, -1))
    return steps


def ring_order(plan, dims):
    """The ring's steps of a thread's phase A serial sum (a tile round, a
    plane of the tile, a column m of the consumer, a row of the tile's R),
    as ``march_order``: consumer c's column m is ``ring_columns``'; the
    producer warp adds nothing."""
    nx, ny, nz = dims
    per = scv.RING_POINTS // plan.r
    ix = torch.full((THREADS, per), -1)
    for c, row in enumerate(scv.ring_columns(plan, nx)):
        for m, x in enumerate(row):
            if x is not None:
                ix[c, m] = x
    b = torch.arange(plan.blocks)[:, None]
    steps = []
    for mt in range(-(-plan.tiles // plan.blocks)):
        t = b + mt * plan.blocks
        y0 = (t % plan.tiles_y) * plan.tile_y
        z0 = (t // plan.tiles_y) * plan.tz
        for dz in range(plan.tz):
            z = z0 + dz
            for m in range(per):
                for q in range(plan.r):
                    y = y0 + q
                    ok = ((t < plan.tiles) & (ix[None, :, m] >= 0) & (y < ny)
                          & (z < nz))
                    steps.append(torch.where(
                        ok, (z * ny + y) * nx + ix[None, :, m], -1))
    return steps


def phase_a_order(plan, dims):
    """The phase A order of the plan's form."""
    return (ring_order if plan.form == "ring" else march_order)(plan, dims)


def march_partials(terms, steps, blocks):
    acc = torch.zeros((blocks, THREADS), dtype=terms.dtype)
    padded = torch.cat([terms, terms.new_zeros(1)])  # index -1: adds 0
    for idx in steps:
        acc = acc + padded[idx]
    return block_tree(acc)


def s3(a, dim, n):
    """((left + centre) + right) along ``dim`` of a staged block, n
    outputs."""
    return (a.narrow(dim, 0, n) + a.narrow(dim, 1, n)) + a.narrow(dim, 2, n)


def sqrt_rn(v):
    """The correctly rounded square root of a 0-d tensor, as the kernel's
    __fsqrt_rn / __dsqrt_rn take it (torch's CPU sqrt can be an ulp off):
    in f64 for both types, which for a square root of an f32 value rounds
    to the same f32."""
    return torch.tensor(math.sqrt(float(v)), dtype=torch.float64).to(v.dtype)


def padded_shape(plan, dims):
    """The staged space: the domain with a 1-point border and x and y
    rounded up to whole tiles."""
    nx, ny, nz = dims
    return (nz + 2, plan.tiles_y * plan.tile_y + 2,
            plan.tiles_x * plan.tile_x + 2)


def inside(plan, dims):
    """The points of the staged space that lie in the domain."""
    nx, ny, nz = dims
    mask = torch.zeros(padded_shape(plan, dims), dtype=torch.bool)
    mask[1:nz + 1, 1:ny + 1, 1:nx + 1] = True
    return mask


def phase_a(r, p_src, p_dst, beta, dims, use_7pt, plan):
    """Phase A, tile by tile in the kernel's order (t = b + m * blocks, so
    t ascending): each tile stages p' = r + beta p_src at its planes, rows
    and columns and a 1-point halo (0 outside the domain) from the buffers
    as they stand, forms w = A p' on them and writes p' into p_dst and w
    at its own points. Returns w. ``r``, ``p_src`` and ``p_dst`` are
    zero-padded buffers of ``padded_shape``; p_dst is p_src in the
    in-place schedule."""
    nx, ny, nz = dims
    ty, tx = plan.tile_y, plan.tile_x
    mask = inside(plan, dims)
    w = torch.full((nz, ny, nx), float("nan"), dtype=r.dtype)
    for t in range(plan.tiles):
        x0, y0, z0, z1 = block_origin(plan, nz, t)
        sl = (slice(z0, z1 + 2), slice(y0, y0 + ty + 2),
              slice(x0, x0 + tx + 2))
        stage = torch.where(mask[sl], r[sl] + beta * p_src[sl],
                            torch.zeros((), dtype=r.dtype))
        cen = stage[1:-1, 1:ty + 1, 1:tx + 1]
        if not use_7pt:
            out = 28 * cen - s3(s3(s3(stage, 2, tx), 1, ty), 0, z1 - z0)
        else:
            plane = stage[1:-1]
            sxy = (s3(plane[:, 1:ty + 1], 2, tx)
                   + s3(plane[:, :, 1:tx + 1], 1, ty))
            out = 30 * cen - (sxy + s3(stage[:, 1:ty + 1, 1:tx + 1], 0,
                                       z1 - z0))
        ye, xe = min(ty, ny - y0), min(tx, nx - x0)
        w[z0:z1, y0:y0 + ye, x0:x0 + xe] = out[:, :ye, :xe]
        p_dst[z0 + 1:z1 + 1, y0 + 1:y0 + 1 + ye, x0 + 1:x0 + 1 + xe] = \
            cen[:, :ye, :xe]
    return w.reshape(-1)


def interior(buf, dims):
    nx, ny, nz = dims
    return buf[1:nz + 1, 1:ny + 1, 1:nx + 1].reshape(-1)


def k5_emulate(r0, x0, eps, dims, itermax, use_7pt, plan, in_place=False,
               trace=None):
    """K5's solve as the kernel schedules it (module docstring): returns
    (x, hist). ``in_place``: one p buffer, updated in place by phase A.
    ``trace``: a list that receives, per iteration run, (beta, alpha, the
    state r, p_old, x before it, and p', w, r, x after it)."""
    nx, ny, nz = dims
    dt = r0.dtype
    shape = padded_shape(plan, dims)
    r_pad = torch.zeros(shape, dtype=dt)
    bufs = [torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt)]
    if in_place:
        bufs[1] = bufs[0]
    r = r0.clone()
    x = x0.clone()
    steps = phase_a_order(plan, dims)
    tiny = torch.tensor(1e-30, dtype=dt)
    zero = torch.zeros((), dtype=dt)
    hist = torch.full((itermax,), float("nan"), dtype=dt)
    rtrans = grid_total(stream_partials(r * r, plan.blocks))
    rtrans_prev = rtrans
    hist[0] = sqrt_rn(rtrans)
    done = False
    for k in range(1, itermax):
        if done or not bool(sqrt_rn(rtrans_prev) > eps):
            break
        hist[k] = sqrt_rn(rtrans)
        beta = (zero if k == 1 or bool(rtrans_prev == 0)
                else rtrans / rtrans_prev)
        p_old, p_new = bufs[(k + 1) & 1], bufs[k & 1]
        before = (r.clone(), interior(p_old, dims).clone(), x.clone())
        r_pad[1:nz + 1, 1:ny + 1, 1:nx + 1] = r.reshape(nz, ny, nx)
        w = phase_a(r_pad, p_old, p_new, beta, dims, use_7pt, plan)
        pn = interior(p_new, dims)
        pap = grid_total(march_partials(w * pn, steps, plan.blocks))
        breakdown = bool(pap <= rtrans * tiny)
        alpha = zero if breakdown else rtrans / torch.where(pap == 0, 1, pap)
        r = r - alpha * w
        x = x + alpha * pn
        rtrans_prev = rtrans
        rtrans = grid_total(stream_partials(r * r, plan.blocks))
        done = breakdown
        if trace is not None:
            trace.append((beta, alpha, *before, pn.clone(), w, r, x))
    return x, hist


def problem(dims, use_7pt, dt, x0_scale=0.0, seed=0):
    """r0 = b - A x0 on the generated problem (b = A 1), x0 random times
    ``x0_scale``."""
    n = math.prod(dims)
    b = torch.from_numpy(27.0 - (stencil_row_counts(*dims, use_7pt) - 1.0))
    x0 = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)
                          * x0_scale)
    r0 = b - stencil_apply_torch(x0, *dims, use_7pt)
    return r0.to(dt), x0.to(dt)


def bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


def assert_history_close(h, h_ref, f64):
    """chip_smoke.py phase 3b's comparison: k equal, and the history to
    rtol 1e-9 above 1e-10 of the start (f64) or 1e-4 above 1e-4 (f32)."""
    floor, rtol = (1e-10, 1e-9) if f64 else (1e-4, 1e-4)
    h, h_ref = h.numpy(), h_ref.numpy()
    k, k_ref = int(np.sum(~np.isnan(h))), int(np.sum(~np.isnan(h_ref)))
    assert k == k_ref
    assert np.isnan(h[k:]).all() and np.isnan(h_ref[k:]).all()
    sel = h_ref[:k] >= floor * h_ref[0]
    np.testing.assert_allclose(h[:k][sel], h_ref[:k][sel], rtol=rtol)
    return k


def plain_step(r, p, x, beta, alpha, dims, use_7pt):
    """One iteration's elementwise work as stencil_cg_vmem_torch's loop
    body does it (ops/stencil_cg_vmem.py), at given beta and alpha."""
    p = r + beta * p
    w = stencil_apply_torch(p, *dims, use_7pt)
    r = r - alpha * w
    x = x + alpha * p
    return p, w, r, x


# (dims, 7-point, x0 scale, eps, itermax): the phase 3b shapes; the
# 7-point form and a nonzero x0; an early exit by eps
EMULATED = [((37, 29, 23), False, 0.0, 0.0, 30),
            ((64, 8, 3), False, 0.0, 0.0, 20),
            ((130, 2, 3), True, 0.0, 0.0, 20),
            ((10, 9, 8), True, 0.1, 1e-8, 60),
            ((2, 2, 2), False, 0.0, 0.0, 8),
            ((1, 1, 1), False, 0.0, 0.0, 5)]


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", EMULATED)
def test_emulation_equals_the_plain_version(case, dt):
    """Elementwise bit for bit at equal alpha and beta, iteration by
    iteration; the history to phase 3b's tolerances; x to its atol."""
    dims, use_7pt, x0_scale, eps, itermax = case
    r0, x0 = problem(dims, use_7pt, dt, x0_scale)
    plan = cg_plan(*dims, r0.element_size(), 3 * SMS)
    trace = []
    x, hist = k5_emulate(r0, x0, eps, dims, itermax, use_7pt, plan,
                         trace=trace)
    assert trace
    for beta, alpha, r_, p_, x_, pn, w, r, xk in trace:
        want = plain_step(r_, p_, x_, beta, alpha, dims, use_7pt)
        for got, ref in zip((pn, w, r, xk), want):
            assert torch.equal(bits(got), bits(ref))
    x_ref, h_ref = stencil_cg_vmem_torch(r0, x0, eps, *dims, itermax,
                                         use_7pt)
    f64 = dt == torch.float64
    k = assert_history_close(hist, h_ref, f64)
    assert k == len(trace) + 1
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=0,
                               atol=1e-10 if f64 else 1e-4)


@pytest.mark.parametrize("r,tz", [(8, 4), (1, 1), (4, 2)])
def test_emulation_under_forced_plans(r, tz):
    """Fewer tiles than blocks, and many more (few blocks given)."""
    dims = (37, 29, 23)
    r0, x0 = problem(dims, False, torch.float64)
    for resident in (3 * SMS, 7):
        plan = cg_plan(*dims, 8, resident, r=r, tz=tz)
        x, hist = k5_emulate(r0, x0, 0.0, dims, 30, False, plan)
        x_ref, h_ref = stencil_cg_vmem_torch(r0, x0, 0.0, *dims, 30)
        assert assert_history_close(hist, h_ref, True) == 30
        np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_emulation_of_a_zero_residual(dt):
    """r0 = 0: hist[0] = 0 and NaN from k = 1, x = x0."""
    dims = (37, 29, 23)
    n = math.prod(dims)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to(dt)
    plan = cg_plan(*dims, x0.element_size(), 3 * SMS)
    x, hist = k5_emulate(torch.zeros(n, dtype=dt), x0, 0.0, dims, 10, False,
                         plan)
    x_ref, h_ref = stencil_cg_vmem_torch(torch.zeros(n, dtype=dt), x0, 0.0,
                                         *dims, 10)
    assert float(hist[0]) == 0.0 and torch.isnan(hist[1:]).all()
    assert torch.equal(bits(x), bits(x0)) and torch.equal(bits(x_ref),
                                                          bits(x0))
    assert torch.isnan(h_ref[1:]).all()


def test_emulation_at_100_cubed():
    """The main path's shape and plan, f32, a few iterations."""
    dims = (100, 100, 100)
    r0, x0 = problem(dims, False, torch.float32)
    plan = cg_plan(*dims, 4, 3 * SMS)
    x, hist = k5_emulate(r0, x0, 0.0, dims, 6, False, plan)
    x_ref, h_ref = stencil_cg_vmem_torch(r0, x0, 0.0, *dims, 6)
    assert assert_history_close(hist, h_ref, False) == 6
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=0, atol=1e-4)


def test_sqrt_is_correctly_rounded():
    """At a value where torch's CPU sqrt is an ulp off (a residual of the
    f64 emulation at 37x29x23), sqrt_rn gives the IEEE result."""
    v = torch.tensor(10363.636896352222, dtype=torch.float64)
    assert float(sqrt_rn(v)) == math.sqrt(10363.636896352222)
    for x in np.random.default_rng(3).uniform(0, 1e6, 200).astype(np.float32):
        want = np.sqrt(np.float32(x))  # numpy's f32 sqrt is the IEEE one
        assert sqrt_rn(torch.tensor(x)).item() == want


def test_partials_follow_the_kernel_order():
    """The emulated dots are the kernel's order of sums, which differs from
    a plain sum in the last bits on enough terms, and repeats exactly."""
    dims = (37, 29, 23)
    terms = torch.from_numpy(np.random.default_rng(4).standard_normal(
        math.prod(dims)).astype(np.float32))
    plan = cg_plan(*dims, 4, 3 * SMS)
    a = grid_total(stream_partials(terms, plan.blocks))
    b = grid_total(march_partials(terms, march_order(plan, dims),
                                  plan.blocks))
    assert torch.equal(a, grid_total(stream_partials(terms, plan.blocks)))
    exact = math.fsum(terms.double().tolist())
    bound = 64 * torch.finfo(torch.float32).eps * float(terms.abs().sum())
    assert abs(float(a) - exact) <= bound and abs(float(b) - exact) <= bound
    # every point is one thread's term exactly once in phase A's order
    seen = torch.cat([i[i >= 0] for i in march_order(plan, dims)])
    assert torch.equal(seen.sort().values, torch.arange(terms.numel()))


@pytest.mark.parametrize("use_7pt", [False, True])
def test_one_buffer_in_place_differs(use_7pt):
    """With one p buffer updated in place, a tile staged after its
    neighbour reads that neighbour's p' as p_old in its halo: the
    iterates leave the plain version's from k = 2."""
    dims = (37, 29, 23)
    r0, x0 = problem(dims, use_7pt, torch.float64)
    plan = cg_plan(*dims, 8, 3 * SMS, r=1, tz=2)
    trace = []
    x, hist = k5_emulate(r0, x0, 0.0, dims, 30, use_7pt, plan,
                         in_place=True, trace=trace)
    beta, alpha, r_, p_, x_, pn, w, _r, _x = trace[1]
    p_ref, w_ref, _, _ = plain_step(r_, p_, x_, beta, alpha, dims, use_7pt)
    assert torch.equal(bits(pn), bits(p_ref))  # its own points are right
    assert not torch.equal(bits(w), bits(w_ref))  # its halos are not
    _x_ref, h_ref = stencil_cg_vmem_torch(r0, x0, 0.0, *dims, 30, use_7pt)
    k = int(np.sum(~np.isnan(h_ref.numpy())))
    assert not np.allclose(hist.numpy()[:k], h_ref.numpy()[:k], rtol=1e-6)


@pytest.mark.parametrize("case", [((10, 9, 8), False, 0.0, 0.0, 25),
                                  ((8, 8, 8), True, 0.1, 1e-8, 40)])
def test_emulation_matches_jax(case):
    """The emulation against the JAX package's stencil_cg_vmem_pallas in
    interpret mode, as tests/test_torch_stencil.py holds the plain version
    (k equal, the history to rtol 1e-9 above 1e-10 of its start, x to
    1e-10)."""
    from test_torch_stencil import (
        assert_vmem_agree,
        run_vmem_both,
        vmem_inputs,
    )

    dims, use_7pt, x0_scale, eps, itermax = case
    x0 = np.random.default_rng(2).standard_normal(math.prod(dims)) * x0_scale
    Aj, A, r0, x0 = vmem_inputs(dims, use_7pt, x0)
    _port, jx = run_vmem_both(Aj, A, r0, x0, eps, itermax)
    plan = cg_plan(*dims, 8, 3 * SMS)
    x, hist = k5_emulate(torch.from_numpy(r0), torch.from_numpy(x0), eps,
                         dims, itermax, use_7pt, plan)
    k = assert_vmem_agree((x.numpy(), hist.numpy()), jx)
    assert (k == itermax) == (eps == 0.0)


def test_emulation_pads_like_the_march():
    """A staged point outside the domain is 0: the emulation's w at one
    tile equals the plain apply on a grid whose edges fall inside tiles."""
    dims = (33, 9, 5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        math.prod(dims)))
    plan = cg_plan(*dims, 8, 3 * SMS, r=1, tz=2)
    shape = padded_shape(plan, dims)
    src = F.pad(x.reshape(dims[::-1]), (1, shape[2] - dims[0] - 1,
                                         1, shape[1] - dims[1] - 1, 1, 1))
    zero = torch.zeros(shape, dtype=x.dtype)
    for use_7pt in (False, True):
        w = phase_a(src, zero, torch.zeros(shape, dtype=x.dtype), 0.0, dims,
                    use_7pt, plan)
        assert torch.equal(bits(w), bits(stencil_apply_torch(x, *dims,
                                                             use_7pt)))


# -- the ring form of phase A ----------------------------------------------


@pytest.mark.parametrize("dims,itemsize,form", [
    ((200, 200, 200), 4, "ring"), ((200, 200, 200), 8, "ring"),
    ((256, 256, 256), 4, "ring"),
    # within the L2 budget the march was as fast (the shape rule)
    ((100, 100, 100), 4, "march"), ((100, 100, 100), 8, "march"),
    # a row that is not whole 16-byte units
    ((1, 1, 1), 4, "march"), ((37, 29, 23), 4, "march"),
    ((130, 300, 300), 4, "march"), ((202, 200, 200), 4, "march"),
    # a row wider than the consumers hold
    ((2048, 64, 64), 4, "march")])
def test_the_plan_rule(dims, itemsize, form):
    """The form by shape: the ring where a row is whole 16-byte units, a
    row of the plane-tile fits the consumers and the iteration's vectors do
    not fit the L2 budget; the march elsewhere."""
    plan = cg_plan(*dims, itemsize, 3 * SMS)
    assert plan.form == form
    assert scv.ring_takes(*dims, itemsize) == (form == "ring")
    big = (scv.ITERATION_VECTORS * math.prod(dims) * itemsize
           > scv.L2_RESIDENT_BUDGET)
    assert (form == "ring") == (big and dims[0] * itemsize % 16 == 0
                                and dims[0] <= scv.RING_CONSUMERS
                                * scv.RING_POINTS)


@pytest.mark.parametrize("nx,ny,itemsize,want", [
    (200, 200, 4, 4), (200, 200, 8, 4), (100, 100, 4, 4), (64, 8, 4, 4),
    (10, 9, 8, 4), (130, 2, 8, 2), (2, 2, 8, 2), (400, 50, 4, 4),
    (1792, 7, 8, 1), (600, 9, 4, 2), (1000, 7, 4, 1), (224, 200, 4, 4),
    (500, 100, 8, 2), (16, 1, 8, 1), (16, 3, 8, 2)])
def test_the_ring_geometry(nx, ny, itemsize, want):
    """R, the rows of a tile: the largest of PLAN_ROWS up to RING_ROWS, ny
    and the rows whose plane-tile the consumers hold; a consumer holds its
    columns of a tile, and the slabs fit a block's shared memory (172064
    bytes at most, R 1 at nx 1792 in f64)."""
    assert scv.ring_rows(nx, ny, itemsize) == want
    assert want in PLAN_ROWS and want <= min(ny, scv.RING_ROWS)
    assert nx * want <= scv.RING_CONSUMERS * scv.RING_POINTS
    assert -(-nx // scv.RING_CONSUMERS) <= scv.RING_POINTS // want
    assert scv.ring_smem(nx, want, itemsize) <= 172064


@pytest.mark.parametrize("dims,itemsize,kw", [
    ((37, 29, 23), 4, {"form": "ring"}),
    ((2048, 8, 8), 4, {"form": "ring"}),
    ((200, 200, 200), 4, {"form": "ring", "tz": 0}),
    ((200, 200, 200), 4, {"form": "ring", "tz": 201}),
    ((200, 200, 200), 8, {"form": "ring", "r": 4}),
    ((202, 200, 200), 4, {"form": "ring"}),
    ((1, 1, 1), 4, {"form": "ring"}),
    ((200, 200, 200), 4, {"form": "ring", "r": 2}),
    ((200, 200, 200), 4, {"form": "ring", "tz": -1}),
    ((200, 200, 200), 4, {"form": "march", "r": 3}),
    ((200, 200, 200), 4, {"form": "march", "tz": 33}),
    ((200, 200, 200), 4, {"form": "rings"})])
def test_a_forced_ring_outside_its_limits_raises(dims, itemsize, kw):
    with pytest.raises(ValueError):
        cg_plan(*dims, itemsize, 3 * SMS, **kw)


@pytest.mark.parametrize("dims,itemsize,kw", [
    ((200, 200, 200), 4, {}), ((200, 200, 200), 8, {}),
    ((100, 100, 100), 4, {"form": "ring"}),
    ((100, 100, 100), 8, {"form": "ring", "tz": 7}),
    ((64, 8, 3), 4, {"form": "ring"}), ((10, 9, 8), 8, {"form": "ring"}),
    ((130, 2, 3), 8, {"form": "ring", "tz": 2}),
    ((1000, 7, 3), 4, {"form": "ring"})])
def test_the_ring_gives_every_tile_and_point_to_one_owner(dims, itemsize,
                                                          kw):
    """Every tile to one block, every grid point to one tile, every column
    of a tile to one consumer, within its RING_POINTS / R columns; the
    shared bytes are the mbarriers and the two slabs."""
    for resident in (2 * SMS, 3 * SMS, 7):
        plan = cg_plan(*dims, itemsize, resident, **kw)
        assert plan.form == "ring" and plan.tiles_x == 1
        assert plan.tile_x == dims[0] and plan.tile_y == plan.r
        assert plan.smem == 2 * (16 + 2 * (plan.r + 2) * dims[0] * itemsize)
        assert (tile_owners(plan) == 1).all()
        assert (coverage(plan, dims) == 1).all()
    owners = np.zeros(dims[0], np.int32)
    for row in scv.ring_columns(plan, dims[0]):
        assert len(row) == scv.RING_POINTS // plan.r
        for x in row:
            if x is not None:
                owners[x] += 1
    assert (owners == 1).all()


def test_the_ring_partials_cover_every_point_once():
    """Every point is one thread's term exactly once in the ring's phase A
    order, and the ring's dot is within the sum's bound of the exact one."""
    dims = (64, 40, 12)
    plan = cg_plan(*dims, 4, 37, form="ring", tz=5)
    order = ring_order(plan, dims)
    seen = torch.cat([i[i >= 0] for i in order])
    assert torch.equal(seen.sort().values, torch.arange(math.prod(dims)))
    assert all((i[:, scv.RING_CONSUMERS:] == -1).all() for i in order)
    terms = torch.from_numpy(np.random.default_rng(4).standard_normal(
        math.prod(dims)).astype(np.float32))
    got = grid_total(march_partials(terms, order, plan.blocks))
    exact = math.fsum(terms.double().tolist())
    bound = 64 * torch.finfo(torch.float32).eps * float(terms.abs().sum())
    assert abs(float(got) - exact) <= bound


# (dims, 7-point, x0 scale, eps, itermax, dtype, forced ring choices): the
# shapes of phase 3b whose rows are whole 16-byte units, in each dtype that
# makes them so; an eps exit; a forced tz; wide rows (R 1 and 2, several
# columns a consumer)
EMULATED_RING = [
    ((64, 8, 3), False, 0.0, 0.0, 20, torch.float64, {}),
    ((64, 8, 3), False, 0.0, 0.0, 20, torch.float32, {}),
    ((8, 8, 8), True, 0.0, 0.0, 20, torch.float32, {}),
    ((10, 9, 8), True, 0.1, 1e-8, 60, torch.float64, {}),
    ((130, 2, 3), False, 0.0, 0.0, 20, torch.float64, {}),
    ((2, 2, 2), False, 0.0, 0.0, 8, torch.float64, {}),
    ((24, 19, 11), False, 0.1, 0.0, 25, torch.float64, {"tz": 3}),
    ((1000, 7, 3), True, 0.0, 0.0, 25, torch.float32, {}),
    ((600, 9, 4), False, 0.0, 0.0, 25, torch.float32, {})]


@pytest.mark.parametrize("case", EMULATED_RING)
def test_the_ring_emulation_equals_the_plain_version(case):
    """The ring form: elementwise bit for bit at equal alpha and beta,
    iteration by iteration; the history to phase 3b's tolerances; x to its
    atol."""
    dims, use_7pt, x0_scale, eps, itermax, dt, kw = case
    r0, x0 = problem(dims, use_7pt, dt, x0_scale)
    plan = cg_plan(*dims, r0.element_size(), 3 * SMS, form="ring", **kw)
    trace = []
    x, hist = k5_emulate(r0, x0, eps, dims, itermax, use_7pt, plan,
                         trace=trace)
    assert trace
    for beta, alpha, r_, p_, x_, pn, w, r, xk in trace:
        want = plain_step(r_, p_, x_, beta, alpha, dims, use_7pt)
        for got, ref in zip((pn, w, r, xk), want):
            assert torch.equal(bits(got), bits(ref))
    x_ref, h_ref = stencil_cg_vmem_torch(r0, x0, eps, *dims, itermax,
                                         use_7pt)
    f64 = dt == torch.float64
    k = assert_history_close(hist, h_ref, f64)
    assert k == len(trace) + 1
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=0,
                               atol=1e-10 if f64 else 1e-4)


def test_the_ring_emulation_of_a_zero_residual():
    """r0 = 0 on the ring: hist[0] = 0 and NaN from k = 1, x = x0."""
    dims = (64, 8, 3)
    n = math.prod(dims)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(n))
    plan = cg_plan(*dims, 8, 3 * SMS, form="ring")
    x, hist = k5_emulate(torch.zeros(n, dtype=x0.dtype), x0, 0.0, dims, 10,
                         False, plan)
    assert float(hist[0]) == 0.0 and torch.isnan(hist[1:]).all()
    assert torch.equal(bits(x), bits(x0))


@pytest.mark.parametrize("case", [((16, 9, 8), False, 0.0, 0.0, 25),
                                  ((8, 8, 8), True, 0.1, 1e-8, 40)])
def test_the_ring_emulation_matches_jax(case):
    """The ring's emulation against the JAX package's
    stencil_cg_vmem_pallas in interpret mode, as the march's is held."""
    from test_torch_stencil import (
        assert_vmem_agree,
        run_vmem_both,
        vmem_inputs,
    )

    dims, use_7pt, x0_scale, eps, itermax = case
    x0 = np.random.default_rng(2).standard_normal(math.prod(dims)) * x0_scale
    Aj, A, r0, x0 = vmem_inputs(dims, use_7pt, x0)
    _port, jx = run_vmem_both(Aj, A, r0, x0, eps, itermax)
    plan = cg_plan(*dims, 8, 3 * SMS, form="ring")
    x, hist = k5_emulate(torch.from_numpy(r0), torch.from_numpy(x0), eps,
                         dims, itermax, use_7pt, plan)
    k = assert_vmem_agree((x.numpy(), hist.numpy()), jx)
    assert (k == itermax) == (eps == 0.0)


def test_the_wrapper_passes_a_ring_plan_and_counts_it(monkeypatch):
    """A ring plan reaches the C entry point with its form (1), the
    wrapper names its form on the open span and counts
    ``stencil_cg_vmem.ring``; a march plan passes 0 and counts no ring."""
    rec, counts, notes = Recorder(), [], []
    monkeypatch.setattr(st, "_call", rec)
    monkeypatch.setattr(scv, "_library", lambda: None)
    monkeypatch.setattr(scv.profiler, "count",
                        lambda name, n=1: counts.append(name))
    monkeypatch.setattr(scv.profiler, "annotate",
                        lambda **kw: notes.append(kw))
    dims = (64, 8, 3)
    n = math.prod(dims)
    r0 = torch.ones(n, dtype=torch.float64)
    for form in ("ring", "march"):
        plan = cg_plan(*dims, 8, 3 * SMS, form=form)
        scv._launch(r0, r0, 0.0, *dims, 5, False, plan)
        (_name, args) = rec.calls[-1]
        assert tuple(args[13:]) == (plan.r, plan.tz, plan.blocks, plan.smem,
                                    int(form == "ring"))
        assert notes[-1] == {"form": form, "r": plan.r, "tz": plan.tz,
                             "blocks": plan.blocks}
    assert rec.calls[0][1][-1] == 1 and rec.calls[1][1][-1] == 0
    assert counts == ["stencil_cg_vmem.ring"]
