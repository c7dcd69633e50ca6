"""The tile plan of the stencil kernels K2 and K3 (sparsebench_tpu_torch
ops/stencil.py ``tile_plan``, ``block_origin``) and the order of sums of
their plane march (csrc/stencil_apply.cuh ``march``), on the CPU.

The kernels themselves run only on a CUDA card (tests/test_torch_kernels.py,
``cuda`` marker). Here: the plan covers every grid point exactly once, at
100^3, 200^3, the edge shapes that chip_smoke.py's phase 3b runs and forced
R and tz; the wrappers size the dots' partials from the plan and pass the
plan to the C entry points; bad inputs raise; and a torch emulation of the
march (each block's staged plane tiles with their halo, Sx then Sy(Sx) on
the tile, the z-sums rolled over planes k-2, k-1, k) gives the plain
version's bits, while the same march with its sums in another order does
not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsebench_tpu_torch.ops import stencil as st
from sparsebench_tpu_torch.ops.stencil import (
    MAX_SERIAL,
    PLAN_ROWS,
    TILE_X,
    block_origin,
    stencil_apply_torch,
    tile_plan,
)

SMS = 132  # the H100's SMs, as device_plan reads them on the card
# 100^3, 200^3 and the edge shapes of chip_smoke.py phase 3b
SHAPES = [(100, 100, 100), (200, 200, 200), (10, 9, 7), (1, 1, 1),
          (130, 2, 3), (128, 5, 4), (1, 5, 6), (37, 29, 23), (64, 8, 3),
          (2, 2, 2)]
FORCED = [(1, 1), (1, 32), (2, 3), (2, 16), (4, 8), (4, 5), (8, 1), (8, 4)]


def coverage(plan, dims):
    """How many blocks of ``plan`` write each grid point."""
    nx, ny, nz = dims
    hits = np.zeros((nz, ny, nx), np.int32)
    for b in range(plan.grid):
        x0, y0, z0, z1 = block_origin(plan, nz, b)
        assert 0 <= x0 < nx and 0 <= y0 < ny and 0 <= z0 < z1 <= nz
        hits[z0:z1, y0:y0 + plan.tile_y, x0:x0 + TILE_X] += 1
    return hits


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("dims", SHAPES)
def test_default_plan_covers_every_point_once(dims, itemsize):
    plan = tile_plan(*dims, itemsize, SMS)
    assert plan.r in PLAN_ROWS and 1 <= plan.tz
    assert plan.r * plan.tz <= MAX_SERIAL
    assert plan.grid == plan.tiles_x * plan.tiles_y * plan.runs
    assert plan.tiles_x == -(-dims[0] // TILE_X)
    assert plan.tiles_y == -(-dims[1] // plan.tile_y)
    assert plan.runs == -(-dims[2] // plan.tz)
    # two staged planes, (8R + 2) x 34 values at the compute width
    assert plan.smem == 2 * (8 * plan.r + 2) * 34 * max(itemsize, 4)
    assert (coverage(plan, dims) == 1).all()


@pytest.mark.parametrize("r,tz", FORCED)
@pytest.mark.parametrize("dims", [(100, 100, 100), (200, 200, 200),
                                  (37, 29, 23), (130, 2, 3), (1, 5, 6),
                                  (2, 2, 2)])
def test_forced_plan_covers_every_point_once(dims, r, tz):
    plan = tile_plan(*dims, 4, SMS, r=r, tz=tz)
    assert (plan.r, plan.tz) == (r, tz)
    assert (coverage(plan, dims) == 1).all()


def test_default_plan_at_the_main_sizes():
    """The plans the main path runs on an H100 (132 SMs), f32 vectors."""
    p100 = tile_plan(100, 100, 100, 4, SMS)
    p200 = tile_plan(200, 200, 200, 4, SMS)
    for p in (p100, p200):
        # enough blocks for the card, each thread's dot run within its cap
        assert p.grid >= st.BLOCKS_PER_SM * SMS
        assert p.r * p.tz <= MAX_SERIAL
    assert (p100.r, p100.tz, p200.r, p200.tz) == (2, 8, 2, 8)
    # the plan follows the card: more SMs, shorter runs and more blocks
    wide = tile_plan(100, 100, 100, 4, 4 * SMS)
    assert wide.tz < p100.tz and wide.grid >= st.BLOCKS_PER_SM * 4 * SMS


@pytest.mark.parametrize("args,kw", [
    ((0, 5, 5, 4, SMS), {}), ((5, -1, 5, 4, SMS), {}),
    ((5, 5, 5, 3, SMS), {}), ((5, 5, 5, 4, 0), {}),
    ((5.0, 5, 5, 4, SMS), {}), ((True, 5, 5, 4, SMS), {}),
    ((5, 5, 5, 4, SMS), {"r": 3}), ((5, 5, 5, 4, SMS), {"tz": 0}),
    ((5, 5, 5, 4, SMS), {"r": 4, "tz": 9}),
    ((5, 5, 5, 4, SMS), {"r": 1, "tz": 33}),
    ((2**16, 2**15, 1, 4, SMS), {}),
])
def test_bad_plan_inputs_raise(args, kw):
    with pytest.raises(ValueError):
        tile_plan(*args, **kw)


class Recorder:
    """Stands in for the launch: records the entry point and its
    arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, lib, name, device, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("dims", [(37, 29, 23), (10, 9, 7)])
@pytest.mark.parametrize("forced", [None, (4, 2)])
def test_wrappers_size_partials_and_pass_the_plan(dims, forced, monkeypatch):
    """The launch helpers pass the plan (R, tz, grid, shared bytes) to the
    C entry points and size the dots' partials from its grid: a pair a
    block for K2, one delta a block for K3."""
    rec = Recorder()
    monkeypatch.setattr(st, "_call", rec)
    monkeypatch.setattr(st, "_library", lambda: None)
    n = dims[0] * dims[1] * dims[2]
    plan = tile_plan(*dims, 4, SMS, *(forced or ()))
    monkeypatch.setattr(st, "device_plan", lambda v, nx, ny, nz: tile_plan(
        nx, ny, nz, v.element_size(), SMS))
    x = torch.zeros(n)
    given = plan if forced else None
    _, parts = st._launch_apply(x, *dims, False, True, given)
    assert parts.shape == (plan.grid, 2) and parts.dtype == torch.float32
    _, none = st._launch_apply(x, *dims, True, False, given)
    assert none is None
    _, _, parts3 = st._launch_axpy(x, x, 0.5, *dims, True, given)
    assert parts3.shape == (plan.grid,) and parts3.dtype == torch.float32
    _, _, parts64 = st._launch_axpy(x.double(), x.double(), 0.5, *dims,
                                    False, given)
    assert parts64.dtype == torch.float64
    p64 = given or tile_plan(*dims, 8, SMS)
    assert parts64.shape == (p64.grid,)
    names = [name for name, _ in rec.calls]
    assert names == ["sb_stencil_apply_f32", "sb_stencil_apply_f32",
                     "sb_stencil_axpy_apply_dots_f32",
                     "sb_stencil_axpy_apply_dots_f64"]
    for (name, args), p in zip(rec.calls, [plan, plan, plan, p64]):
        assert tuple(args[-8:-5]) == dims
        assert tuple(args[-4:]) == (p.r, p.tz, p.grid, p.smem)


# -- the march's order of sums ---------------------------------------------


def s3_rows(a, dim, n, reverse=False):
    """((left + centre) + right) along ``dim`` of a staged tile, n outputs
    (``reverse``: ((right + centre) + left))."""
    left, right = a.narrow(dim, 0, n), a.narrow(dim, 2, n)
    if reverse:
        left, right = right, left
    return (left + a.narrow(dim, 1, n)) + right


def march_emulate(x, dims, use_7pt, plan, order="x-first"):
    """The march's arithmetic in torch: for each block of ``plan`` the
    planes z0-1 .. z1 staged as (8R + 2) x 34 tiles (zeros outside the
    domain), the plane sums formed on the tile, the z-sums rolled over
    planes k-2, k-1, k, and plane k-1 written when plane k is staged.
    ``order="swapped"`` forms Sx(Sy) instead of Sy(Sx) (27-point), or each
    in-plane 3-point sum as ((right + centre) + left) (7-point)."""
    nx, ny, nz = dims
    cdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    ty = plan.tile_y
    v = x.to(cdt).reshape(nz, ny, nx)
    vp = F.pad(v, (1, plan.tiles_x * TILE_X + 1 - nx,
                   1, plan.tiles_y * ty + 1 - ny, 1, 1))
    y = torch.full((nz, ny, nx), float("nan"), dtype=cdt)
    zero = torch.zeros((ty, TILE_X), dtype=cdt)
    for b in range(plan.grid):
        x0, y0, z0, z1 = block_origin(plan, nz, b)
        back2 = back1 = cen1 = zero
        for k in range(z0 - 1, z1 + 1):
            tile = vp[k + 1, y0:y0 + ty + 2, x0:x0 + TILE_X + 2]
            cen = tile[1:ty + 1, 1:TILE_X + 1]
            if not use_7pt:
                if order == "x-first":
                    s = s3_rows(s3_rows(tile, 1, TILE_X), 0, ty)
                else:
                    s = s3_rows(s3_rows(tile, 0, ty), 1, TILE_X)
            else:
                rev = order != "x-first"
                s = (s3_rows(tile[1:ty + 1], 1, TILE_X, rev)
                     + s3_rows(tile[:, 1:TILE_X + 1], 0, ty, rev))
            if k > z0:
                if not use_7pt:
                    out = 28 * cen1 - ((back2 + back1) + s)
                else:
                    out = 30 * cen1 - (back1 + ((back2 + cen1) + cen))
                ye, xe = min(ty, ny - y0), min(TILE_X, nx - x0)
                y[k - 1, y0:y0 + ye, x0:x0 + xe] = out[:ye, :xe]
            back2 = cen1 if use_7pt else back1
            back1, cen1 = s, cen
    return y.reshape(-1).to(x.dtype)


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else
                  {torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("use_7pt", [False, True])
@pytest.mark.parametrize("dims", [(10, 9, 7), (1, 1, 1), (130, 2, 3),
                                  (128, 5, 4), (1, 5, 6), (37, 29, 23),
                                  (64, 8, 3), (2, 2, 2)])
def test_march_order_equals_the_plain_version(dims, use_7pt, dt):
    n = dims[0] * dims[1] * dims[2]
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)).to(dt)
    plan = tile_plan(*dims, x.element_size(), SMS)
    assert torch.equal(bits(march_emulate(x, dims, use_7pt, plan)),
                       bits(stencil_apply_torch(x, *dims, use_7pt)))


@pytest.mark.parametrize("r,tz", [(1, 3), (2, 16), (4, 8), (8, 4)])
@pytest.mark.parametrize("use_7pt", [False, True])
def test_march_order_under_forced_plans(r, tz, use_7pt):
    dims = (37, 29, 23)
    n = dims[0] * dims[1] * dims[2]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)).float()
    plan = tile_plan(*dims, 4, SMS, r=r, tz=tz)
    assert torch.equal(bits(march_emulate(x, dims, use_7pt, plan)),
                       bits(stencil_apply_torch(x, *dims, use_7pt)))


@pytest.mark.parametrize("use_7pt", [False, True])
def test_march_order_at_100_cubed(use_7pt):
    dims = (100, 100, 100)
    x = torch.from_numpy(np.random.default_rng(100).standard_normal(10**6)
                         .astype(np.float32))
    plan = tile_plan(*dims, 4, SMS)
    assert torch.equal(bits(march_emulate(x, dims, use_7pt, plan)),
                       bits(stencil_apply_torch(x, *dims, use_7pt)))


def test_march_order_at_200_cubed():
    """The main path's 200^3 plan, f32, 27-point."""
    dims = (200, 200, 200)
    x = torch.from_numpy(np.random.default_rng(200).standard_normal(8 * 10**6)
                         .astype(np.float32))
    plan = tile_plan(*dims, 4, SMS)
    use_7pt = False
    assert torch.equal(bits(march_emulate(x, dims, use_7pt, plan)),
                       bits(stencil_apply_torch(x, *dims, use_7pt)))


@pytest.mark.parametrize("use_7pt", [False, True])
def test_a_swapped_order_differs(use_7pt):
    """The emulation sees the order: the same march with its plane sums in
    another order misses the plain version's bits."""
    dims = (37, 29, 23)
    n = dims[0] * dims[1] * dims[2]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(n)).float()
    plan = tile_plan(*dims, 4, SMS)
    want = bits(stencil_apply_torch(x, *dims, use_7pt))
    got = bits(march_emulate(x, dims, use_7pt, plan, order="swapped"))
    assert not torch.equal(got, want)
