"""The plain reference against the port's plain path, f64, on a 12 x 11 x
10 grid: the operator, CG and blocked CG."""

import pytest
import torch

from reference import hpcg
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.solvers.cg import cg_loop
from sparsebench_tpu_torch.solvers.cg_multi import cg_multi_loop

NX, NY, NZ = 12, 11, 10
F64 = DTypePolicy.from_names("f64")


def cfg(points=27):
    return {"nx": NX, "ny": NY, "nz": NZ, "stencil_points": points,
            "diagonal": 27.0, "off_diagonal": -1.0, "itermax": 150,
            "eps": 0.0}


def port(points=27):
    A, _ = DiaMatrix.from_stencil(NX, NY, NZ, device="cpu", policy=F64,
                                  use_7pt=points == 7)
    return A


@pytest.mark.parametrize("points", [27, 7])
def test_apply_matches_the_port(points):
    x = torch.rand(3, NX * NY * NZ, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    A = port(points)
    got = hpcg.apply(x, cfg(points))
    for c in range(3):
        torch.testing.assert_close(got[c], A.spmv(x[c]), rtol=0, atol=1e-12)
    # A 1 = 27 - (row length - 1): the reference's b for x = 1
    ones = hpcg.apply(torch.ones(NX * NY * NZ, dtype=torch.float64),
                      cfg(points))
    assert float(ones.min()) == 28 - points  # an inner row


def test_cg_matches_the_port():
    A = port()
    b = hpcg.apply(torch.rand(NX * NY * NZ, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(2)),
                   cfg())
    x, k, hist = cg_loop(A, b, torch.zeros_like(b), 150,
                         torch.tensor(0.0, dtype=torch.float64))
    X, K, H = hpcg.cg(b[None], cfg())
    assert int(k) == int(K[0]) == 150
    torch.testing.assert_close(x, X[0], rtol=0, atol=1e-12)
    keep = H[:, 0] >= 1e-8 * H[0, 0]
    torch.testing.assert_close(hist[keep], H[keep, 0], rtol=1e-6, atol=0)


def test_blocked_cg_matches_the_port():
    A = port()
    B = hpcg.apply(torch.rand(3, NX * NY * NZ, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(3)),
                   cfg())
    X, iters, hist = cg_multi_loop(A, B, torch.zeros_like(B), 150,
                                   torch.tensor(0.0, dtype=torch.float64))
    Xr, Kr, Hr = hpcg.cg(B, cfg())
    assert iters.tolist() == Kr.tolist() == [150] * 3
    torch.testing.assert_close(X, Xr, rtol=0, atol=1e-12)
    keep = Hr >= 1e-8 * Hr[0]
    torch.testing.assert_close(hist[keep], Hr[keep], rtol=1e-6, atol=0)
