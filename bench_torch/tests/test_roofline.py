"""The byte counts of the roofline readers against PERF.md's bounds of K1
and K8 at 200^3 (3.35 TB/s), and the share arithmetic."""

import pytest

from harness.roofline import least_s, share_pct
from harness.spec import Spec

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def spec():
    return Spec()


def test_k1_bytes_match_perf_bound_within_its_padding(spec):
    cfg = spec.config("hpcg27-200")
    k1 = spec.reader("dia_spmv_roofline.cg")
    n = 200 ** 3
    assert k1.nbytes(cfg) == 27 * n * 2 + 2 * n * 4
    ms = least_s(H100, k1.nbytes(cfg), k1.flops(cfg)) * 1e3
    # PERF.md's 0.149042 ms counts the DIA layout's padded rows (nr_pad
    # 8,060,928: 62,976 rows of 128); this count holds n rows a diagonal
    pad_ms = 27 * (8_060_928 - n) * 2 / 3.35e12 * 1e3
    assert ms + pad_ms == pytest.approx(0.149042, abs=1e-6)
    assert ms == pytest.approx(0.148060, abs=1e-6)
    # the same count in the spmv cell's reader
    k1s = spec.reader("dia_spmv_roofline.spmv")
    assert k1s.nbytes(cfg) == k1.nbytes(cfg)


def test_k8_bytes_match_perf_bound(spec):
    cfg = spec.config("hpcg27-200")
    k8 = spec.reader("dia_spmm_roofline.nrhs")
    ms = least_s(H100, k8.nbytes(cfg, 8), k8.flops(cfg, 8)) * 1e3
    assert ms == pytest.approx(0.281791, abs=1e-6)


def test_bytes_bound_both_kernels(spec):
    cfg = spec.config("hpcg27-200")
    k1 = spec.reader("dia_spmv_roofline.cg")
    assert k1.nbytes(cfg) / 3.35e12 > k1.flops(cfg) / 67e12


class Ctx:
    device_kind = H100

    def __init__(self, count, seconds):
        self.count, self.seconds = count, seconds

    def kernel(self, names):
        return self.count, self.seconds


def test_share_arithmetic():
    # 10 calls in 2 ms: 0.2 ms a call against a least time of 0.1 ms
    assert share_pct(Ctx(10, 2e-3), ("k",), 3.35e8, 0) == pytest.approx(50.0)
    assert share_pct(Ctx(0, 0.0), ("k",), 3.35e8, 0) is None
    assert least_s("some other card", 1.0, 1.0) is None
