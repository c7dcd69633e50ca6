"""Port parity: the host ingest of sparsebench_tpu_torch (``host.py``,
``config.py``'s .par reader) against the JAX package's, on the CPU.

The port keeps its own numpy readers so that it never imports the JAX
package; these tests hold them to the JAX package's: the same CSR arrays
(exactly), the same partition fields and the same parameters.
"""

import numpy as np
import pytest

from sparsebench_tpu.config import Parameter as JaxParameter
from sparsebench_tpu.config import print_parameter as jax_print_parameter
from sparsebench_tpu.config import read_parameter as jax_read_parameter
from sparsebench_tpu.host import HostCSR as JaxCSR
from sparsebench_tpu.host import generate_stencil as jax_generate_stencil
from sparsebench_tpu.host import read_mm as jax_read_mm
from sparsebench_tpu.host.binfile import read_bmx as jax_read_bmx
from sparsebench_tpu.host.binfile import write_bmx
from sparsebench_tpu_torch import host
from sparsebench_tpu_torch.config import (
    Parameter,
    print_parameter,
    read_parameter,
)

FIELDS = ("nr", "nc", "nnz", "start_row", "total_nr", "total_nnz")


def assert_same_csr(c, cj):
    for f in FIELDS:
        assert getattr(c, f) == getattr(cj, f), f
    np.testing.assert_array_equal(c.row_ptr, cj.row_ptr)
    np.testing.assert_array_equal(c.col, cj.col)
    np.testing.assert_array_equal(c.val, cj.val)
    np.testing.assert_array_equal(c.row_lengths, cj.row_lengths)
    assert c.col.dtype == np.int64 and c.val.dtype == np.float64


MTX = ["matrix_band_klein.mtx"] + [f"testMatrices/test{i}.mtx"
                                   for i in range(11)]


@pytest.mark.parametrize("name", MTX)
def test_read_mm_matches_jax(name, data_dir):
    path = str(data_dir / name)
    assert_same_csr(host.read_mm(path), JaxCSR.from_coo(jax_read_mm(path)))


SMALL_MTX = {
    "symmetric_real": ["%%MatrixMarket matrix coordinate real symmetric",
                       "4 4 5", "1 1 4.0", "2 1 -1.5", "3 2 2.0", "3 3 5.0",
                       "4 1 0.25"],
    "general_pattern": ["%%MatrixMarket matrix coordinate pattern general",
                        "4 4 4", "2 1", "1 1", "4 3", "1 4"],
    "symmetric_pattern": ["%%MatrixMarket matrix coordinate pattern "
                          "symmetric", "4 4 3", "1 1", "3 1", "4 2"],
    "integer_comments": ["%%MatrixMarket matrix coordinate integer general",
                         "% a comment", "", "% another", "4 4 2", "1 2 -3",
                         "3 3 1"],
}


@pytest.mark.parametrize("kind", sorted(SMALL_MTX))
def test_read_mm_fields_match_jax(kind, tmp_path):
    """Symmetric mirroring, pattern values and comment lines."""
    path = tmp_path / f"{kind}.mtx"
    path.write_text("\n".join(SMALL_MTX[kind]) + "\n")
    c = host.read_mm(str(path))
    assert_same_csr(c, JaxCSR.from_coo(jax_read_mm(str(path))))
    assert c.nnz > 0


@pytest.mark.parametrize("banner", [
    "%%MatrixMarket matrix array real general",
    "%%MatrixMarket matrix coordinate complex general",
    "%%MatrixMarket matrix coordinate real hermitian",
    "%%NotMatrixMarket matrix coordinate real general",
])
def test_read_mm_rejects_what_jax_rejects(banner, tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text(f"{banner}\n2 2 1\n1 1 1.0\n")
    with pytest.raises(ValueError):
        jax_read_mm(str(path))
    with pytest.raises(ValueError):
        host.read_mm(str(path))


@pytest.mark.parametrize("source", ["klein", "stencil"])
def test_read_bmx_matches_jax(source, tmp_path, data_dir):
    if source == "klein":
        csr = JaxCSR.from_coo(jax_read_mm(str(data_dir
                                              / "matrix_band_klein.mtx")))
    else:
        csr = jax_generate_stencil(5, 4, 3)
    path = str(tmp_path / "m.bmx")
    write_bmx(csr, path)
    assert_same_csr(host.read_bmx(path), jax_read_bmx(path))


def test_read_bmx_rejects_other_files(tmp_path):
    path = tmp_path / "x.bmx"
    path.write_bytes(b"not a bmx file at all, no header" * 2)
    with pytest.raises(ValueError):
        host.read_bmx(str(path))


@pytest.mark.parametrize("dims,rank,size,use_7pt", [
    ((2, 2, 3), 0, 1, False),
    ((1, 5, 4), 0, 1, True),
    ((2, 1, 6), 0, 1, False),
    ((5, 4, 3), 0, 1, False),
    ((4, 3, 2), 1, 3, False),
    ((4, 3, 2), 2, 3, True),
])
def test_generate_stencil_matches_jax(dims, rank, size, use_7pt):
    c = host.generate_stencil(*dims, rank=rank, size=size, use_7pt=use_7pt)
    cj = jax_generate_stencil(*dims, rank=rank, size=size, use_7pt=use_7pt)
    assert_same_csr(c, cj)
    assert c.model_total_nnz == cj.model_total_nnz


PAR_FIELDS = ("filename", "nx", "ny", "nz", "itermax", "eps", "fmt",
              "dtype", "index_dtype", "shards", "bench")


@pytest.mark.parametrize("name", ["hpcg.par", "hpcgmm.par", "custom"])
def test_read_parameter_matches_jax(name, tmp_path, data_dir):
    if name == "custom":
        path = tmp_path / "t.par"
        path.write_text("filename generate7P # 7-point\nnx 5\n  ny 4 \n"
                        "eps 1e-8\nitermax 9\ndtype f64\nshards 2\n"
                        "chunk_height 8\nunknown_key 3\nnz\n")
    else:
        path = data_dir.parent.parent / name
    p = read_parameter(Parameter(), str(path))
    pj = jax_read_parameter(JaxParameter(), str(path))
    for f in PAR_FIELDS:
        assert getattr(p, f) == getattr(pj, f), f
    assert print_parameter(p) == jax_print_parameter(pj)


def test_parameter_defaults_match_jax():
    p, pj = Parameter(), JaxParameter()
    for f in PAR_FIELDS:
        assert getattr(p, f) == getattr(pj, f), f
