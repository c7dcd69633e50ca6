"""Port parity: the CG variants ``cs``, ``fused`` and ``vmem`` (and
``standard``) of sparsebench_tpu_torch on the matrix-free stencil and on
DIA, against the JAX package's ``solve_cg`` and CLI, on the CPU.

The port runs its kernels' plain versions here. The JAX side runs its
stencil operator with ``impl="pallas"`` (interpret mode: the variants
``fused`` and ``vmem`` need its kernels) or ``"xla"``. Tolerances follow
ROADMAP's parity rules: f64 ``k`` equal and the history to rtol 1e-9 where
normr >= 1e-10 normr0; f32 history to rtol 1e-4 where normr >= 1e-4
normr0. CLI residual lines print 7 digits, so they agree to rtol 2e-6.
"""

import re

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu import cli as jax_cli  # noqa: E402
from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.formats.stencil import (  # noqa: E402
    StencilOperator as JaxStencil,
)
from sparsebench_tpu.solvers import cg as jax_cg  # noqa: E402
from sparsebench_tpu_torch import cli  # noqa: E402
from sparsebench_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparsebench_tpu_torch.formats.stencil import StencilOperator  # noqa: E402
from sparsebench_tpu_torch.solvers import cg  # noqa: E402

CPU = torch.device("cpu")
NP_DT = {"f64": np.float64, "f32": np.float32}
FLOOR = {"f64": (1e-10, 1e-9), "f32": (1e-4, 1e-4)}
JAX_IMPL = {"standard": "xla", "cs": "xla", "fused": "pallas",
            "vmem": "pallas"}


def stencil_pair(dims, use_7pt, dtype, jax_impl):
    Aj, counts = JaxStencil.from_stencil(
        *dims, use_7pt=use_7pt, policy=JaxPolicy.from_names(dtype, "i32"),
        impl=jax_impl)
    A, counts_t = StencilOperator.from_stencil(
        Aj.nx, Aj.ny, Aj.nz, use_7pt=Aj.use_7pt, device=CPU)
    np.testing.assert_array_equal(counts_t, np.asarray(counts))
    _x, b, xexact = cg.init_vectors(dtype=NP_DT[dtype], row_lengths=counts_t)
    return Aj, A, b, xexact


def assert_histories_agree(ht, hj, dtype):
    floor, rtol = FLOOR[dtype]
    below = np.flatnonzero(hj < floor * hj[0])
    n = int(below[0]) if below.size else hj.size
    assert n >= 2 and ht.size >= n
    np.testing.assert_allclose(ht[:n], hj[:n], rtol=rtol)


@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_stencil_variant_f64_matches_jax(variant):
    Aj, A, b, xexact = stencil_pair((10, 9, 8), False, "f64",
                                    JAX_IMPL[variant])
    rj = jax_cg.solve_cg(Aj, b, itermax=25, verbose=False, variant=variant)
    rt = cg.solve_cg(A, b, itermax=25, verbose=False, variant=variant)
    assert rt.iterations == rj.iterations == 25
    assert_histories_agree(rt.residual_history, rj.residual_history, "f64")
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    assert cg.check_residual(rt.x, xexact) < 1e-8


@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_stencil_variant_f32_matches_jax(variant):
    Aj, A, b, xexact = stencil_pair((12, 11, 10), True, "f32",
                                    JAX_IMPL[variant])
    rj = jax_cg.solve_cg(Aj, b, itermax=40, verbose=False, variant=variant)
    rt = cg.solve_cg(A, b, itermax=40, verbose=False, variant=variant)
    assert rt.x.dtype == np.float32
    assert rt.residual_history.dtype == np.float32
    assert_histories_agree(rt.residual_history, rj.residual_history, "f32")
    assert cg.check_residual(rt.x, xexact) < 1e-4


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cs_on_dia_matches_jax(dtype):
    jp = JaxPolicy.from_names(dtype, "i32")
    Aj, counts = JaxDia.from_stencil(12, 10, 9, policy=jp, impl="xla")
    A = DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="torch")
    _x, b, xexact = cg.init_vectors(dtype=NP_DT[dtype],
                                    row_lengths=np.asarray(counts))
    rj = jax_cg.solve_cg(Aj, b, itermax=60, verbose=False, variant="cs")
    rt = cg.solve_cg(A, b, itermax=60, verbose=False, variant="cs")
    if dtype == "f64":
        assert rt.iterations == rj.iterations
    assert_histories_agree(rt.residual_history, rj.residual_history, dtype)
    assert cg.check_residual(rt.x, xexact) < (1e-8 if dtype == "f64"
                                              else 1e-4)


def test_fused_cs_branch_matches_jax(monkeypatch):
    """SB_FUSED_CS=1 switches cs on the stencil (f32 accumulation) to the
    apply-with-dots form (K2) and the one-pass update (K4), as it switches
    the JAX package (tests/test_stencil_op.py
    test_pallas_cs_fused_matches_standard)."""
    monkeypatch.setenv("SB_FUSED_CS", "1")
    Aj, A, b, xexact = stencil_pair((10, 9, 8), False, "f32", "pallas")
    calls = {"dots": 0, "update": 0}
    dots = StencilOperator.spmv_permuted_dots
    update = cg.cs_update

    def counted_dots(self, x):
        calls["dots"] += 1
        return dots(self, x)

    def counted_update(*a):
        calls["update"] += 1
        return update(*a)

    monkeypatch.setattr(StencilOperator, "spmv_permuted_dots", counted_dots)
    monkeypatch.setattr(cg, "cs_update", counted_update)
    rt = cg.solve_cg(A, b, itermax=40, verbose=False, variant="cs")
    # warm-up and timed solve: 1 + 39 applies and 39 updates each
    assert calls == {"dots": 80, "update": 78}
    rj = jax_cg.solve_cg(Aj, b, itermax=40, verbose=False, variant="cs")
    assert_histories_agree(rt.residual_history, rj.residual_history, "f32")
    assert cg.check_residual(rt.x, xexact) < 1e-4
    # f64 accumulation keeps the plain body, as in the JAX package
    calls.update(dots=0, update=0)
    cg.solve_cg(A, b.astype(np.float64), itermax=5, verbose=False,
                variant="cs")
    assert calls == {"dots": 0, "update": 0}


@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_eps_exit_with_x0_matches_jax(variant):
    """The lagged exit test on the 7-point stencil from a nonzero x0."""
    Aj, A, b, _ = stencil_pair((8, 8, 8), True, "f64", JAX_IMPL[variant])
    x0 = np.random.default_rng(2).standard_normal(A.nr) * 0.1
    rj = jax_cg.solve_cg(Aj, b, x0=x0, itermax=40, eps=1e-8, verbose=False,
                         variant=variant)
    rt = cg.solve_cg(A, b, x0=x0, itermax=40, eps=1e-8, verbose=False,
                     variant=variant)
    assert rt.iterations == rj.iterations < 40
    assert_histories_agree(rt.residual_history, rj.residual_history, "f64")
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_breakdown_matches_jax(variant):
    """x0 = the exact solution: r0 = 0 exactly. With eps = -1 the first
    body runs, finds p.Ap = 0 <= 0, takes alpha = 0 and ends the solve at
    k = 2 with x untouched."""
    Aj, A, b, xexact = stencil_pair((6, 5, 4), False, "f64",
                                    JAX_IMPL[variant])
    rj = jax_cg.solve_cg(Aj, b, x0=xexact, itermax=10, eps=-1.0,
                         verbose=False, variant=variant)
    rt = cg.solve_cg(A, b, x0=xexact, itermax=10, eps=-1.0, verbose=False,
                     variant=variant)
    assert rt.iterations == rj.iterations == 2
    np.testing.assert_array_equal(rt.residual_history, [0.0, 0.0])
    np.testing.assert_array_equal(rt.x, xexact)


def test_cs_breakdown_on_dia_matches_jax():
    """2*I with b = 1 (tests/test_torch_cg.py's breakdown case) under cs."""
    from sparsebench_tpu.host import HostCSR

    n = 300
    csr = HostCSR(row_ptr=np.arange(n + 1), col=np.arange(n),
                  val=np.full(n, 2.0), nr=n, nc=n)
    Aj = JaxDia.from_csr(csr, JaxPolicy.from_names("f64", "i32"), impl="xla")
    A = DiaMatrix.from_jax_arrays(np.asarray(Aj.data), Aj.offsets, n, n, n,
                                  Aj.nr_pad, device=CPU, impl="torch")
    rj = jax_cg.solve_cg(Aj, np.ones(n), itermax=20, verbose=False,
                         variant="cs")
    rt = cg.solve_cg(A, np.ones(n), itermax=20, verbose=False, variant="cs")
    assert rt.iterations == rj.iterations
    np.testing.assert_array_equal(rt.residual_history, rj.residual_history)
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))


@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_masked_bodies_leave_the_state_untouched(variant):
    """A solve that exits by eps at k = K gives the bits of a solve with
    itermax = K: the bodies after the exit change nothing (the masked
    loop's two segments equal one run)."""
    A, counts = StencilOperator.from_stencil(7, 6, 5, device=CPU)
    _x, b, _xe = cg.init_vectors(row_lengths=counts)
    early = cg.solve_cg(A, b, itermax=60, eps=1e-6, verbose=False,
                        variant=variant)
    assert early.iterations < 60
    exact = cg.solve_cg(A, b, itermax=early.iterations, verbose=False,
                        variant=variant)
    np.testing.assert_array_equal(early.x, exact.x)
    np.testing.assert_array_equal(early.residual_history,
                                  exact.residual_history)


def test_cg_run_segments_on_the_stencil():
    A, counts = StencilOperator.from_stencil(8, 7, 6, device=CPU)
    _x, b, _xe = cg.init_vectors(row_lengths=counts)
    b = torch.from_numpy(b)
    x0 = torch.zeros_like(b)
    one = cg.cg_run(A, cg.cg_init(A, b, x0, 50), 50, 0.0)
    half = cg.cg_run(A, cg.cg_init(A, b, x0, 50), 20, 0.0)
    two = cg.cg_run(A, half, 50, 0.0)
    for a, c in zip(one, two):
        assert torch.equal(a, c)


def jax_refusal(variant):
    Aj, _ = JaxDia.from_stencil(4, 4, 4, policy=JaxPolicy.from_names("f64"),
                                impl="xla")
    with pytest.raises(ValueError) as exc:
        jax_cg.solve_cg(Aj, np.ones(64), itermax=3, verbose=False,
                        variant=variant)
    return str(exc.value)


@pytest.mark.parametrize("variant", ["fused", "vmem"])
def test_variant_refused_on_dia_with_jax_wording(variant):
    A, _ = DiaMatrix.from_stencil(4, 4, 4, device=CPU)
    with pytest.raises(ValueError) as exc:
        cg.solve_cg(A, np.ones(64), itermax=3, verbose=False, variant=variant)
    head = f"variant {variant!r} needs a"
    assert str(exc.value).startswith(head[:-2])
    assert jax_refusal(variant).startswith(head[:-2])


def test_vmem_refused_at_200_cubed():
    """The kernel's wrapper alone judges the L2 plan, at the vectors' width:
    200^3 is refused in f32, 100^3 runs in f32 and f64 (bf16 runs in f32)."""
    A, counts = StencilOperator.from_stencil(200, 200, 200, device=CPU)
    assert A.supports_vmem_cg
    b = torch.ones(A.nr)
    with pytest.raises(ValueError, match=r"not viable at 200x200x200: r and "
                       r"p take 61\.0 MB in torch\.float32"):
        cg.cg_vmem_loop(A, b, torch.zeros_like(b), 150, 0.0)
    small, counts = StencilOperator.from_stencil(100, 100, 100, device=CPU)
    for dt in (torch.float64, torch.bfloat16):
        b = torch.from_numpy(27.0 - (counts - 1.0)).to(dt)
        x, k, hist = cg.cg_vmem_loop(small, b, torch.zeros_like(b), 3, 0.0)
        assert int(k) == 3 and x.dtype == dt


# -- the CLI ------------------------------------------------------------------


def parse(out):
    res = {0: float(re.search(r"Initial Residual = (\S+)", out).group(1))}
    for j, v in re.findall(r"Iteration = (\d+) Residual = (\S+)", out):
        res[int(j)] = float(v)
    k = int(re.search(r"Solution performed (\d+) iterations", out).group(1))
    diff = re.search(r"Difference between computed and exact  = (\S+)",
                     out).group(1)
    return res, k, diff


@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_cli_stencil_variant_matches_jax_cli(variant, capsys):
    argv = ["--fmt", "stencil", "-t", "cg", "--cg-variant", variant,
            "-x", "10", "-y", "9", "-z", "8", "-i", "25", "--dtype", "f64"]
    assert jax_cli.main(argv + ["--impl", "pallas"]) == 0
    res_j, k_j, diff_j = parse(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res_t, k_t, diff_t = parse(out)
    assert "| format stencil |" in out and "(format stencil)" in out
    assert k_t == k_j == 25
    assert diff_t == diff_j
    assert sorted(res_t) == sorted(res_j)
    above = [j for j in res_j if res_j[j] >= 1e-10 * res_j[0]]
    assert len(above) >= 5
    np.testing.assert_allclose([res_t[j] for j in above],
                               [res_j[j] for j in above], rtol=2e-6)


def test_cli_stencil_spmv_and_format_lines(capsys):
    assert cli.main(["-t", "spmv", "--fmt", "stencil", "-x", "6", "-y", "5",
                     "-z", "4", "-i", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Test type: SPMVM" in out and "spMVM best per-iteration" in out
    assert "| format stencil |" in out
    assert "SpMV streams 0.0 B/nnz physical" in out  # the operator stores nothing
    assert cli.main(["-x", "4", "-y", "4", "-z", "4", "-i", "3",
                     "--device", "cpu"]) == 0
    assert "| format dia |" in capsys.readouterr().out  # auto runs dia


def test_cli_stencil_refuses_a_matrix_file(data_dir, capsys):
    with pytest.raises(SystemExit, match="matrix-free and only applies to "
                       "generated problems"):
        cli.main(["-m", str(data_dir / "matrix_band_klein.mtx"), "--fmt",
                  "stencil", "--device", "cpu"])


@pytest.mark.parametrize("argv,match", [
    (["--fmt", "stencil", "--cg-variant", "vmem", "-x", "200", "-y", "200",
      "-z", "200"], "not viable at 200x200x200"),
    (["--fmt", "dia", "--cg-variant", "fused", "-x", "4", "-y", "4", "-z",
      "4"], "variant 'fused' needs a format"),
])
def test_cli_refuses_a_variant_the_operator_cannot_run(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["-i", "3", "--device", "cpu"])
