"""Operator preconditioners (counterpart of sparsebench_tpu/solvers/precond.py;
beyond the reference, which is unpreconditioned).

* Jacobi: z = D^-1 r, with ``inv_diag`` = 1/diag(A) in the solve's row
  order.
* ``ChebPrecond``: the Chebyshev semi-iteration run for a fixed ``degree``
  steps from z0 = 0, z = p_k(A) r with p_k the degree-k Chebyshev
  approximation of 1/x on [lmin, lmax] (Saad, "Iterative Methods for Sparse
  Linear Systems", Alg. 12.1). A fixed polynomial in an SPD A is SPD, so
  plain CG theory holds. One apply is ``degree`` SpMVs and axpys and no dot
  product.
* Both together: M^-1 = p_k(D^-1 A) D^-1, with bounds for spec(D^-1 A).

The bounds come from the Lanczos estimate of ``solvers/chebyshev.py``
(``estimate_bounds``, weighted for the scaled operator). Plain torch: the
JAX package has no kernel here either.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChebPrecond:
    """Fixed Chebyshev polynomial preconditioner z = p_degree(A) r:
    ``lmin``/``lmax`` are Python floats, ``degree >= 1`` the number of
    operator applications an apply."""

    lmin: float
    lmax: float
    degree: int = 3

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if not (0 < self.lmin < self.lmax):
            raise ValueError(
                f"need 0 < lmin < lmax, got [{self.lmin}, {self.lmax}]"
            )

    @classmethod
    def from_jax(cls, pc) -> "ChebPrecond":
        """The same preconditioner as a JAX package ``ChebPrecond`` (any
        object with ``lmin``, ``lmax`` and ``degree``)."""
        return cls(float(pc.lmin), float(pc.lmax), int(pc.degree))

    def apply(self, matvec, r):
        """z = p_degree(A) r by the Chebyshev semi-iteration from z0 = 0,
        ``matvec`` the (scaled, where Jacobi-composed) operator apply.
        The scalar recurrence runs in Python floats, as in the JAX
        package."""
        theta = (self.lmax + self.lmin) / 2.0
        delta = (self.lmax - self.lmin) / 2.0
        sigma1 = theta / delta
        d = r / theta
        z = d
        rho = 1.0 / sigma1
        for _ in range(self.degree):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (r - matvec(z))
            z = z + d
            rho = rho_new
        return z


def cheb_precond_for(A, nr: int, dtype, degree: int = 3, permute=None,
                     inv_diag=None) -> ChebPrecond:
    """A ChebPrecond for ``A`` from Lanczos bounds with the precond-mode
    margins. ``inv_diag`` (original row order) switches the estimate to
    spec(D^-1 A), the operator that ``resolve_apply_m`` builds when both
    are passed to a solver."""
    from sparsebench_tpu_torch.solvers.chebyshev import estimate_bounds

    lmin, lmax = estimate_bounds(A, nr, dtype, permute=permute,
                                 inv_diag=inv_diag, mode="precond")
    return ChebPrecond(lmin, lmax, degree)


def resolve_apply_m(precond, inv_diag, matvec, vdt):
    """The one place the (precond, inv_diag) pair becomes an apply-M
    callable, shared by every solver loop:

      * both None          -> None (unpreconditioned)
      * inv_diag only      -> Jacobi, z = D^-1 r
      * precond only       -> z = p_k(A) r
      * precond + inv_diag -> z = p_k(D^-1 A) D^-1 r

    ``matvec`` is the operator's SpMV (not used by Jacobi alone)."""
    if precond is None and inv_diag is None:
        return None
    if precond is None:
        return lambda r: (inv_diag * r).to(vdt)
    if inv_diag is None:
        mv = lambda v: matvec(v).to(vdt)  # noqa: E731
        return lambda r: precond.apply(mv, r).to(vdt)
    mv = lambda v: (inv_diag * matvec(v)).to(vdt)  # noqa: E731
    return lambda r: precond.apply(mv, (inv_diag * r).to(vdt)).to(vdt)
