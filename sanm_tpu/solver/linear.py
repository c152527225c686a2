"""Linear system solvers preserving ANM's factorize-once / solve-N-times
structure.

Counterpart of the reference MKL-PARDISO wrapper
(``libsanm/sparse_solver.{h,cpp}``): ``prepare()`` = analysis +
factorization done once per continuation step, ``solve()`` = cheap
back-substitution repeated once per Taylor order
(``libsanm/anm.cpp:223-291`` does 1 ``prepare`` + N ``solve``).

XLA has no sparse direct factorization primitive.  Paths:

* :class:`DenseFactorSolver` — dense QR (general) or Cholesky
  (``A^T A + lambda I`` Tikhonov mode, reference
  ``sparse_solver.cpp:327-421``); exact, for small/medium systems.
* :class:`HostLUSolver` — host scipy sparse LU via ordered
  ``io_callback``; the structural PARDISO analog for large systems.
* :class:`DeviceCholSolver` — dense f32 Cholesky of the equilibrated
  stiffness on the device + f64 iterative refinement.
* :class:`SparseCG` — device-resident preconditioned CG on the
  assembled CSR operator (gather + multiply + segment-add matvec, all
  shardable over the element axis).

All solvers are jit-traceable: construction and solves happen inside the
jitted expansion kernel.

Precision of the float32 factor routes (``DenseFactorSolver``'s mixed
mode, ``DeviceCholSolver``, :class:`~sanm_tpu.solver.band.DeviceBandCholSolver`,
``SparseCG``'s preconditioner): every dot passes
``precision=F32_PRECISION`` (``HIGHEST``, full f32 products) so none
inherits the backend default, which on an NVIDIA GPU may be TF32.  The
factorizations and triangular substitutions themselves are cuSOLVER /
cuBLAS calls (``potrf``, ``geqrf``, ``trsm``) on the GPU.  The f64
refinement then brings each solve to a relative error of 1e-10 or
better against SciPy ``splu`` on the same CSR matrix (checked at
armadillo-small n by ``chip_smoke.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
import jax.scipy.linalg as jsl
import numpy as np

from ..utils import SANMError, sanm_assert

#: precision of every dot inside the float32 factor routes (see the
#: module docstring)
F32_PRECISION = lax.Precision.HIGHEST


def _mv(A, x):
    """Exact-precision f64 matvec for refinement residuals."""
    return jnp.einsum("ij,j->i", A, x, precision="highest")


def _mv_t(A, x):
    return jnp.einsum("ji,j->i", A, x, precision="highest")


def host_splu(Acsc):
    """Host SuperLU factorization of the stiffness, symmetric-mode first.

    The ANM stiffness is structurally symmetric (tet adjacency) and
    numerically near-SPD along stable continuation branches.  SuperLU's
    ``SymmetricMode`` (MMD ordering on A+A^T + near-diagonal threshold
    pivoting) then keeps the symbolic MMD fill, where the default COLAMD
    path pays partial-pivoting fill and factorizes the armadillo-small
    stiffness pattern about half as fast.  Plain
    ``permc_spec='MMD_AT_PLUS_A'`` WITHOUT symmetric mode is the
    opposite trap — full partial pivoting destroys the symmetric
    ordering and is slower still.

    Threshold pivoting is a numerical gamble on indefinite states, so
    the result is validated with one deterministic random-RHS solve
    (cost: one backsolve + one spmv per factorization); on
    relative residual > 1e-12 — or any SuperLU error — it falls back to
    the default COLAMD factorization.  ``SANM_SPLU_SYM=0`` disables the
    symmetric-mode attempt entirely.  This is the closest scipy analog
    of PARDISO's symmetric mtype=-2 path
    (``libsanm/sparse_solver.cpp:107-127``)."""
    import os

    import scipy.sparse.linalg as spla

    if os.environ.get("SANM_SPLU_SYM", "1") != "0":
        try:
            lu = spla.splu(
                Acsc,
                permc_spec="MMD_AT_PLUS_A",
                options=dict(SymmetricMode=True, DiagPivotThresh=0.001),
            )
            b = np.random.default_rng(0).standard_normal(Acsc.shape[0])
            x = lu.solve(b)
            rel = np.linalg.norm(Acsc @ x - b) / np.linalg.norm(b)
            # 1e-12: a healthy near-SPD stiffness factors to ~1e-15
            # here; anything worse means the 0.001-threshold pivots
            # lost digits the order recurrences cannot spare, and
            # paying a second (COLAMD) factorization on such rare
            # states is cheaper than a degraded expansion.
            if np.isfinite(rel) and rel < 1e-12:
                return lu
        except Exception:
            pass
    return spla.splu(Acsc)


class DenseFactorSolver:
    """Factor once (QR or Cholesky), back-substitute many times.

    ``l2_penalty``: Tikhonov mode — solve (A^T A + penalty*I) x = A^T b,
    mirroring the reference's ``xcoeff_l2_penalty``
    (``libsanm/sparse_solver.cpp:327-421`` via ``mkl_sparse_syrk``).

    ``mixed_precision``: factorize in float32 and recover float64
    accuracy with iterative refinement — each step
    computes the residual with exact f64 matvecs and back-substitutes it
    through the f32 factors.  Converges to ~1e-15 relative residual as
    long as kappa(A) stays below ~1e7; the refinement loop is a
    while_loop with a hard cap, so ill-conditioned systems degrade
    gracefully to the f32 solution quality."""

    def __init__(self, A, l2_penalty: float = 0.0,
                 mixed_precision: bool = True, refine_tol: float = 1e-14,
                 max_refine: int = 25):
        self.A = A
        self.l2_penalty = float(l2_penalty)
        self.refine_tol = refine_tol
        self.max_refine = max_refine
        n = A.shape[0]
        sanm_assert(A.shape[0] == A.shape[1], "square system required")
        self.mixed = bool(mixed_precision) and A.dtype == jnp.float64
        fdtype = jnp.float32 if self.mixed else A.dtype
        if self.l2_penalty:
            self.G = jnp.einsum(
                "ji,jk->ik", A, A, precision="highest"
            ) + self.l2_penalty * jnp.eye(n, dtype=A.dtype)
            self._chol = jnp.linalg.cholesky(self.G.astype(fdtype))
            self._q = None
        else:
            # QR: robust for the unsymmetric systems PARDISO mtype=11
            # handles in the reference (sparse_solver.cpp:107-127)
            q, r = jnp.linalg.qr(A.astype(fdtype))
            self._q = q
            self._r = r
            self._chol = None

    def _backsub(self, b):
        """One pass through the (possibly f32) factors.  The RHS is
        normalized before the downcast: Taylor-order right-hand sides can
        sit far below float32's exponent range (e.g. 1e-30), which would
        silently underflow to zero."""
        fdtype = self._r.dtype if self._chol is None else self._chol.dtype
        scale = jnp.linalg.norm(b)
        safe = jnp.where(scale > 0, scale, 1.0)
        bf = (b / safe).astype(fdtype)
        if self.l2_penalty:
            y = jsl.solve_triangular(self._chol, bf, lower=True)
            x = jsl.solve_triangular(self._chol.T, y, lower=False)
        else:
            x = jsl.solve_triangular(
                self._r,
                jnp.matmul(self._q.T, bf, precision=F32_PRECISION),
                lower=False,
            )
        return x.astype(b.dtype) * safe

    def solve(self, b):
        b = b.reshape(-1)
        if self.l2_penalty:
            b = _mv_t(self.A, b)
            mat = self.G
        else:
            mat = self.A
        x = self._backsub(b)
        if not self.mixed:
            return x
        # iterative refinement with a monotone safeguard: converges at
        # rate ~kappa*eps_f32 per step; if a step fails to reduce the
        # residual (severe ill-conditioning), the best iterate is kept
        # and the loop exits rather than diverging.
        bnorm = jnp.linalg.norm(b) + 1e-300

        def body(state):
            x, rnorm, it, _ = state
            r = b - _mv(mat, x)
            x_new = x + self._backsub(r)
            rnorm_new = jnp.linalg.norm(b - _mv(mat, x_new))
            improved = rnorm_new < rnorm
            x = jnp.where(improved, x_new, x)
            return (
                x,
                jnp.where(improved, rnorm_new, rnorm),
                it + 1,
                improved,
            )

        def cond(state):
            x, rnorm, it, improved = state
            return (
                (rnorm > self.refine_tol * bnorm)
                & (it < self.max_refine)
                & improved
            )

        r0 = jnp.linalg.norm(b - _mv(mat, x))
        x, _, _, _ = jax.lax.while_loop(
            cond, body, (x, r0, 0, jnp.asarray(True))
        )
        return x

    def apply(self, x):
        """A @ x, for the solver-level sanity checks
        (reference ``SparseSolver::apply``, ``sparse_solver.cpp:182-215``)."""
        return _mv(self.A, x.reshape(-1))

    def coeff_l2(self):
        """Frobenius norm of the system coefficients (reference
        ``SparseSolver::coeff_l2``)."""
        return jnp.sqrt(jnp.sum(self.A * self.A))


class HostLUSolver:
    """Sparse LU on the host (scipy splu), driven from inside the jitted
    expansion via ordered ``io_callback``s.

    This is the closest structural analog of the reference's PARDISO
    wrapper (``libsanm/sparse_solver.cpp:327-421``): one analysis +
    factorization per continuation step, then one cheap back-substitution
    per Taylor order.  The factorization runs on the host CPU while the
    device handles all batched element work; only the (nnz,) value vector
    and the (n,) right-hand sides cross the boundary.
    """

    _registry = {}
    _next_key = [0]

    def __init__(self, assembler, data, l2_penalty: float = 0.0):
        import weakref

        from jax.experimental import io_callback

        self.assembler = assembler
        self.n = assembler.n
        self.l2_penalty = float(l2_penalty)
        # One registry slot PER ASSEMBLER (i.e. per linear-system
        # topology), not per instance: the ANM driver builds a fresh
        # HostLUSolver every continuation restart, and per-instance
        # keys leaked one LU + CSR copy per restart for process
        # lifetime.  Re-factorizing overwrites the slot (the previous
        # restart's solves have all executed by then — dispatch is
        # sequential through the ordered-token dataflow), and the slot
        # itself is evicted when the assembler dies.
        key = getattr(assembler, "_hostlu_key", None)
        if key is None:
            key = HostLUSolver._next_key[0]
            HostLUSolver._next_key[0] += 1
            assembler._hostlu_key = key
            weakref.finalize(
                assembler, HostLUSolver._registry.pop, key, None
            )
        self.key = key
        self._data = data

        key = self.key
        rowidx = assembler.csr_rowidx
        cols = assembler.csr_cols
        n = self.n
        pen = self.l2_penalty

        def factorize_cb(vals):
            import scipy.sparse as sp

            A = sp.csr_matrix(
                (np.asarray(vals), (rowidx, cols)), shape=(n, n)
            )
            if pen:
                G = (A.T @ A).tocsc()
                G = G + pen * sp.identity(n, format="csc")
                HostLUSolver._registry[key] = (host_splu(G), A)
            else:
                HostLUSolver._registry[key] = (host_splu(A.tocsc()), A)
            return np.zeros((), np.int32)

        # the token creates a data dependency factorize -> every solve,
        # making the ordering explicit in dataflow (safe inside lax.scan,
        # where ordered host effects are not permitted)
        self._token = io_callback(
            factorize_cb,
            jax.ShapeDtypeStruct((), jnp.int32),
            data,
        )

        def solve_cb(tok, b):
            lu, A = HostLUSolver._registry[key]
            rhs = A.T @ np.asarray(b) if pen else np.asarray(b)
            return lu.solve(rhs)

        self._solve_cb = solve_cb

    def solve(self, b):
        from jax.experimental import io_callback

        return io_callback(
            self._solve_cb,
            jax.ShapeDtypeStruct((self.n,), b.dtype),
            self._token,
            b.reshape(-1),
        )

    def apply(self, x):
        return self.assembler.matvec(self._data, x.reshape(-1))

    def coeff_l2(self):
        return jnp.sqrt(jnp.sum(self._data * self._data))


def blocked_cholesky(A, block: int = 2048):
    """In-place right-looking blocked Cholesky of an SPD matrix.

    ``jnp.linalg.cholesky`` materializes ~3 full n^2 buffers (input,
    workspace, output).  This version runs a ``fori_loop`` over column
    panels carrying ONE (n, n) buffer, with the trailing update applied
    one (block, n) row panel at a time: per-step peak = the carry plus
    two (block, n) panels (~0.7 GB at n=43k/block=2048).  A full-width
    masked-matmul update would add an (n, n) f32 product buffer (7.4 GB
    at n=41k).  The row-panel matmuls are still full-width (static
    shapes): ~n^3/2 f32 FLOPs at n=41k (~4e13).  The row-panel layout
    is also what lets the factor stay row-sharded over a device mesh.
    Only the lower triangle of the result is meaningful.
    NaNs from an indefinite input propagate to the factor (callers
    detect via ``isfinite`` on the diagonal)."""
    n = A.shape[0]
    nb = -(-n // block)
    npad = nb * block
    if npad != n:
        pad_idx = jnp.arange(n, npad)
        P = jnp.zeros((npad, npad), A.dtype)
        P = P.at[:n, :n].set(A)
        A = P.at[pad_idx, pad_idx].set(1.0)
    rows = jnp.arange(npad)

    def body(j, A):
        c0 = j * block
        Ajj = lax.dynamic_slice(A, (c0, c0), (block, block))
        Ljj = jnp.linalg.cholesky(Ajj)
        Pcol = lax.dynamic_slice(A, (0, c0), (npad, block))
        # T = Pcol @ Ljj^{-T}
        T = jsl.solve_triangular(Ljj, Pcol.T, lower=True).T
        below = rows >= c0 + block
        Tm = jnp.where(below[:, None], T, 0.0)

        # trailing update A -= Tm Tm^T by row panels; panels i <= j are
        # all-zero rows of Tm (masked above), so start at j + 1.  The
        # product's nonzero rows AND columns both sit at >= c0 + block,
        # so finalized L panels (columns < c0) are untouched.
        def row_update(i, A):
            r0 = i * block
            Trow = lax.dynamic_slice(Tm, (r0, 0), (block, block))
            upd = jnp.matmul(Trow, Tm.T, precision=F32_PRECISION)
            Arow = lax.dynamic_slice(A, (r0, 0), (block, npad))
            return lax.dynamic_update_slice(A, Arow - upd, (r0, 0))

        A = lax.fori_loop(j + 1, nb, row_update, A)
        A = lax.dynamic_update_slice(A, Tm, (0, c0))
        A = lax.dynamic_update_slice(A, Ljj, (c0, c0))
        return A

    A = jax.lax.fori_loop(0, nb, body, A)
    return A[:n, :n] if npad != n else A


def blocked_tri_solve_lower(L, b, block: int = 2048):
    """Forward substitution ``L y = b`` by column panels.

    ``solve_triangular`` on a device-mesh-sharded ``L`` makes GSPMD
    all-gather the FULL factor per solve (n^2 traffic — 23.7 GB f32 at
    human scale), defeating the point of sharding it.  The blocked
    form only ever touches an (n, block) panel per step: the panel
    matvec stays row-sharded (no factor movement) and the only
    replicated values are the (block,) panel solution and the
    (block, block) diagonal block.  Assumes ``L``/``b`` already padded
    to a multiple of ``block`` with unit diagonal in the pad (the
    convention :func:`blocked_cholesky` produces)."""
    n = L.shape[0]
    nb = n // block
    rows = jnp.arange(n)

    def body(j, b):
        c0 = j * block
        Ljj = lax.dynamic_slice(L, (c0, c0), (block, block))
        bj = lax.dynamic_slice(b, (c0,), (block,))
        yj = jsl.solve_triangular(Ljj, bj, lower=True)
        col = lax.dynamic_slice(L, (0, c0), (n, block))
        below = rows >= c0 + block
        b = b - jnp.where(
            below, jnp.matmul(col, yj, precision=F32_PRECISION), 0.0
        )
        return lax.dynamic_update_slice(b, yj, (c0,))

    return lax.fori_loop(0, nb, body, b)


def blocked_tri_solve_upper_T(L, y, block: int = 2048):
    """Backward substitution ``L^T x = y`` by column panels of ``L^T``
    (= row panels of ``L``, so a row-sharded factor moves one
    (block, n) panel per step).  Same padding convention as
    :func:`blocked_tri_solve_lower`."""
    n = L.shape[0]
    nb = n // block
    rows = jnp.arange(n)

    def body(i, y):
        c0 = (nb - 1 - i) * block
        Ljj = lax.dynamic_slice(L, (c0, c0), (block, block))
        yj = lax.dynamic_slice(y, (c0,), (block,))
        xj = jsl.solve_triangular(Ljj.T, yj, lower=False)
        rowp = lax.dynamic_slice(L, (c0, 0), (block, n))
        above = rows < c0
        y = y - jnp.where(
            above, jnp.matmul(xj, rowp, precision=F32_PRECISION), 0.0
        )
        return lax.dynamic_update_slice(y, xj, (c0,))

    return lax.fori_loop(0, nb, body, y)


def blocked_chol_solve(L, b, block: int = 2048):
    """``(L L^T)^{-1} b`` through the blocked substitutions; the
    mesh-sharding-friendly counterpart of the two ``solve_triangular``
    calls in :func:`chol_refine_solve`'s backsub.  Accepts a factor
    already padded to a ``block`` multiple (the :func:`chol_pad_n`
    convention — no n^2 copy); otherwise pads ``L``/``b`` here (unit
    diagonal / zeros)."""
    n = b.shape[0]
    npad = -(-L.shape[0] // block) * block
    if L.shape[0] != npad:
        pad_idx = jnp.arange(L.shape[0], npad)
        P = jnp.zeros((npad, npad), L.dtype)
        P = P.at[: L.shape[0], : L.shape[0]].set(L)
        L = P.at[pad_idx, pad_idx].set(1.0)
    if n != npad:
        b = jnp.concatenate([b, jnp.zeros((npad - n,), b.dtype)])
    y = blocked_tri_solve_lower(L, b, block)
    x = blocked_tri_solve_upper_T(L, y, block)
    return x[:n]


# above this size switch from jnp.linalg.cholesky's ~3 n^2 buffers to
# the single-buffer blocked factorization
_BLOCKED_CHOL_MIN_N = 16384


def chol_pad_n(n: int, block: int = 2048) -> int:
    """Factor size consumers should assemble into: a ``block`` multiple
    for the single-buffer blocked path (so :func:`blocked_cholesky` and
    :func:`blocked_chol_solve` never copy the n^2 buffer to pad it),
    ``n`` itself below the dense threshold."""
    if n >= _BLOCKED_CHOL_MIN_N:
        return -(-n // block) * block
    return n


def chol_factor(M):
    """Lower-triangular Cholesky factor of SPD ``M``, choosing the
    memory-lean blocked path for large systems.  Large inputs should be
    pre-padded to :func:`chol_pad_n` (unit diagonal in the pad); the
    factor is then returned padded — downstream solves zero-extend the
    RHS instead of slicing the factor (an n^2 copy)."""
    if M.shape[0] >= _BLOCKED_CHOL_MIN_N:
        return blocked_cholesky(M)
    return jnp.linalg.cholesky(M)


def chol_refine_solve(L, s, data, b, matvec, refine_steps: int,
                      tri_solve=None, rtol: float = 1e-12,
                      with_resid: bool = False):
    """Solve ``A x = b`` through the f32 Cholesky factor ``L`` of the
    Jacobi-equilibrated, sign-flipped system (see
    :class:`DeviceCholSolver`) with up to ``refine_steps`` rounds of
    f64 iterative refinement against the exact sparse operator
    ``matvec``.  Jit-traceable; used both standalone and inside the
    fused per-order device step of the hybrid loop.

    Refinement exits early (``lax.while_loop``, all on device) once
    ``||b - A x|| <= rtol * ||b||`` — an f32 factor of the
    equilibrated system typically converges in 2-3 passes, and each
    backsub streams the whole factor through device memory, so a fixed
    8-trip loop pays ~3x the needed traffic.  ``rtol=0`` restores the
    fixed-trip behavior.  ``with_resid`` also returns the final relative
    residual and the number of refinement passes taken after the first
    backsub.

    ``tri_solve(L, rhs)`` overrides the two dense ``solve_triangular``
    passes — :func:`blocked_chol_solve` keeps a mesh-sharded factor
    sharded (plain ``solve_triangular`` makes GSPMD all-gather it).

    ``L`` may be padded past n (the :func:`chol_pad_n` convention, unit
    diagonal in the pad): the RHS is zero-extended and the solution
    sliced — the pad rows solve to exact zeros."""
    if tri_solve is None:
        def tri_solve(Lf, rf):
            y = jsl.solve_triangular(Lf, rf, lower=True)
            return jsl.solve_triangular(Lf.T, y, lower=False)

    def backsub(r):
        # norm-prescale before the f32 downcast: Taylor RHS norms reach
        # 1e-30, far below f32's exponent range
        scale = jnp.linalg.norm(r)
        safe = jnp.where(scale > 0, scale, 1.0)
        rf = ((r / safe) * s).astype(jnp.float32)
        # dense factors (2-D) may be padded past n (chol_pad_n); the
        # skyline factor is a tuple of per-run column-panel stacks
        # whose tri hook pads itself
        if hasattr(L, "ndim") and L.ndim == 2 and L.shape[0] != rf.shape[0]:
            rf = jnp.concatenate(
                [rf, jnp.zeros((L.shape[0] - rf.shape[0],), rf.dtype)]
            )
        y = tri_solve(L, rf)[: r.shape[0]]
        return -(y.astype(r.dtype) * s) * safe

    x0 = backsub(b)
    if rtol <= 0:
        def body(_, x):
            r = b - matvec(data, x)
            return x + backsub(r)

        x = jax.lax.fori_loop(0, refine_steps, body, x0)
        if not with_resid:
            return x
        rel = jnp.linalg.norm(b - matvec(data, x)) / jnp.maximum(
            jnp.linalg.norm(b), 1e-300
        )
        return x, rel, jnp.int32(refine_steps)

    thresh = rtol * jnp.linalg.norm(b)
    r0 = b - matvec(data, x0)

    def cond(state):
        i, _, r = state
        return jnp.logical_and(i < refine_steps,
                               jnp.linalg.norm(r) > thresh)

    def body(state):
        i, x, r = state
        x = x + backsub(r)
        return i + 1, x, b - matvec(data, x)

    steps, x, r = jax.lax.while_loop(cond, body, (jnp.int32(0), x0, r0))
    if not with_resid:
        return x
    rel = jnp.linalg.norm(r) / jnp.maximum(jnp.linalg.norm(b), 1e-300)
    return x, rel, steps


class DeviceCholSolver:
    """Device-resident factorize-once / backsolve-N-times for mid-size
    systems: dense f32 Cholesky of the (equilibrated, symmetrized)
    stiffness on the accelerator + f64 iterative refinement through the
    exact sparse operator.

    This keeps the reference's PARDISO structure
    (``libsanm/sparse_solver.cpp:154-180,327-421``: one analysis +
    factorization per continuation step, then one cheap backsolve per
    Taylor order) entirely on the device — no per-order host crossing,
    unlike :class:`HostLUSolver` whose every solve pulls the RHS to the
    host.  Mapping to the hardware: the O(n^3) factorization is matmul
    work, the O(n^2) triangular solves are memory-bandwidth work; the
    O(nnz) refinement matvec is the assembler's gather/scatter.
    Precision: see the module docstring (``F32_PRECISION``).

    Scope: dense L is n^2 f32 (6.7 GB at armadillo-small n=41k).  The
    elastic stiffness is symmetric; it is negative definite at stable
    states (A = d force/dx = -K), so the factorization runs on -A_s and
    flips the sign back.  ``factor_ok()`` reports a finite factor; the
    driver falls back to host LU when the state is indefinite (e.g.
    across a bifurcation)."""

    def __init__(self, assembler, data, l2_penalty: float = 0.0,
                 refine_steps: int = 8, mesh=None, mesh_axis=None):
        sanm_assert(l2_penalty == 0.0,
                    "dense_chol: Tikhonov mode not supported")
        self.assembler = assembler
        self._data = data
        self.n = assembler.n
        self.refine_steps = int(refine_steps)
        self.mesh = mesh

        shard = None
        if mesh is not None:
            # multi-device mode: the n^2 factor is row-sharded over the
            # mesh axis (n^2/devices per device — past one device's
            # memory); factorization and substitutions use the
            # blocked panel forms so the factor never moves whole
            from jax.sharding import NamedSharding, PartitionSpec

            shard = NamedSharding(
                mesh, PartitionSpec(mesh_axis or mesh.axis_names[0], None)
            )

        def factor(data):
            # -(D A D) assembled straight into the (padded) factor
            # buffer — the elastic force Jacobian is negative definite
            # at stable states, so -As is SPD (NaN factor <=>
            # indefinite state).  See assemble_dense_scaled_neg for why
            # this replaces the dense symmetrize/scale chain (OOM at
            # n=41k).
            nAs, s = assembler.assemble_dense_scaled_neg(
                data, chol_pad_n(self.n)
            )
            if shard is not None:
                nAs = jax.lax.with_sharding_constraint(nAs, shard)
                L = blocked_cholesky(nAs)
                L = jax.lax.with_sharding_constraint(L, shard)
            else:
                L = chol_factor(nAs)
            return L, s

        from ..jit_util import jit_hoist_consts

        self._factor_jit = jit_hoist_consts(factor)
        self._L, self._s = self._factor_jit(data)

        tri = None if shard is None else blocked_chol_solve

        def solve(L, s, data, b):
            return chol_refine_solve(
                L, s, data, b, assembler.matvec, self.refine_steps,
                tri_solve=tri,
            )

        self._solve_jit = jit_hoist_consts(solve)

    def factor_ok(self) -> bool:
        """Host-side check that the factorization is usable."""
        tail = jax.jit(lambda L: jnp.isfinite(jnp.diagonal(L)).all())(
            self._L
        )
        return bool(tail)

    def solve(self, b):
        return self._solve_jit(self._L, self._s, self._data,
                               jnp.asarray(b).reshape(-1))

    def apply(self, x):
        return self.assembler.matvec(self._data, jnp.asarray(x).reshape(-1))

    def coeff_l2(self):
        return jnp.sqrt(jnp.sum(self._data * self._data))


class SparseCG:
    """Device-side preconditioned CG on the assembled CSR operator with
    a block-Jacobi preconditioner built once per step.  The matvec is
    gather + multiply + segment-add, all shardable."""

    def __init__(self, assembler, data, block: int = 3,
                 tol: float = 1e-13, max_iter: int = 2000,
                 l2_penalty: float = 0.0):
        self.assembler = assembler
        self._data = data
        self.n = assembler.n
        self.tol = tol
        self.max_iter = max_iter
        self.l2_penalty = float(l2_penalty)
        blocks = assembler.diag_blocks(data, block)
        self.block = block
        self._binv = jnp.linalg.inv(
            blocks
            + 1e-300 * jnp.eye(block, dtype=data.dtype)
        )

    def _precond(self, r):
        nb = self.n // self.block
        return jnp.einsum(
            "nij,nj->ni", self._binv, r.reshape(nb, self.block),
            precision=F32_PRECISION,
        ).reshape(-1)

    def _mv(self, x):
        y = self.assembler.matvec(self._data, x)
        if self.l2_penalty:
            # normal-equations operator A^T A + pen I
            yt = self.assembler.matvec_t(self._data, y)
            return yt + self.l2_penalty * x
        return y

    def _chunk_kernel(self, n_steps):
        """Jitted fixed-trip CG chunk: ``lax.fori_loop`` with converged
        iterations frozen, host-checked for convergence between chunks.
        The freeze guard is required because unguarded iterations past
        convergence turn alpha/beta into 0/0 and diverge.
        """
        if getattr(self, "_chunk_jit", None) is not None:
            return self._chunk_jit

        def chunk(data, binv, b, state):
            bnorm2 = jnp.vdot(b, b)

            def pre(v):
                nb = self.n // self.block
                return jnp.einsum(
                    "nij,nj->ni", binv, v.reshape(nb, self.block),
                    precision=F32_PRECISION,
                ).reshape(-1)

            def mv(v):
                y = self.assembler.matvec(data, v)
                if self.l2_penalty:
                    y = self.assembler.matvec_t(data, y) + (
                        self.l2_penalty * v
                    )
                return y

            def body(_, st):
                x, r, z, p, rz = st
                live = jnp.vdot(r, r) > (self.tol**2) * bnorm2
                Ap = mv(p)
                pAp = jnp.vdot(p, Ap)
                alpha = jnp.where(
                    live, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0
                )
                x = x + alpha * p
                r = r - alpha * Ap
                z = pre(r)
                rz2 = jnp.vdot(r, z)
                beta = jnp.where(
                    live, rz2 / jnp.where(rz != 0, rz, 1.0), 0.0
                )
                p = z + beta * p
                return x, r, z, p, rz2

            state = jax.lax.fori_loop(0, n_steps, body, state)
            return state, jnp.linalg.norm(state[1])

        from .. import jit_util

        self._chunk_jit = jit_util.jit_hoist_consts(chunk)
        return self._chunk_jit

    def solve(self, b, chunk: int = 64):
        """Host-driven chunked CG: fixed-trip jitted chunks with a
        scalar convergence check between them (the PARDISO-style
        ``solve`` entry; factorization state = the block-Jacobi
        preconditioner built in the constructor)."""
        b = jnp.asarray(b).reshape(-1)
        if self.l2_penalty:
            b = self.assembler.matvec_t(self._data, b)
        bnorm = float(jnp.linalg.norm(b))
        if bnorm == 0.0:
            return jnp.zeros_like(b)
        kern = self._chunk_kernel(chunk)
        z0 = self._precond(b)
        state = (jnp.zeros_like(b), b, z0, z0, jnp.vdot(b, z0))
        done = 0
        while done < self.max_iter:
            state, rnorm = kern(self._data, self._binv, b, state)
            done += chunk
            if float(rnorm) <= self.tol * bnorm:
                break
        return state[0]

    def apply(self, x):
        return self.assembler.matvec(self._data, x.reshape(-1))

    def coeff_l2(self):
        return jnp.sqrt(jnp.sum(self._data * self._data))


def make_solver(A, l2_penalty: float = 0.0, mode: str = "dense"):
    if mode == "dense":
        return DenseFactorSolver(A, l2_penalty)
    raise SANMError(f"unknown solver mode {mode}")
