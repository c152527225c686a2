"""Linear-solver unit tests — port of ``Tensor.SparseSolver``
(tests/tensor.cpp:44): factorize-once/solve-many on a random banded
system, including the Tikhonov (A^T A + lambda I) mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from sanm_tpu.solver.linear import DenseFactorSolver, HostLUSolver, SparseCG
from sanm_tpu.solver.remap import LinearRemap, SparseAssembler
from helper import require_tensor_eq


def banded_system(n=120, bw=5, seed=3):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(-bw, bw + 1):
        v = rng.normal(size=n - abs(d))
        A += np.diag(v, d)
    A += np.eye(n) * (2 * bw + 3)
    return A


@pytest.mark.parametrize("mixed", [False, True])
def test_dense_factor_solver(mixed):
    A = banded_system()
    rng = np.random.default_rng(0)
    s = DenseFactorSolver(jnp.asarray(A), mixed_precision=mixed)
    for i in range(4):
        b = rng.normal(size=A.shape[0]) * 10.0 ** (-6 * i)  # wide scales
        x = np.asarray(s.solve(jnp.asarray(b)))
        resid = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert resid < 1e-12, f"rhs {i}: resid {resid}"


def test_dense_factor_tikhonov():
    # min |Ax-b|^2 + lam |x|^2  => (A^T A + lam I) x = A^T b
    A = banded_system(80)
    lam = 1e-3
    rng = np.random.default_rng(1)
    b = rng.normal(size=80)
    s = DenseFactorSolver(jnp.asarray(A), l2_penalty=lam)
    x = np.asarray(s.solve(jnp.asarray(b)))
    want = np.linalg.solve(A.T @ A + lam * np.eye(80), A.T @ b)
    require_tensor_eq(x, want, 1e-9, msg="tikhonov")


def _assembler_for(A):
    """Wrap a dense matrix as a SparseAssembler-compatible object."""
    n = A.shape[0]
    rows_in = [[(i, 1.0)] for i in range(n)]
    rin = LinearRemap(rows_in, n, (n, 1, 1))

    class _FakeAsm:
        pass

    # Build via the real machinery: treat A as B=n blocks of 1x1 with a
    # remap-out whose row i sums A[i, j] x_j ... simpler: build directly
    # from COO.
    coo = np.nonzero(A)
    asm = SparseAssembler.__new__(SparseAssembler)
    asm.n = n
    asm.n_rows = n
    asm.csr_rowidx = coo[0].astype(np.int32)
    asm.csr_cols = coo[1].astype(np.int32)
    asm.nnz = len(coo[0])
    asm._diag_map = None
    data = jnp.asarray(A[coo])
    return asm, data


def test_host_lu_solver():
    A = banded_system(150)
    asm, data = _assembler_for(A)
    import jax

    rng = np.random.default_rng(2)
    bs = rng.normal(size=(3, 150))

    @jax.jit
    def run(data, bs):
        s = HostLUSolver(asm, data)
        return jnp.stack([s.solve(b) for b in bs])

    xs = np.asarray(run(data, jnp.asarray(bs)))
    for b, x in zip(bs, xs):
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-12


def test_host_lu_registry_bounded():
    """The host-LU registry must not grow with restarts: the ANM driver
    factorizes once per continuation restart on the SAME assembler, and
    each factorization must overwrite (not leak) the previous LU + CSR
    copy.  1000 restarts -> exactly one live registry slot per
    assembler, and the slot dies with the assembler."""
    import gc

    A = banded_system(60)
    asm, data = _assembler_for(A)
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.normal(size=60))
    base = len(HostLUSolver._registry)
    for _ in range(1000):
        s = HostLUSolver(asm, data)
        x = np.asarray(s.solve(b))
    assert np.linalg.norm(A @ x - np.asarray(b)) < 1e-10
    assert len(HostLUSolver._registry) == base + 1
    key = asm._hostlu_key
    del asm, s
    gc.collect()
    assert key not in HostLUSolver._registry


def test_sparse_cg():
    A = banded_system(150)
    A = A @ A.T + 10 * np.eye(150)  # SPD for CG
    asm, data = _assembler_for(A)
    import jax

    rng = np.random.default_rng(4)
    b = rng.normal(size=150)

    # host-driven chunked solve (fixed-trip jitted chunks)
    s = SparseCG(asm, jnp.asarray(data), block=3)
    x = np.asarray(s.solve(jnp.asarray(b)))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def test_blocked_cholesky():
    """blocked_cholesky (the single-buffer large-n path of chol_factor)
    must match jnp.linalg.cholesky on SPD inputs, including n not
    divisible by the panel size, and must propagate NaN for indefinite
    inputs (the driver's indefinite-state detection relies on it)."""
    from sanm_tpu.solver.linear import blocked_cholesky

    rng = np.random.default_rng(7)
    for n, bs in [(256, 64), (300, 64), (97, 32)]:
        B = rng.normal(size=(n, n))
        A = B @ B.T + n * np.eye(n)
        L = np.tril(np.asarray(blocked_cholesky(
            jnp.asarray(A, jnp.float32), block=bs
        )))
        rec = np.abs(L @ L.T - A).max() / np.abs(A).max()
        assert rec < 5e-6, (n, bs, rec)
    # indefinite input -> NaN diagonal
    Aind = -np.eye(64)
    Lind = np.asarray(blocked_cholesky(jnp.asarray(Aind, jnp.float32),
                                       block=32))
    assert not np.isfinite(np.diagonal(Lind)).all()


def test_chol_refine_with_blocked_factor():
    """End-to-end: equilibrated blocked f32 factor + f64 refinement
    recovers a 1e-12 solve on a banded SPD system (what the dense_chol
    driver path does at n above the plain-cholesky memory cap)."""
    from sanm_tpu.solver.linear import blocked_cholesky, chol_refine_solve

    n = 200
    A = banded_system(n)
    A = -(A @ A.T + 10 * np.eye(n))  # negative definite, like -K
    asm, data = _assembler_for(A)
    d = np.abs(np.diagonal(A))
    s = 1.0 / np.sqrt(d)
    As = A * s[:, None] * s[None, :]
    L = blocked_cholesky(jnp.asarray(-As, jnp.float32), block=64)
    rng = np.random.default_rng(9)
    b = rng.normal(size=n)
    x = np.asarray(chol_refine_solve(
        L, jnp.asarray(s), data, jnp.asarray(b), asm.matvec, 8
    ))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-11


def test_blocked_tri_solve():
    """Blocked forward/backward substitution vs the dense solve, incl.
    a size that needs padding."""
    from sanm_tpu.solver.linear import blocked_cholesky, blocked_chol_solve

    rng = np.random.default_rng(7)
    for n, block in ((256, 64), (200, 64)):
        M = rng.standard_normal((n, n))
        A = M @ M.T + n * np.eye(n)
        L = blocked_cholesky(jnp.asarray(A), block=block)
        b = rng.standard_normal(n)
        x = np.asarray(blocked_chol_solve(L, jnp.asarray(b), block=block))
        resid = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert resid < 1e-11, (n, block, resid)


def test_blocked_chol_sharded_mesh():
    """Multi-device direct solve: factorization AND substitutions run
    with the factor row-sharded over the 8-device mesh — per-device
    factor memory is n^2/8, extending the single-device memory ceiling
    of ``DeviceCholSolver`` (the blocked
    forms keep the factor sharded and move one (n, block) panel per
    step, where a plain ``solve_triangular`` on a sharded L makes
    GSPMD all-gather the whole factor per solve).  Sharded result must
    match the unsharded one."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from sanm_tpu.solver.linear import blocked_cholesky, blocked_chol_solve

    n, block = 512, 64
    rng = np.random.default_rng(9)
    M = rng.standard_normal((n, n))
    A = jnp.asarray(M @ M.T + n * np.eye(n))
    b = jnp.asarray(rng.standard_normal(n))

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("d",))
    shard = NamedSharding(mesh, P("d", None))
    rep = NamedSharding(mesh, P())

    fac = jax.jit(
        lambda a: blocked_cholesky(a, block),
        in_shardings=shard, out_shardings=shard,
    )
    sol = jax.jit(
        lambda l, r: blocked_chol_solve(l, r, block),
        in_shardings=(shard, rep), out_shardings=rep,
    )
    L_sh = fac(jax.device_put(A, shard))
    assert L_sh.sharding.spec == P("d", None)
    x_sh = np.asarray(sol(L_sh, b))

    L = blocked_cholesky(A, block)
    x = np.asarray(blocked_chol_solve(L, b, block))
    np.testing.assert_allclose(x_sh, x, rtol=1e-10, atol=1e-12)
    resid = np.linalg.norm(np.asarray(A) @ x_sh - np.asarray(b))
    assert resid / np.linalg.norm(np.asarray(b)) < 1e-11
