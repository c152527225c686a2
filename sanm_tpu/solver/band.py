"""Device-resident skyline/banded Cholesky: the sparse direct factor.

Reference counterpart: the MKL-PARDISO sparse LDL^T
(``libsanm/sparse_solver.cpp:327-421`` — analyze once, factorize once
per continuation step, backsolve once per Taylor order).  PARDISO's
supernodal elimination is a CPU design: pointer-chased fronts, tiny
irregular dense blocks, threads.  The device equivalent built here
keeps the *analyze-once* structure but maps the numeric work onto
dense matmuls with static shapes:

* **Symbolic phase (host, once per topology)**: the stiffness sparsity
  is topology-static, so a reverse-Cuthill-McKee ordering of the DOF
  graph is computed once.  On the reference meshes RCM leaves a small
  band (measured: armadillo-small n=40995 -> semi-bandwidth 6104,
  human n=76977 -> 5228, bob n=23097 -> 3350).  The *profile* within
  that band is far from uniform — per-block-column reach on armadillo
  at s=2048 spans 1..3 blocks, and the exact skyline FLOPs
  (sum of squared row widths) are 8.6x below the uniform-band n*b^2 —
  so the plan partitions the block columns into a few contiguous
  *runs* of equal block width w_r (greedy-merged to bound program
  count) and every run factors/solves at its own static width: the
  blocked SKYLINE factorization.  The phase emits static
  gather/scatter index maps; nothing symbolic happens per restart.
* **Numeric phase (device, once per restart)**: one ``lax.scan`` per
  run over its block columns; each step is one s x s Cholesky, one
  s x s *triangular inversion*, one batched panel multiply, and one
  (s, w_r*s) x (w_r*s, w_r*s) matmul trailing update — all static
  shapes, no data-dependent control flow.
* **Backsolve (device, once per Taylor order)**: blocked forward /
  backward substitution, one column panel per step.  The diagonal
  blocks are stored INVERTED (computed once at factor time), so the
  substitutions are pure matmuls — no per-step ``solve_triangular``
  inside the sequential substitution passes.  The whole factor streams
  through device memory once per substitution pass.

Storage layouts:

* **Working band (factorization carry)**: block-row windows over the
  LOWER band only, at the UNIFORM global width ``W=(w+1)s``
  (transient; freed at factor return).  ``Bb[(i*s + r), c]`` holds
  ``A[i*s + r, (i - w)*s + c]`` for block-row ``i``.  The trailing
  update of block column ``j`` lands at *contiguous* window columns
  of each affected block row.  Scatter positions depend only on the
  global ``w``, so the assembly map is width-independent.
* **Factor output (persistent, read by every backsolve)**: per-run
  block-column panel stacks ``L[r] (len_r, (w_r+1)s, s)`` — panel
  ``j`` stacks ``inv(L[j,j])`` (rows 0:s) over the ``w_r``
  subdiagonal blocks ``L[j+1+m, j]``.  Each run keeps ONE static
  layout, sliced only along the leading axis (a layout that needs a
  transpose makes XLA materialize a transposed factor copy per
  solve).  Skyline
  panels also shrink the factor memory to the profile's true size
  (~2x at armadillo scale).

Precision mirrors :class:`~sanm_tpu.solver.linear.DeviceCholSolver`:
f32 factorization with every dot at ``F32_PRECISION`` (full f32
products, never the backend's TF32 default) + f64 iterative refinement
through the exact sparse operator (``chol_refine_solve``), on the
Jacobi-equilibrated,
sign-flipped system (elastic stiffness is negative definite at stable
states).  An indefinite state propagates NaN through the factor;
callers detect it (``band_factor_ok``) and fall back to host LU
exactly like the dense path.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax import lax

from ..utils import sanm_assert
from .linear import F32_PRECISION


class BandPlan:
    """Host-side symbolic analysis: RCM ordering + skyline run layout +
    the static assembly scatter map.  Built once per topology (the ANM
    analog of PARDISO phase 11 'analyze', which the reference likewise
    runs once and reuses, ``sparse_solver.cpp:340-352``)."""

    # greedy run-merge bound: one compiled scan body per run in both
    # the factor and each substitution pass, so cap the program count
    MAX_RUNS = 6

    def __init__(self, csr_rowidx, csr_cols, n: int):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        r = np.asarray(csr_rowidx, np.int64)
        c = np.asarray(csr_cols, np.int64)
        self.n = int(n)
        pat = sp.csr_matrix(
            (np.ones(r.size, np.float32), (r, c)), shape=(n, n)
        )
        perm = np.asarray(
            reverse_cuthill_mckee(pat, symmetric_mode=True), np.int64
        )
        invp = np.empty(n, np.int64)
        invp[perm] = np.arange(n)
        rp, cp = invp[r], invp[c]
        bw = int(np.abs(rp - cp).max()) if r.size else 1

        # block size: smallest power of two (>=256) with <=3 panel
        # blocks in the max band — bigger panels mean fewer sequential
        # steps and larger matmuls at slightly more junk FLOPs.
        # SANM_BAND_S overrides for A/B (skyline width resolution vs
        # step count).
        s = int(os.environ.get("SANM_BAND_S", "0"))
        if s <= 0:
            s = 256
            while s < 4096 and (bw + 1) / s > 3:
                s *= 2
        w = max(1, -(-bw // s))
        self.s, self.w = s, w
        self.bw = bw
        nb = -(-n // s)
        self.nb = nb
        self.nrow_tot = (nb + w) * s
        self.W = (w + 1) * s

        # ---- skyline runs: per-block-column reach ---------------------
        # Profile Cholesky fill stays within each row's profile
        # [first_i, i], so block-row i touches block column j iff
        # fblk[i] <= j; the reach of column j is the farthest such row.
        first = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(first, rp, cp)
        fblk_dof = first // s
        blk_of = np.arange(n) // s
        fblk = np.full(nb, nb, np.int64)
        np.minimum.at(fblk, blk_of, fblk_dof)
        w_need = np.zeros(nb, np.int64)
        for i in range(nb):
            lo = int(fblk[i])
            if lo < i:
                j = np.arange(lo, i)
                np.maximum.at(w_need, j, i - j)
        sanm_assert(int(w_need.max(initial=0)) <= w,
                    "skyline reach exceeds global band width")
        self.blk_w = w_need
        self.runs = self._merge_runs(w_need, self.MAX_RUNS)

        # assembly scatter: LOWER-triangle nnz entry e -> flat band
        # position (uniform-W working band; width-independent).
        low = np.nonzero(rp >= cp)[0]
        self.band_sel = low.astype(
            np.int32 if r.size < 2**31 else np.int64
        )
        flat = rp[low] * self.W + (cp[low] - (rp[low] // s) * s + w * s)
        top = self.nrow_tot * self.W
        self.band_idx = (
            flat.astype(np.int32) if top < 2**31 else flat
        )
        # unit-diagonal pad positions (dofs n .. nrow_tot)
        d = np.arange(n, self.nrow_tot, dtype=np.int64)
        padflat = d * self.W + (d % s + w * s)
        self.pad_idx = (
            padflat.astype(np.int32) if top < 2**31 else padflat
        )
        # permutation extended over the pad region (identity there),
        # for solves on chol_refine_solve's zero-extended RHS
        self.perm_ext = np.concatenate(
            [perm, np.arange(n, self.nrow_tot, dtype=np.int64)]
        ).astype(np.int32 if self.nrow_tot < 2**31 else np.int64)
        self.invp_ext = np.concatenate(
            [invp, np.arange(n, self.nrow_tot, dtype=np.int64)]
        ).astype(self.perm_ext.dtype)

    @staticmethod
    def _merge_runs(w_need, max_runs):
        """Contiguous equal-width runs, greedily merged (cheapest FLOPs
        increase first) until at most ``max_runs`` remain.  Returns
        ``[(j0, length, w_run), ...]`` covering ``0..nb-1``."""
        runs = []
        for j, wv in enumerate(w_need.tolist()):
            if runs and runs[-1][2] == wv:
                runs[-1][1] += 1
            else:
                runs.append([j, 1, wv])

        def cost(ln, wv):
            # per-column factor FLOPs in s^3 units: chol 1/3 + inv 1/2
            # + panel mult w + trailing update w^2
            return ln * (wv * wv + wv + 0.83)

        while len(runs) > max_runs:
            best, besti = None, None
            for i in range(len(runs) - 1):
                a, b = runs[i], runs[i + 1]
                wv = max(a[2], b[2])
                inc = (
                    cost(a[1] + b[1], wv)
                    - cost(a[1], a[2])
                    - cost(b[1], b[2])
                )
                if best is None or inc < best:
                    best, besti = inc, i
            a, b = runs[besti], runs[besti + 1]
            runs[besti] = [a[0], a[1] + b[1], max(a[2], b[2])]
            del runs[besti + 1]
        return [tuple(r) for r in runs]

    def mem_bytes(self) -> int:
        """Persistent factor bytes (skyline column panels, f32)."""
        return sum(
            4 * ln * (wr + 1) * self.s * self.s
            for _, ln, wr in self.runs
        )

    def work_mem_bytes(self) -> int:
        """Transient working-band bytes during factorization (f32)."""
        return 4 * self.nrow_tot * self.W

    def factor_flops(self) -> float:
        """Factorization FLOPs estimate (skyline runs)."""
        s3 = float(self.s) ** 3
        return sum(
            ln * (wr * wr + wr + 0.83) * s3 for _, ln, wr in self.runs
        )


def assemble_band_scaled_neg(plan: BandPlan, asm, data):
    """``-(D A D)`` scattered straight into band storage (f32), with
    ``D = diag(s)`` the Jacobi equilibration — the banded counterpart
    of ``SparseAssembler.assemble_dense_scaled_neg`` (same sign/scale
    conventions, documented there).  Returns ``(Bb, s)``."""
    pos, prow = asm._diag_nnz_pos()
    n = plan.n
    d = jnp.zeros((n,), data.dtype).at[jnp.asarray(prow)].set(
        data[jnp.asarray(pos)]
    )
    d = jnp.abs(d)
    s = lax.rsqrt(jnp.where(d > 0, d, 1.0))
    sel = jnp.asarray(plan.band_sel)
    rows = jnp.asarray(asm.csr_rowidx)[sel]
    cols = jnp.asarray(asm.csr_cols)[sel]
    vals = (-(data[sel] * s[rows] * s[cols])).astype(jnp.float32)
    flat = jnp.zeros((plan.nrow_tot * plan.W,), jnp.float32)
    flat = flat.at[jnp.asarray(plan.band_idx)].set(vals)
    flat = flat.at[jnp.asarray(plan.pad_idx)].set(1.0)
    return flat.reshape(plan.nrow_tot, plan.W), s


def band_cholesky(plan: BandPlan, Bb):
    """Right-looking blocked skyline Cholesky of the band-stored SPD
    matrix: one ``lax.scan`` per width run, one step per block column.
    Each step factors the s x s diagonal block, INVERTS the triangular
    factor (so every later substitution is a pure matmul), forms the
    w_r subdiagonal panels by multiplication, and subtracts the
    (w_r*s) x (w_r*s) outer product from the trailing windows.  NaNs
    from an indefinite input propagate to the factor.

    Returns the factor as a tuple of per-run column-panel stacks
    ``L[r] (len_r, (w_r+1)s, s)`` with ``inv(L[j,j])`` in rows 0:s
    (see module docstring); the working band ``Bb`` is the scan carry
    the compiler updates in place and frees at return."""
    s_blk, w = plan.s, plan.w
    eye = jnp.eye(s_blk, dtype=Bb.dtype)
    outs = []
    for j0, ln, wr in plan.runs:
        def step(Bb, j, wr=wr):
            c0 = j * s_blk
            D = lax.dynamic_slice(
                Bb, (c0, w * s_blk), (s_blk, s_blk)
            )
            # no symmetrize: the window stores only the lower triangle,
            # the upper half of D is unscattered junk
            Ljj = lax.linalg.cholesky(D, symmetrize_input=False)
            inv = jsl.solve_triangular(Ljj, eye, lower=True)
            if wr == 0:
                return Bb, inv
            # subdiagonal panels: block (j+1+m, j) sits in block-row
            # j+1+m at window offset (w-1-m)*s
            P = jnp.stack([
                lax.dynamic_slice(
                    Bb, ((j + 1 + m) * s_blk, (w - 1 - m) * s_blk),
                    (s_blk, s_blk),
                )
                for m in range(wr)
            ])
            # T[m] = P[m] @ inv(Ljj)^T  (== solve(Ljj, P[m]^T)^T)
            T = jnp.einsum("mab,cb->mac", P, inv, precision=F32_PRECISION)
            # U[m] = T[m] @ [T_0 .. T_{wr-1}]^T as (s, wr*s); block
            # (j+1+m, j+1+p) sits at window offset (w-m+p)*s.  Only
            # p <= m blocks are in the lower band: a contiguous strip
            # of static width (m+1)s starting at (w-m)s.
            U = jnp.einsum(
                "mab,pcb->mapc", T, T, precision=F32_PRECISION
            ).reshape(wr, s_blk, wr * s_blk)
            for m in range(wr):
                r0 = (j + 1 + m) * s_blk
                coff = (w - m) * s_blk
                width = (m + 1) * s_blk
                seg = lax.dynamic_slice(Bb, (r0, coff), (s_blk, width))
                Bb = lax.dynamic_update_slice(
                    Bb, seg - U[m, :, :width], (r0, coff)
                )
            panel = jnp.concatenate(
                [inv, T.reshape(wr * s_blk, s_blk)], axis=0
            )
            return Bb, panel

        Bb, panels = lax.scan(step, Bb, jnp.arange(j0, j0 + ln))
        outs.append(panels)
    return tuple(outs)


def band_factor_ok(L):
    """All-finite check on the skyline factor (NaN from an indefinite
    diagonal block propagates through the inversion and the trailing
    updates)."""
    ok = jnp.bool_(True)
    for p in L:
        ok = jnp.logical_and(ok, jnp.isfinite(p).all())
    return ok


def band_tri_solve(plan: BandPlan, L, rhs):
    """``(L L^T)^{-1} rhs`` through the skyline column-panel factor:
    blocked forward then backward substitution, one panel per step,
    pure matmuls (inverted diagonal blocks).  ``rhs`` is the full
    padded vector (``nrow_tot``,) in PERMUTED ordering; pad entries
    solve to exact zeros (inverted unit diagonal, zero panels)."""
    s_blk = plan.s

    r = rhs
    for (j0, ln, wr), panels in zip(plan.runs, L):
        def fwd(r, xs, wr=wr):
            Pf, j = xs
            c0 = j * s_blk
            inv, Pm = Pf[:s_blk], Pf[s_blk:]
            rj = lax.dynamic_slice(r, (c0,), (s_blk,))
            yj = jnp.matmul(inv, rj, precision=F32_PRECISION)
            if wr:
                seg = lax.dynamic_slice(
                    r, (c0 + s_blk,), (wr * s_blk,)
                )
                r = lax.dynamic_update_slice(
                    r, seg - jnp.matmul(Pm, yj, precision=F32_PRECISION),
                    (c0 + s_blk,),
                )
            return lax.dynamic_update_slice(r, yj, (c0,)), None

        r = lax.scan(fwd, r, (panels, jnp.arange(j0, j0 + ln)))[0]

    y = r
    for (j0, ln, wr), panels in reversed(list(zip(plan.runs, L))):
        def bwd(y, xs, wr=wr):
            Pf, j = xs
            c0 = j * s_blk
            inv, Pm = Pf[:s_blk], Pf[s_blk:]
            yj = lax.dynamic_slice(y, (c0,), (s_blk,))
            if wr:
                xs_below = lax.dynamic_slice(
                    y, (c0 + s_blk,), (wr * s_blk,)
                )
                yj = yj - jnp.matmul(
                    xs_below, Pm, precision=F32_PRECISION
                )
            # inv(Ljj)^T @ yj
            xj = jnp.matmul(yj, inv, precision=F32_PRECISION)
            return lax.dynamic_update_slice(y, xj, (c0,)), None

        y = lax.scan(
            bwd, y, (panels, jnp.arange(j0, j0 + ln)), reverse=True
        )[0]
    return y


def band_tri_solve_fn(plan: BandPlan):
    """The ``tri_solve(L, rf)`` hook for
    :func:`~sanm_tpu.solver.linear.chol_refine_solve`: gathers the
    zero-extended RHS into RCM ordering, runs the skyline
    substitutions, and scatters back — the permutation lives entirely
    inside the factor's backsub, invisible to the refinement loop
    (whose residual matvec runs in original ordering)."""

    def tri(Lc, rf):
        pad = plan.nrow_tot - rf.shape[0]
        if pad:  # zero-extend to the padded length (exact-zero solves)
            rf = jnp.concatenate([rf, jnp.zeros((pad,), rf.dtype)])
        rfp = rf[jnp.asarray(plan.perm_ext)]
        yp = band_tri_solve(plan, Lc, rfp)
        return yp[jnp.asarray(plan.invp_ext)]

    return tri


class DeviceBandCholSolver:
    """Factorize-once / backsolve-N-times on the device, sparse-direct
    edition: drop-in sibling of
    :class:`~sanm_tpu.solver.linear.DeviceCholSolver` with the dense
    n^2 factor replaced by the RCM skyline factor.  Same external
    contract: ``factor_ok()`` flags an indefinite state (driver falls
    back to host LU), ``solve`` runs f32 backsub + f64 refinement."""

    def __init__(self, assembler, data, l2_penalty: float = 0.0,
                 refine_steps: int = 8):
        from .linear import chol_refine_solve
        from ..jit_util import jit_hoist_consts

        sanm_assert(l2_penalty == 0.0,
                    "band_chol: Tikhonov mode not supported")
        self.assembler = assembler
        self._data = data
        self.n = assembler.n
        self.refine_steps = int(refine_steps)
        self.plan = BandPlan(
            assembler.csr_rowidx, assembler.csr_cols, self.n
        )
        plan = self.plan
        tri = band_tri_solve_fn(plan)

        def factor(data):
            Bb, s = assemble_band_scaled_neg(plan, assembler, data)
            Lb = band_cholesky(plan, Bb)
            return Lb, s

        self._factor_jit = jit_hoist_consts(factor)
        self._L, self._s = self._factor_jit(data)

        def solve(L, s, data, b):
            return chol_refine_solve(
                L, s, data, b, assembler.matvec, self.refine_steps,
                tri_solve=tri,
            )

        self._solve_jit = jit_hoist_consts(solve)

    def factor_ok(self) -> bool:
        return bool(jax.jit(band_factor_ok)(self._L))

    def solve(self, b):
        return self._solve_jit(self._L, self._s, self._data,
                               jnp.asarray(b).reshape(-1))

    def apply(self, x):
        return self.assembler.matvec(self._data, jnp.asarray(x).reshape(-1))

    def coeff_l2(self):
        return jnp.sqrt(jnp.sum(self._data * self._data))
