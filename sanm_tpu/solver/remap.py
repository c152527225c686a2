"""Static sparse linear remaps between solver vectors and batched graph
tensors.

Counterpart of reference ``SparseLinearDesc`` /
``SparseLinearDescCompressed`` (``libsanm/anm.h:24-85``,
``libsanm/anm.cpp:19-88``): a biasless sparse linear map described row
by row.  On the device the map is stored as *padded* index/coefficient arrays
(mesh topology is static), so ``apply`` is a gather + small contraction
and the assembled system matrix is a scatter-add — both SPMD-shardable
along the batch axis.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils import SANMError, sanm_assert


class LinearRemap:
    """out[o] = sum_s coef[o, s] * x[idx[o, s]].

    Construction happens on the host in NumPy once per topology; the
    padded arrays then live on device.  ``rows``: a list (len = number of
    output scalars) of lists of ``(input_index, coefficient)`` pairs.
    """

    def __init__(self, rows, inp_size: int, out_shape: Tuple[int, ...]):
        n_out = int(math.prod(out_shape))
        sanm_assert(len(rows) == n_out, "rows=%d out=%d", len(rows), n_out)
        width = max((len(r) for r in rows), default=1) or 1
        idx = np.zeros((n_out, width), np.int32)
        coef = np.zeros((n_out, width), np.float64)
        for o, row in enumerate(rows):
            for s, (i, c) in enumerate(row):
                idx[o, s] = i
                coef[o, s] = c
        self.idx = jnp.asarray(idx)
        self.coef = jnp.asarray(coef)
        self._np_idx = idx
        self._np_coef = coef
        self.inp_size = int(inp_size)
        self.out_shape = tuple(out_shape)
        self.n_out = n_out
        self._transposed = None

    # ------------------------------------------------------------------
    @staticmethod
    def identity(n: int, out_shape: Optional[Tuple[int, ...]] = None):
        """Reference ``SparseLinearDesc::make_identity``
        (``libsanm/anm.cpp:19-48``)."""
        rows = [[(i, 1.0)] for i in range(n)]
        return LinearRemap(rows, n, out_shape or (n,))

    @classmethod
    def from_padded(cls, idx, coef, inp_size: int, out_shape):
        """Construct directly from padded arrays (native builders)."""
        self = cls.__new__(cls)
        idx = np.ascontiguousarray(idx, np.int32)
        coef = np.ascontiguousarray(coef, np.float64)
        self.idx = jnp.asarray(idx)
        self.coef = jnp.asarray(coef)
        self._np_idx = idx
        self._np_coef = coef
        self.inp_size = int(inp_size)
        self.out_shape = tuple(out_shape)
        self.n_out = idx.shape[0]
        self._transposed = None
        return self

    # ------------------------------------------------------------------
    def apply(self, x):
        """Apply to a flat (inp_size,) vector; returns out_shape array.
        None (structural zero) passes through."""
        if x is None:
            return None
        x = x.reshape(-1)
        out = jnp.sum(self.coef * x[self.idx], axis=1)
        return out.reshape(self.out_shape)

    def _np_csr(self):
        """Cached scipy CSR form for host-side applies: the padded
        gather form walks the full (n_out, width) table — 125 MB for
        the wide force-output remap at 42k tets — while the CSR matvec
        touches only the ~1.5M true nonzeros."""
        if getattr(self, "_np_csr_cache", None) is None:
            import scipy.sparse as _sp

            n_out, w = self._np_idx.shape
            rows = np.repeat(np.arange(n_out, dtype=np.int64), w)
            m = self._np_coef.ravel() != 0.0
            self._np_csr_cache = _sp.csr_matrix(
                (self._np_coef.ravel()[m],
                 (rows[m], self._np_idx.ravel()[m])),
                shape=(n_out, self.inp_size),
            )
        return self._np_csr_cache

    def apply_np(self, x):
        """NumPy (strict-IEEE f64) apply, for host-exact residual
        evaluation."""
        import numpy as _np

        x = _np.asarray(x).reshape(-1)
        return (self._np_csr() @ x).reshape(self.out_shape)

    def apply_t(self, y):
        """Transpose map: (out_shape,) -> (inp_size,), via scatter-add."""
        if y is None:
            return None
        yflat = y.reshape(-1)
        contrib = self.coef * yflat[:, None]
        return jnp.zeros((self.inp_size,), contrib.dtype).at[self.idx].add(
            contrib
        )

    # ------------------------------------------------------------------
    def transposed_padded(self):
        """Per-input-position padded list of (output_row, coef):
        numpy arrays (inp_size, T).  Built once on host; used for system
        assembly (the reference instead walks output rows inside
        ``build_sparse_coeff``, ``libsanm/anm.cpp:362-438``).  Kept as
        numpy so a jitted caller never caches trace-scoped constants."""
        if self._transposed is not None:
            return self._transposed
        from ..native import transpose_padded_native

        nat = transpose_padded_native(
            self._np_idx, self._np_coef, self.inp_size
        )
        if nat is not None:
            self._transposed = nat
            return nat
        buckets = [[] for _ in range(self.inp_size)]
        n_out, width = self._np_idx.shape
        for o in range(n_out):
            for s in range(width):
                c = self._np_coef[o, s]
                if c != 0.0:
                    buckets[self._np_idx[o, s]].append((o, c))
        T = max((len(b) for b in buckets), default=1) or 1
        ridx = np.zeros((self.inp_size, T), np.int32)
        rcoef = np.zeros((self.inp_size, T), np.float64)
        for i, b in enumerate(buckets):
            for t, (o, c) in enumerate(b):
                ridx[i, t] = o
                rcoef[i, t] = c
        self._transposed = (ridx, rcoef)
        return self._transposed


def _row_unique(vals, pad):
    """Per-row unique of a (B, W) int array where ``pad`` marks dead
    slots (pad must compare greater than every live value).

    Returns ``(uniq (B, D), loc (B, W), D)``: ``uniq`` padded with
    ``pad``; ``loc[b, w]`` is the local index of ``vals[b, w]`` within
    ``uniq[b]`` (arbitrary-but-valid for dead slots, whose coefficients
    are zero)."""
    B, W = vals.shape
    order = np.argsort(vals, axis=1, kind="stable")
    sv = np.take_along_axis(vals, order, axis=1)
    isnew = np.ones((B, W), bool)
    isnew[:, 1:] = sv[:, 1:] != sv[:, :-1]
    isnew &= sv != pad  # dead slots sort last
    loc_sorted = np.cumsum(isnew, axis=1) - 1
    D = max(int(loc_sorted.max(initial=-1)) + 1, 1)
    uniq = np.full((B, D), pad, vals.dtype)
    bidx = np.broadcast_to(np.arange(B)[:, None], (B, W))
    uniq[bidx[isnew], loc_sorted[isnew]] = sv[isnew]
    loc = np.empty((B, W), np.int64)
    np.put_along_axis(loc, order, np.maximum(loc_sorted, 0), axis=1)
    return uniq, loc, D


class SparseAssembler:
    """Static-topology sparse assembly of A = R_out blockdiag(J) R_in.

    Batched replacement for the reference's per-thread CSR builders
    (``SparseSolver::MatBuilder`` + ``build_sparse_coeff``,
    ``libsanm/sparse_solver.cpp:229-325``, ``libsanm/anm.cpp:362-438``),
    in classic FEM element-stiffness form: per element ``b`` the remaps
    touch only a handful of distinct global rows/columns (the element's
    vertex DOFs), so A decomposes as::

        E[b] = Lout[b] @ J[b] @ Lin[b]          (B, Dout, Din)
        A[loc_rows[b, i], loc_cols[b, j]] += E[b, i, j]

    where ``Lout[b] (Dout, odim)`` / ``Lin[b] (idim, Din)`` collapse the
    remaps' per-slot coefficients onto the element's distinct unknowns.
    Compared with enumerating every (out-slot x in-slot) contribution
    pair this shrinks the slot space by ~500x (tets: Dout=12, Din<=13)
    — the einsum is pure batched matmul work and the host-side CSR mapping
    is O(B * Dout * Din).

    For the implicit driver, contributions whose column equals
    ``n_unknown`` (the t column) are routed to a separate ``grad_t``
    vector (reference ``ANMImplicitSolver::build_sparse_coeff``,
    ``libsanm/anm.cpp:567-605``).
    """

    def __init__(self, remap_out: LinearRemap, remap_in: LinearRemap,
                 B: int, odim: int, idim: int, n_unknown: int):
        self.B, self.odim, self.idim = B, odim, idim
        self.n = int(n_unknown)
        self.n_rows = remap_out.n_out
        n = self.n

        # ---- columns: distinct unknowns read by each element ----------
        in_idx = remap_in._np_idx.reshape(B, -1).astype(np.int64)
        in_coef = remap_in._np_coef.reshape(B, -1)
        col_pad = n + 1  # real cols in [0, n]; n = the t column
        cvals = np.where(in_coef != 0, in_idx, col_pad)
        loc_cols, cloc, Din = _row_unique(cvals, col_pad)
        Lin = np.zeros((B, idim, Din))
        bI = np.broadcast_to(np.arange(B)[:, None], cvals.shape)
        qI = np.broadcast_to(
            np.repeat(np.arange(idim), in_idx.shape[1] // idim)[None, :],
            cvals.shape,
        )
        np.add.at(Lin, (bI, qI, cloc), in_coef)

        # ---- rows: distinct unknowns written by each element ----------
        outT_idx, outT_coef = remap_out.transposed_padded()
        oT = outT_idx.reshape(B, -1).astype(np.int64)
        oC = outT_coef.reshape(B, -1)
        row_pad = self.n_rows
        rvals = np.where(oC != 0, oT, row_pad)
        loc_rows, rloc, Dout = _row_unique(rvals, row_pad)
        Lout = np.zeros((B, Dout, odim))
        bO = np.broadcast_to(np.arange(B)[:, None], rvals.shape)
        pO = np.broadcast_to(
            np.repeat(np.arange(odim), oT.shape[1] // odim)[None, :],
            rvals.shape,
        )
        np.add.at(Lout, (bO, rloc, pO), oC)

        self.Dout, self.Din = Dout, Din
        self._Lout, self._Lin = Lout, Lin
        # element-condensed remap applications (see apply_in/apply_out)
        self._loc_rows = loc_rows.astype(np.int32)  # (B, Dout), pad=n_rows
        self._loc_cols = loc_cols.astype(np.int32)  # (B, Din), pad=n+1
        self._gin_shape = remap_in.out_shape
        self._apply_cache = {}

        # ---- CSR structure over the (B, Dout, Din) element slots -------
        rows = np.broadcast_to(
            loc_rows[:, :, None], (B, Dout, Din)
        ).reshape(-1)
        cols = np.broadcast_to(
            loc_cols[:, None, :], (B, Dout, Din)
        ).reshape(-1)
        dead = (rows == row_pad) | (cols == col_pad)
        is_t = ~dead & (cols == n)
        mat_slot = ~dead & ~is_t
        keys = np.where(mat_slot, rows * (n + 2) + cols, -1)
        uniq, inv = np.unique(keys, return_inverse=True)
        offset = 1 if len(uniq) and uniq[0] == -1 else 0
        self.nnz = len(uniq) - offset
        uk = uniq[offset:]
        self.csr_rowidx = (uk // (n + 2)).astype(np.int32)  # COO rows
        self.csr_cols = (uk % (n + 2)).astype(np.int32)
        # slot -> nnz position (dump slot nnz for dead/t).  Kept as NUMPY
        # so traces never cache tracer constants.
        self.slot_pos = np.where(
            mat_slot, inv - offset, self.nnz
        ).astype(np.int32)
        # t-column slots -> row index (grad_t accumulation)
        self.t_slot_row = np.where(is_t, rows, self.n_rows).astype(
            np.int32
        )
        self.has_t = bool(is_t.any())

        # block-diagonal 3x3 (or generic dim) lookup for preconditioning:
        # positions of (3v+i, 3v+j) entries
        self._diag_map = None

    # ------------------------------------------------------------------
    # element-condensed remap applications.  ``LinearRemap.apply`` on the
    # force-output remap is a (n_rows, T~350)-wide arbitrary gather (the
    # reference's remap is a cache-friendly host walk,
    # ``libsanm/anm.cpp:19-88``).  The condensed form runs the
    # per-element contraction as batched matmul work and touches only
    # (B, Dout) scatter / (B, Din) gather elements — ~28x fewer.  Whether
    # the plain gather form wins on a GPU is not measured yet.
    def _lio(self, dtype):
        # cache NUMPY casts only: jnp conversion must happen inside the
        # caller's trace (a cached in-trace constant would leak tracers)
        key = np.dtype(dtype).str
        if key not in self._apply_cache:
            self._apply_cache[key] = (
                self._Lin.astype(dtype),
                self._Lout.astype(dtype),
            )
        Lin, Lout = self._apply_cache[key]
        return (
            jnp.asarray(Lin),
            jnp.asarray(Lout),
            jnp.asarray(self._loc_cols),
            jnp.asarray(self._loc_rows),
        )

    def apply_in(self, xt, dtype=None):
        """remap_in applied to the full (n+1,) solver vector (the t entry
        included; ignored when the remap has no t column).  Returns the
        (B, idim)-shaped graph input, flattened per element."""
        dtype = dtype or xt.dtype
        Lin, _, loc_cols, _ = self._lio(dtype)
        xp = jnp.concatenate(
            [xt.astype(dtype), jnp.zeros((1,), dtype)]
        )  # index n+1 = dead padding
        g = xp[loc_cols]  # (B, Din) gather — small
        if dtype == jnp.float64:
            # broadcast-sum for the tiny f64 products (see
            # ops/svd_w.py _use_vpu)
            gin = jnp.sum(Lin * g[:, None, :], axis=-1)
        else:
            gin = jnp.einsum("bqd,bd->bq", Lin, g, precision="highest")
        return gin.reshape(self._gin_shape)

    def apply_out(self, b, dtype=None):
        """remap_out applied to the (B, odim) graph output; returns the
        assembled (n_rows,) vector."""
        dtype = dtype or b.dtype
        _, Lout, _, loc_rows = self._lio(dtype)
        bb = b.reshape(self.B, self.odim).astype(dtype)
        if dtype == jnp.float64:
            contrib = jnp.sum(Lout * bb[:, None, :], axis=-1)
        else:
            contrib = jnp.einsum(
                "bdp,bp->bd", Lout, bb, precision="highest",
            )
        out = jnp.zeros((self.n_rows + 1,), dtype).at[loc_rows].add(contrib)
        return out[: self.n_rows]

    def element_stiffness(self, jac):
        """Per-element condensed stiffness E[b] = Lout[b] J[b] Lin[b]."""
        return jnp.einsum(
            "bdp,bpq,bqe->bde",
            jnp.asarray(self._Lout),
            jac,
            jnp.asarray(self._Lin),
            precision="highest",
        )

    def assemble_csr(self, jac):
        """Returns (csr_values (nnz,), grad_t (n_rows,) or None)."""
        data, grad_t, _ = self.assemble_csr_elem(jac)
        return data, grad_t

    def assemble_csr_elem(self, jac):
        """Like :meth:`assemble_csr` but also returns the per-element
        condensed stiffness E (B, Dout, Din) — the input of
        :meth:`element_matvec`, which the device-resident refinement
        loop prefers over the COO matvec (6x less gather/scatter index
        traffic)."""
        E = self.element_stiffness(jac)
        vals = E.reshape(-1)
        data = jnp.zeros((self.nnz + 1,), vals.dtype).at[
            jnp.asarray(self.slot_pos)
        ].add(vals)[: self.nnz]
        grad_t = None
        if self.has_t:
            grad_t = jnp.zeros((self.n_rows + 1,), vals.dtype).at[
                jnp.asarray(self.t_slot_row)
            ].add(vals)[: self.n_rows]
        return data, grad_t, E

    def assemble_dense_from_csr(self, data):
        A = jnp.zeros((self.n_rows, self.n), data.dtype)
        return A.at[
            jnp.asarray(self.csr_rowidx), jnp.asarray(self.csr_cols)
        ].set(data)

    def _diag_nnz_pos(self):
        if getattr(self, "_diag_pos_cache", None) is None:
            sel = np.nonzero(self.csr_rowidx == self.csr_cols)[0]
            self._diag_pos_cache = (
                sel.astype(np.int32),
                self.csr_rowidx[sel].astype(np.int32),
            )
        return self._diag_pos_cache

    def assemble_dense_scaled_neg(self, data, npad=None):
        """``-(D A D)`` scattered directly into ONE (npad, npad) f32
        buffer with unit diagonal padding, where ``D = diag(s)`` is the
        Jacobi equilibration from A's diagonal.  Memory-lean
        counterpart of the dense chain assemble -> symmetrize -> scale
        -> negate used by the device Cholesky: that chain materialized
        2-3 full (n, n) f32 temporaries (~7 GB each at n=41k,
        armadillo).  Here every elementwise transform runs on
        the (nnz,) value vector.  The explicit ``0.5 (A + A^T)``
        symmetrization is dropped: the Cholesky consumers read only the
        lower triangle (XLA potrf semantics; ``blocked_cholesky`` masks
        the upper panels), which matches the symmetric average to f32
        assembly rounding — absorbed by the f64 refinement against the
        exact operator.  Returns ``(P, s)`` with ``s`` in ``data``'s
        dtype."""
        import jax

        n = self.n
        npad = n if npad is None else int(npad)
        pos, prow = self._diag_nnz_pos()
        d = jnp.zeros((n,), data.dtype).at[jnp.asarray(prow)].set(
            data[jnp.asarray(pos)]
        )
        d = jnp.abs(d)
        s = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
        rows = jnp.asarray(self.csr_rowidx)
        cols = jnp.asarray(self.csr_cols)
        vals = (-(data * s[rows] * s[cols])).astype(jnp.float32)
        P = jnp.zeros((npad, npad), jnp.float32).at[rows, cols].set(vals)
        if npad != n:
            pad_idx = jnp.arange(n, npad)
            P = P.at[pad_idx, pad_idx].set(1.0)
        return P, s

    def diag_blocks(self, data, block: int):
        """Extract the (n/block, block, block) block diagonal from CSR
        values (for block-Jacobi preconditioning).  Map built lazily."""
        if self._diag_map is None:
            nb = self.n // block
            r = self.csr_rowidx.astype(np.int64)
            c = self.csr_cols.astype(np.int64)
            sel = (r // block == c // block) & (r < self.n)
            dmap = np.full((nb, block, block), self.nnz, np.int32)
            dmap[r[sel] // block, r[sel] % block, c[sel] % block] = (
                np.nonzero(sel)[0].astype(np.int32)
            )
            self._diag_map = dmap
        padded = jnp.concatenate([data, jnp.zeros((1,), data.dtype)])
        return padded[jnp.asarray(self._diag_map)]

    def matvec(self, data, x):
        """A @ x via COO gather/scatter (gather + multiply + segment add)."""
        contrib = data * x[jnp.asarray(self.csr_cols)]
        return jnp.zeros((self.n_rows,), data.dtype).at[
            jnp.asarray(self.csr_rowidx)
        ].add(contrib)

    def matvec_t(self, data, y):
        """A^T @ y (used by the Tikhonov normal-equations operator)."""
        contrib = data * y[jnp.asarray(self.csr_rowidx)]
        return jnp.zeros((self.n,), data.dtype).at[
            jnp.asarray(self.csr_cols)
        ].add(contrib)

    def element_matvec(self, E, x):
        """A @ x from the per-element condensed stiffness ``E``
        (``element_stiffness`` output, (B, Dout, Din)) instead of the
        CSR values: gather (B, Din) + per-element contraction + scatter
        (B, Dout).  This form moves ~6x less index traffic than the
        nnz-wide COO ``matvec`` (nnz ~ 3.2M vs B*(Dout+Din) ~ 1M at
        42k tets) and keeps the arithmetic elementwise.  The t column and
        dead padding vanish via zero-extension of ``x``."""
        dtype = E.dtype
        xp = jnp.concatenate(
            [x.astype(dtype), jnp.zeros((2,), dtype)]
        )  # index n = t (zero for a pure A@x), n+1 = dead padding
        g = xp[jnp.asarray(self._loc_cols)]  # (B, Din)
        if dtype == jnp.float64:
            # broadcast-sum for the tiny f64 products (see
            # ops/svd_w.py _use_vpu)
            contrib = jnp.sum(E * g[:, None, :], axis=-1)
        else:
            contrib = jnp.einsum(
                "bde,be->bd", E, g, precision="highest"
            )
        out = jnp.zeros((self.n_rows + 1,), dtype).at[
            jnp.asarray(self._loc_rows)
        ].add(contrib)
        return out[: self.n_rows]


def assemble_dense(
    remap_out: LinearRemap,
    jac,  # (B, odim, idim)
    remap_in: LinearRemap,
    n_cols: int,
):
    """Assemble A[r, c] = sum_{b,p,q} Rout[r,(b,p)] J[b,p,q] Rin[(b,q),c]
    as a dense (n_out, n_cols) matrix.

    Batched replacement of the reference's sharded CSR assembly
    (``ANMSolverVecScale::build_sparse_coeff``, ``libsanm/anm.cpp:362-438``):
    per-element stiffness contributions are formed as one batched einsum
    and scatter-added into the matrix."""
    B, odim, idim = jac.shape
    sanm_assert(remap_out.inp_size == B * odim)
    sanm_assert(remap_in.n_out == B * idim)
    outT_idx_np, outT_coef_np = remap_out.transposed_padded()
    outT_idx = jnp.asarray(outT_idx_np).reshape(B, odim, -1)
    outT_coef = jnp.asarray(outT_coef_np).reshape(B, odim, -1)
    in_idx = remap_in.idx.reshape(B, idim, -1)
    in_coef = remap_in.coef.reshape(B, idim, -1)

    # contributions (B, odim, T, idim, S)
    vals = jnp.einsum(
        "bpt,bpq,bqs->bptqs", outT_coef, jac, in_coef, precision="highest"
    )
    rows = jnp.broadcast_to(outT_idx[:, :, :, None, None], vals.shape)
    cols = jnp.broadcast_to(in_idx[:, None, None, :, :], vals.shape)
    A = jnp.zeros((remap_out.n_out, n_cols), vals.dtype)
    return A.at[rows.reshape(-1), cols.reshape(-1)].add(vals.reshape(-1))
