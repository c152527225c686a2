"""ANM continuation drivers.

Counterpart of reference ``libsanm/anm.{h,cpp}``: numerical continuation
of ``H(x, t) = 0`` by order-N Taylor expansion of the solution curve
``(x(a), t(a))`` with the Cochelin-style arc-length normalization
``x_1 . x_1 + t_1^2 = 1`` and per-order orthogonality
``x_k . x_1 + t_k t_1 = 0`` (``libsanm/anm.cpp:193-312``).

Per continuation step the order-k coefficients satisfy::

    A x_k + gt t_k + b_k = 0,      A = d(remap_out . f . remap_in)/dx

with the *same* A for every k — so A is assembled and factorized once,
then back-substituted N times (the algorithmic core the reference gets
from PARDISO and we preserve with host sparse LU or device
factorizations, see :mod:`sanm_tpu.solver.linear`).

Device structure: the entire expansion (order-0 eval, Jacobian assembly,
factorization, the unrolled order loop of bias-pass / back-substitution
/ scalar recurrences / commit-pass) is ONE jitted XLA program per
(model, order).  The data-dependent continuation control flow (restarts,
Pade acceptance, convergence) stays in host Python, operating on the
(N+1, n+1) coefficient matrix pulled back once per step — mirroring the
reference split between ``solve_expansion_coeffs`` and its callers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import polynomial
from ..pade import PadeApproximation
from ..taylor import TaylorFn, batched_jacobian, materialize
from ..utils import (
    SANMError,
    SANMNumericalError,
    ScopedProfiler,
    sanm_assert,
    verbose_mode,
)
from .linear import DenseFactorSolver
from .remap import LinearRemap, assemble_dense


@dataclass
class HyperParam:
    """Reference ``ANMDriverHelper::HyperParam`` (``libsanm/anm.h:100-114``).

    ``solver``: linear-solver backend — "auto" picks the in-graph dense
    factorization for small systems and the host sparse LU for large
    ones; "cg" selects the device-resident block-Jacobi PCG."""

    use_pade: bool = False
    sanity_check: bool = True
    order: int = 8
    maxr: float = 1e-6
    solution_check_tol: float = 1e-4
    xcoeff_l2_penalty: float = 0.0
    solver: str = "auto"
    # max unknowns for the dense path in "auto" (see _solver_mode): on
    # the CPU backend the dense f64 QR already loses to host sparse LU
    # on the bar mesh (n=3258), so the cutoff sits well below it
    dense_limit: int = 2048
    # order-loop execution: "unroll" traces every order (transparent,
    # O(order) program size), "scan" compiles one lax.scan body
    # (compile time independent of order).  "auto" picks by order.
    loop: str = "auto"
    # precision of the order>=2 graph passes in hybrid mode.  "auto"
    # (= "f64") runs them in native f64 on every backend; "f32" runs
    # them in f32 with an f64 precision island around the SVD-W rules
    # (the error-correcting restarts absorb the bounded coefficient
    # noise — the Jacobian, the factorization, and all residual
    # evaluations stay f64).
    graph_dtype: str = "auto"
    # reuse the Jacobian factorization across continuation restarts when
    # the start point moved by less than this relative step (hybrid
    # mode).  The expansion then uses a slightly stale A — an inexact/
    # modified-Newton scheme whose extra error the error-correcting
    # restarts absorb — and skips the dominant per-restart costs (fresh
    # batched Jacobian + assembly + host factorization).  The reference
    # has no analog: PARDISO refactorization is cheap on its 32-thread
    # host.  0 (the default) disables reuse:
    # on the benchmark meshes restarts move 10-25% of |x|, so the knob
    # would silently change numerics without ever paying off — it is an
    # opt-in for workloads with small per-restart motion.
    fact_reuse_rel_step: float = 0.0


@dataclass
class EqnHyperParam(HyperParam):
    """Reference ``ANMEqnSolver::HyperParam`` (``libsanm/anm.h:244-248``)."""

    converge_rms: float = 1e-5


class _ANMDriverBase:
    """Shared continuation machinery (reference ``ANMDriverHelper``)."""

    is_implicit = False

    def __init__(
        self,
        fn: Callable,
        remap_inp: LinearRemap,
        remap_out: LinearRemap,
        n_unknown: int,
        hyper_param: Optional[HyperParam] = None,
        shard_elems: Optional[Callable] = None,
    ):
        self.hp = hyper_param or HyperParam()
        sanm_assert(self.hp.order >= 2, "order=%d", self.hp.order)
        self.remap_inp = remap_inp
        self.remap_out = remap_out
        self.n = int(n_unknown)
        self.max_a_bound = polynomial.stable_x_range(self.hp.order)
        self._shard = shard_elems or (lambda x: x)

        example_gin = jax.ShapeDtypeStruct(
            remap_inp.out_shape, jnp.float64
        )
        self.tfn = TaylorFn(fn, example_gin)

        self._iter = 0
        self.xt0 = None  # np (n+1,)
        self.xt_coeffs = None  # np (order+1, n+1)
        self._t_coeffs = None
        self._pade = None
        self._t_max = 0.0
        self._t_max_a = 0.0

        # hoisted jit: the remap tables (wide force-output gather is
        # ~170 MB at 42k tets) must be runtime args, not XLA constants
        from ..jit_util import jit_hoist_consts

        self._eval_fx_jit = jit_hoist_consts(self._eval_fx_impl)
        self._expand_jit = jit_hoist_consts(self._expansion_impl)

    # -- subclass interface ---------------------------------------------------
    def prepare_inp(self, xt):
        """Strip or keep the trailing t before remap_inp
        (reference ``prepare_inp``, ``libsanm/anm.h:173``)."""
        raise NotImplementedError

    def on_fx0_computed(self, fx) -> bool:
        raise NotImplementedError

    def _gt_payload(self):
        """Extra jit argument carrying dH/dt (VecScale: the vector v)."""
        return np.zeros((self.n,))

    # -- jitted kernels ---------------------------------------------------
    def _eval_fx_impl(self, xt0):
        gin = self._shard(self.remap_inp.apply(self.prepare_inp(xt0)))
        return self.remap_out.apply(self.tfn(gin)).reshape(-1)

    def _loop_mode(self):
        mode = self.hp.loop
        if mode == "auto":
            if self._solver_mode() in (
                "host_lu", "cg", "dense_chol", "band_chol"
            ):
                # hybrid: the device computes graph passes; the solves
                # run between the per-order jits (host sparse LU, a
                # separately-jitted device PCG) or inside the fused
                # device loop (dense_chol, band_chol)
                mode = "hybrid"
            else:
                mode = "scan" if self.hp.order >= 8 else "unroll"
        return mode

    # ------------------------------------------------------------------
    # hybrid mode: per-order jitted graph passes + host-side factorization
    # (structurally closest to the reference: PARDISO on the host,
    # libsanm/sparse_solver.cpp, while all batched element work stays on
    # the accelerator)
    # ------------------------------------------------------------------
    def _pass_dtype(self):
        """Dtype of the order>=2 graph passes (hybrid mode).  An explicit
        ``_dtype_override`` (set by the per-restart f64 retry) wins over
        both the env var and the hyperparam — otherwise a retry under
        ``SANM_GRAPH_DTYPE=f32`` would rebuild identical f32 kernels."""
        import os

        mode = (
            getattr(self, "_dtype_override", None)
            or os.environ.get("SANM_GRAPH_DTYPE")
            or self.hp.graph_dtype
        )
        if mode == "auto":
            mode = "f64"
        if mode not in ("f32", "f64"):
            raise SANMError(f"unknown graph_dtype {mode}")
        return jnp.float32 if mode == "f32" else jnp.float64

    def _pass_tfn(self, dtype):
        """TaylorFn used for the high-order passes (f32 retrace cached).

        The retrace keeps the ``sanm_svd_w`` precision island (the op,
        its upstream chain, and cancellation-prone add/sub consumers)
        at f64 inside the f32 pass — without it, the svd Taylor
        recurrences amplify f32 noise through their clip_div divisions
        and ARAP continuation stalls near-degenerate meshes at a ~1e-3
        force-RMS floor.  ``SANM_SVDW_F64=0`` disables the island (A/B
        knob)."""
        import os

        if dtype == jnp.float64:
            return self.tfn
        if getattr(self, "_tfn32", None) is None:
            from ..ops.svd_w import svd_w_p
            from ..taylor import cast_taylor_fn

            promote = (
                ()
                if os.environ.get("SANM_SVDW_F64") == "0"
                else (svd_w_p,)
            )
            self._tfn32 = cast_taylor_fn(
                self.tfn, dtype, promote_prims=promote
            )
        return self._tfn32

    def _two_level_split(self, tfn_pass):
        """Stage boundary for the two-level order loop, or None.

        The per-order convolutions read the full (cap+1)-slot history
        window regardless of k (taylor_scan masked-window design), so
        running orders <= N/2 on a half-capacity engine halves their
        cost for the first half of the expansion — ~25% of total conv
        work (linear in buffer length on the CPU backend: 2.60 ms at 11
        slots vs 5.63 ms at 21, B=8192).  The price is one extra
        compiled step program, so by default ("auto") it is enabled only
        for svd-bearing graphs, whose SVD-W convolutions are the heavy
        part of the per-order step.  ``SANM_TWO_LEVEL=1`` forces it on
        for every graph, ``0`` disables it."""
        import os

        env = os.environ.get("SANM_TWO_LEVEL", "auto")
        if env == "0":
            return None
        order = self.hp.order
        if order < 8:
            return None
        if env != "1":
            from ..ops.svd_w import svd_w_p

            if not any(
                eqn.primitive is svd_w_p
                for _, eqn, _ in tfn_pass.live_eqns
            ):
                return None
        return order // 2

    def _hybrid_fns(self):
        if getattr(self, "_hyb", None) is not None:
            return self._hyb
        from ..taylor_scan import ScanEngine

        order = self.hp.order
        pdt = self._pass_dtype()
        tfn_pass = self._pass_tfn(pdt)
        split = self._two_level_split(tfn_pass)
        mixed = tfn_pass is not self.tfn
        asm = self._assembler()
        # graph-input dtype: f64 when the input feeds an f64 precision
        # island (svd_w upstream), else the pass dtype — the island's
        # input series must be exact, so the remap gather runs at f64
        in_dt = tfn_pass.jaxpr.invars[0].aval.dtype

        def jac_asm(xt0):
            """f64 Jacobian + CSR assembly, compiled SEPARATELY from the
            engine-buffer initialization: in the combined program XLA's
            rematerialization stacked the pass-dtype history buffers
            into one extra (n_buf, N+1, B, 3, 3) copy, which multiplied
            the ARAP graph's peak memory at 42k tets."""
            gin0 = self._shard(self.remap_inp.apply(self.prepare_inp(xt0)))
            jacf = lambda g: self.tfn(g)
            J = batched_jacobian(jacf, gin0)
            data, gt_asm, E = asm.assemble_csr_elem(J)
            if gt_asm is None:
                gt_asm = jnp.zeros((self.n,), xt0.dtype)
            return data, gt_asm, E

        def step_for(cap):
            def step_fn(carry, aux, k, xt_k, caches):
                """Fused commit(k) + bias(k+1): one device dispatch per
                order.  The remaps run in their element-condensed
                matmul form (``SparseAssembler.apply_in/apply_out``)
                instead of the padded-gather ``LinearRemap.apply`` on
                the wide force-output remap."""
                seng = ScanEngine.from_aux(tfn_pass, order, aux, cap=cap)
                gin = asm.apply_in(xt_k, in_dt)
                carry = seng.push(carry, k, gin, caches)
                b_out, caches2 = seng.order_bias(carry, k + 1)
                if b_out is None:
                    oav = tfn_pass.jaxpr.outvars[0].aval
                    b_out = jnp.zeros(oav.shape, oav.dtype)
                return (
                    carry,
                    asm.apply_out(b_out).astype(jnp.float64),
                    caches2,
                )

            return step_fn

        step_fn = step_for(None)

        def promote(carry):
            from ..taylor_scan import promote_carry

            return promote_carry(carry, order)

        def prepare_light(xt0):
            """Order-0 restart WITHOUT Jacobian/assembly — used when the
            factorization of a previous restart is reused."""
            gin0 = self._shard(self.remap_inp.apply(self.prepare_inp(xt0)))
            eng_p = tfn_pass.engine()
            eng_p.start(gin0.astype(in_dt) if mixed else gin0)
            if eng_p.order_bias() is not None:
                raise SANMError("order-1 bias must be structurally zero")
            seng = ScanEngine(eng_p, order, cap=split)
            return seng.init_carry(), seng.pack_aux()

        # jit_hoist_consts (not jax.jit): these functions close over the
        # assembler's element-condensed remap matrices (~40 MB at 42k
        # tets), which would otherwise be baked into every executable
        # as XLA constants (see jit_util)
        from ..jit_util import jit_hoist_consts

        self._hyb_split = split
        self._hyb_raw = (jac_asm, prepare_light)
        self._hyb = (
            jit_hoist_consts(jac_asm),
            # two-level loop: half-capacity step for orders k <= split,
            # promote pads the carry at the boundary (see
            # _two_level_split / taylor_scan.promote_carry)
            None
            if split is None
            else jit_hoist_consts(
                step_for(split), donate_argnums=(0, 4)
            ),
            # promote is not donated: the padded output is strictly
            # larger than the input, so XLA could not reuse the buffer
            None if split is None else jit_hoist_consts(promote),
            # donate the carry (arg 0) and caches (arg 4): the history
            # buffers are ~(N+1) x batch x inner and would otherwise be
            # copied on every per-order dispatch
            jit_hoist_consts(step_fn, donate_argnums=(0, 4)),
            jit_hoist_consts(prepare_light),
        )
        return self._hyb

    # ------------------------------------------------------------------
    # dense_chol: fully device-resident order loop.  The reference's
    # factorize-once / N-backsolves (libsanm/sparse_solver.cpp:154-180)
    # runs ENTIRELY on the accelerator: dense f32 Cholesky + f64
    # refinement (solver/linear.py chol_refine_solve), with the solve,
    # the ANM scalar recurrence, the coefficient matrix, and the
    # commit+bias pass fused into one jitted dispatch per order — no
    # per-order device->host crossing (the host_lu path pays one RHS
    # pull + host backsolve per order).
    # ------------------------------------------------------------------
    def _devloop_fns(self, refine_steps: Optional[int] = None):
        if getattr(self, "_devfns", None) is not None:
            return self._devfns
        if refine_steps is None:
            # refinement depth of the fused device solve: each step is
            # two n^2 triangular passes + one element matvec, the
            # dominant per-order cost of dense_chol; SANM_REFINE_STEPS
            # caps the trips, and the solve exits early on-device at
            # SANM_REFINE_RTOL (see chol_refine_solve)
            import os

            refine_steps = int(os.environ.get("SANM_REFINE_STEPS", "8"))
        import os

        refine_rtol = float(os.environ.get("SANM_REFINE_RTOL", "1e-12"))
        from ..taylor_scan import ScanEngine
        from .linear import (
            blocked_chol_solve,
            blocked_cholesky,
            chol_factor,
            chol_refine_solve,
        )

        asm = self._assembler()
        order = self.hp.order
        pdt = self._pass_dtype()
        tfn_pass = self._pass_tfn(pdt)
        in_dt = tfn_pass.jaxpr.invars[0].aval.dtype
        n = self.n
        sanity = self.hp.sanity_check and not self.hp.xcoeff_l2_penalty

        # multi-device: when the driver runs element-sharded over a mesh
        # (ElemSharding), the dense factor is row-sharded over the same
        # devices and the substitutions use the blocked panel forms —
        # per-device factor memory n^2/devices instead of a replicated
        # n^2 (see solver/linear.py blocked_tri_solve_*)
        fact_sharding = None
        mesh = getattr(self._shard, "mesh", None)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            fact_sharding = NamedSharding(
                mesh, PartitionSpec(self._shard.axis_name, None)
            )
        tri_solve = None if fact_sharding is None else blocked_chol_solve

        if self._solver_mode() == "band_chol":
            # sparse-direct device path: RCM band factor (see
            # solver/band.py) — same (L, s, ok) contract, the
            # permutation hidden inside the tri_solve hook.  The factor
            # is replicated under a mesh (band rows shard poorly across
            # the w-block halo; at band memory n*(2w+1)s that is
            # affordable well past the dense path's ceiling).
            from .band import (
                BandPlan,
                assemble_band_scaled_neg,
                band_cholesky,
                band_factor_ok,
                band_tri_solve_fn,
            )

            plan = getattr(self, "_band_plan", None)
            if plan is None or plan.n != n:
                plan = BandPlan(asm.csr_rowidx, asm.csr_cols, n)
            self._band_plan = plan
            tri_solve = band_tri_solve_fn(plan)

            def factor(data):
                Bb, s = assemble_band_scaled_neg(plan, asm, data)
                L = band_cholesky(plan, Bb)
                return L, s, band_factor_ok(L)

        else:
            def factor(data):
                # -(D A D) assembled straight into the (padded) factor
                # buffer: the elastic force Jacobian is negative definite
                # at stable states (A = -K), so -As is SPD; a NaN diagonal
                # flags an indefinite state and the caller falls back to
                # host LU.  assemble_dense_scaled_neg documents why the
                # dense symmetrize/scale chain was replaced (OOM at n=41k).
                from .linear import chol_pad_n

                nAs, s = asm.assemble_dense_scaled_neg(data, chol_pad_n(n))
                if fact_sharding is not None:
                    nAs = jax.lax.with_sharding_constraint(
                        nAs, fact_sharding
                    )
                    L = jax.lax.with_sharding_constraint(
                        blocked_cholesky(nAs), fact_sharding
                    )
                else:
                    L = chol_factor(nAs)
                ok = jnp.isfinite(jnp.diagonal(L)).all()
                return L, s, ok

        def order1(L, s, E, grad_t, xt0):
            # the first backsolve doubles as the factor-quality
            # pre-gate: its f64-refined relative residual is ~rtol
            # through a healthy factor and stalls orders of magnitude
            # higher through a numerically bad one (measured: the f32
            # band factor on jet NHI violates the downstream
            # orthogonality checks at 1.8e-2) — scoring it here lets
            # the caller fall back to host LU for the cost of one
            # backsolve instead of a full failed expansion
            xgt, gate, _ = chol_refine_solve(
                L, s, E, grad_t, asm.element_matvec, refine_steps,
                tri_solve=tri_solve, rtol=refine_rtol, with_resid=True,
            )
            t1 = 1.0 / jnp.sqrt(jnp.vdot(xgt, xgt) + 1.0)
            x1 = -t1 * xgt
            denom = t1 - jnp.vdot(x1, xgt)
            xt1 = jnp.concatenate([x1, t1[None]])
            XT = jnp.zeros((order + 1, n + 1), jnp.float64)
            XT = XT.at[0].set(xt0).at[1].set(xt1)
            return xgt, x1, denom, xt1, XT, gate

        def solve_rec(L, s, E, b, xgt, x1, denom, grad_t, k, XT, diag):
            """Backsolve + ANM scalar recurrence at order k (device).
            The refinement/sanity matvecs run in element-condensed form
            (``element_matvec``): 6x less gather/scatter index traffic
            than the COO matvec."""
            xb = chol_refine_solve(
                L, s, E, b, asm.element_matvec, refine_steps,
                tri_solve=tri_solve, rtol=refine_rtol,
            )
            tk = jnp.vdot(xb, x1) / denom
            xk = -tk * xgt - xb
            xt_k = jnp.concatenate([xk, tk[None]])
            XT = XT.at[k].set(xt_k)
            if sanity:
                resid = asm.element_matvec(E, xk) + grad_t * tk + b
                scale = jnp.maximum(
                    jnp.linalg.norm(grad_t * tk + b), 1e-30
                )
                diag = diag.at[k].set(jnp.linalg.norm(resid) / scale)
            return xt_k, XT, diag

        def fused_for(cap):
            def fused(L, s, E, carry, aux, k, b, caches, xgt, x1, denom,
                      grad_t, XT, diag):
                """solve(k) + commit(k) + bias(k+1)."""
                xt_k, XT, diag = solve_rec(
                    L, s, E, b, xgt, x1, denom, grad_t, k, XT, diag
                )
                seng = ScanEngine.from_aux(tfn_pass, order, aux, cap=cap)
                gin = asm.apply_in(xt_k, in_dt)
                carry = seng.push(carry, k, gin, caches)
                b2, caches2 = seng.order_bias(carry, k + 1)
                if b2 is None:
                    oav = tfn_pass.jaxpr.outvars[0].aval
                    b2 = jnp.zeros(oav.shape, oav.dtype)
                b2 = asm.apply_out(b2).astype(jnp.float64)
                return carry, caches2, b2, XT, diag

            return fused

        def scan_seg_for(cap, ks):
            """Orders ``ks`` fused into ONE dispatch via lax.scan: no
            host-driven dispatch per order, so XLA pipelines the loop
            without host round trips (the reference's analog:
            backsolves are negligible next to graph passes,
            libsanm/sparse_solver.cpp:154-180)."""
            fused = fused_for(cap)

            def seg(L, s, E, carry, aux, b, caches, xgt, x1, denom,
                    grad_t, XT, diag):
                def body(st, k):
                    carry, caches, b, XT, diag = st
                    carry, caches, b, XT, diag = fused(
                        L, s, E, carry, aux, k, b, caches, xgt, x1,
                        denom, grad_t, XT, diag,
                    )
                    return (carry, caches, b, XT, diag), None

                st, _ = jax.lax.scan(
                    body, (carry, caches, b, XT, diag),
                    jnp.asarray(ks, jnp.int32),
                )
                return st

            return seg

        def last(L, s, E, b, xgt, x1, denom, grad_t, XT, diag):
            _, XT, diag = solve_rec(
                L, s, E, b, xgt, x1, denom, grad_t, order, XT, diag
            )
            return XT, diag

        from ..jit_util import jit_hoist_consts

        split = self._two_level_split(tfn_pass)
        seg_don = (3, 5, 6, 11, 12)  # carry, b, caches, XT, diag
        ks_small = tuple(range(2, (split or 1) + 1))
        ks_full = tuple(range((split or 1) + 1, order))
        self._devfns = (
            jit_hoist_consts(factor),
            jit_hoist_consts(order1),
            jit_hoist_consts(
                scan_seg_for(None, ks_full), donate_argnums=seg_don
            ),
            jit_hoist_consts(last, donate_argnums=(8, 9)),
            None
            if split is None or not ks_small
            else jit_hoist_consts(
                scan_seg_for(split, ks_small), donate_argnums=seg_don
            ),
        )
        return self._devfns

    def _fact_reusable(self, fact, xt0_np) -> bool:
        """Whether a cached factorization from a previous restart is
        close enough to the new start point to reuse (distance covers
        the FULL start point including the t entry: for
        ANMImplicitSolver the assembled A and grad_t depend on t)."""
        if fact is None or self.hp.fact_reuse_rel_step <= 0:
            return False
        ncmp = self.n + 1 if self.is_implicit else self.n
        return float(
            np.linalg.norm(xt0_np[:ncmp] - fact["x0"])
        ) <= self.hp.fact_reuse_rel_step * (
            float(np.linalg.norm(fact["x0"])) + 1e-30
        )

    def _maybe_prefetch_jac(self):
        """Dispatch the device Jacobian+CSR assembly for the CURRENT
        start point before the host-side exact residual evaluation.

        Both are per-restart fixed costs on independent resources (the
        Jacobian/assembly is pure device work, ``_eval_fx_np`` is pure
        host NumPy); dispatching the former first lets them overlap
        instead of running back to back.  The reference has no
        analog problem: its f(x0) is a fast threaded graph pass
        (``libsanm/symbolic.cpp:44-60``).  Skipped when a cached
        factorization could be reused (the dispatch would occupy the
        device queue for nothing)."""
        self._prefetched = None
        if self._loop_mode() != "hybrid":
            return
        xt0_np = self.xt0
        if self._solver_mode() in (
            "dense_chol", "band_chol"
        ) and self._fact_reusable(getattr(self, "_fact_dev", None), xt0_np):
            return
        if self._fact_reusable(getattr(self, "_fact", None), xt0_np):
            return
        jac_asm = self._hybrid_fns()[0]
        if self._solver_mode() not in ("dense_chol", "band_chol"):
            # start the prepare_light/step compile threads BEFORE the
            # inline jac_asm compile below so all first-restart compiles
            # overlap (see _cold_warm; the devloop paths have their own
            # program set and skip this)
            self._cold_warm(xt0_np)
        self._prefetched = (xt0_np.copy(), jac_asm(jnp.asarray(xt0_np)))

    def _take_prefetched_jac(self, xt0_np):
        """Return the prefetched (data, gt_asm, E) if it matches
        ``xt0_np``, else None.  One-shot: always cleared."""
        p = getattr(self, "_prefetched", None)
        self._prefetched = None
        if p is not None and np.array_equal(p[0], xt0_np):
            return p[1]
        return None

    def _expand_hybrid_devloop(self, xt0_np, v_np):
        """dense_chol expansion; returns None when the current state's
        stiffness is indefinite (caller falls back to host LU)."""
        hp = self.hp
        n = self.n
        jac_asm, step_small, promote, step_fn, prepare_light = (
            self._hybrid_fns()
        )
        split = self._hyb_split
        factor, order1, seg_full, last, seg_small = self._devloop_fns()
        xt0 = jnp.asarray(xt0_np)
        fact = getattr(self, "_fact_dev", None)
        reuse = self._fact_reusable(fact, xt0_np)
        self._last_fact_reused = reuse
        if reuse:
            with ScopedProfiler("build_sparse_coeff", block=True):
                carry, aux = prepare_light(xt0)
            L, s, E, grad_t = (
                fact["L"], fact["s"], fact["E"], fact["gt"]
            )
        else:
            pre = self._take_prefetched_jac(xt0_np)
            with ScopedProfiler("build_sparse_coeff", block=True):
                data, gt_asm, E = (
                    pre if pre is not None else jac_asm(xt0)
                )
                carry, aux = prepare_light(xt0)
            with ScopedProfiler("sparse_prep", block=True):
                L, s, ok = factor(data)
                if not bool(ok):
                    return None
            grad_t = (
                gt_asm if self.is_implicit else jnp.asarray(v_np)
            )
            ncmp = n + 1 if self.is_implicit else n
            self._fact_dev = {
                "x0": xt0_np[:ncmp].copy(),
                "L": L, "s": s, "E": E, "gt": grad_t,
            }
        with ScopedProfiler("sparse_solve", block=True):
            xgt, x1, denom, xt1, XT, gate = order1(
                L, s, E, grad_t, xt0
            )
        # factor-quality pre-gate: a numerically bad f32 factor
        # (seen: the band factor on jet NHI) stalls the
        # refined first backsolve far above refine_rtol; bail to host
        # LU now — one backsolve paid instead of a full expansion that
        # fails its checks.  Two strikes disable the device factor for
        # this solver instance (the failure is a property of the
        # mesh/regime, not transient), so warm re-solves stop paying
        # the factorization at all.
        import os

        gate_tol = float(os.environ.get("SANM_FACTOR_GATE", "1e-8"))
        if not bool(np.asarray(gate) <= gate_tol):
            self._factor_gate_fails = (
                getattr(self, "_factor_gate_fails", 0) + 1
            )
            # sticky for the rest of this solve (cleared by reset)
            self._solver_override = "host_lu"
            self._fact_dev = None
            if not reuse:
                # hand the already-computed Jacobian/assembly to the
                # host-LU path so it is not paid twice
                self._prefetched = (xt0_np.copy(), (data, gt_asm, E))
            if verbose_mode():
                print(
                    "%s factor pre-gate failed (resid %g > %g); "
                    "host-LU fallback"
                    % (self._solver_mode(), float(gate), gate_tol)
                )
            return None
        diag = jnp.zeros((hp.order + 1,), jnp.float64)
        with ScopedProfiler("order_step", block=True):
            step1 = step_fn if split is None else step_small
            carry, b_dev, caches = step1(carry, aux, 1, xt1, None)
        # orders 2..N-1 run in one (or two, with the two-level split)
        # scan dispatches — zero host involvement inside the loop
        with ScopedProfiler("order_step_dev", block=True):
            if seg_small is not None:
                carry, caches, b_dev, XT, diag = seg_small(
                    L, s, E, carry, aux, b_dev, caches, xgt, x1,
                    denom, grad_t, XT, diag,
                )
                carry = promote(carry)
            carry, caches, b_dev, XT, diag = seg_full(
                L, s, E, carry, aux, b_dev, caches, xgt, x1,
                denom, grad_t, XT, diag,
            )
        with ScopedProfiler("sparse_solve", block=True):
            XT, diag = last(
                L, s, E, b_dev, xgt, x1, denom, grad_t, XT, diag
            )
        coeffs = np.asarray(XT)
        sanity = hp.sanity_check and not hp.xcoeff_l2_penalty
        dg = np.asarray(diag)[2:] if sanity else np.zeros((0,))
        return coeffs, dg

    def _splu_factorize(self, A, pen):
        """Sparse LU returning a ``solve(b)`` closure.

        Ordering: SuperLU SymmetricMode with validated COLAMD fallback
        — see :func:`~sanm_tpu.solver.linear.host_splu` for the trade
        (a faster factorization when the threshold pivots hold, one
        extra backsolve to check that they did).  A PARDISO-style
        analyze-once reuse (cache ``argsort(perm_c)``, pre-permute,
        NATURAL ordering) gives identical LU fill and saves nothing:
        scipy's ordering phase is a negligible slice of ``splu``, so
        that half of the reference's analyze/factorize split
        (``libsanm/sparse_solver.cpp:327-421``) is intentionally
        absent."""
        import scipy.sparse as sp

        from .linear import host_splu

        if pen:
            G = (A.T @ A).tocsc() + pen * sp.identity(
                self.n, format="csc"
            )
            lu = host_splu(G)
            return lambda b: lu.solve(A.T @ b)
        return host_splu(A.tocsc()).solve

    def _cold_warm(self, xt0_np):
        """Overlap the first-restart XLA compiles in background threads.

        A cache-cold first restart pays four SERIAL XLA compiles —
        prepare_light, jac_asm, and two step_fn variants (the k=1
        caches=None variant and the k>=2 variant are structurally
        different programs).  All four are independent, so this
        launches, alongside the main thread's jac_asm + host
        factorization:

        * a thread running the REAL ``prepare_light(xt0)`` (its result
          is stashed and consumed by ``_expand_hybrid``, so its
          compile overlaps instead of following jac_asm's), and
        * a thread compiling every step-program variant against dummy
          zero inputs whose shapes come from ``jax.eval_shape`` on the
          raw prepare_light (donated dummies; results discarded).

        The reference has no analog cost at all (no JIT,
        ``fea/main.cpp:1104-1119``).  One-shot per solver instance —
        warm restarts hit the in-process jit cache and need none of
        this.  A thread failure only forfeits the overlap (the real
        call then compiles inline), so thread errors are swallowed.
        ``SANM_WARM=0`` disables for A/B.

        Gated OFF for svd-bearing (two-level) graphs: on a host with
        few cores the background tracing/compiles contend with the svd
        path's heavy host work (NumPy f(x0), splu) instead of hiding
        behind it, and the contention bleeds into the warm samples.
        The win case is the Neo-Hookean class, which is exactly
        ``split is None``."""
        import os
        import threading

        if getattr(self, "_warm_started", False):
            return
        self._warm_started = True
        if os.environ.get("SANM_WARM", "1") == "0":
            return
        if self._hyb_split is not None and os.environ.get(
            "SANM_WARM", ""
        ) != "1":
            return
        _, step_small, _, step_fn, prepare_light = self._hybrid_fns()
        _, prep_raw = self._hyb_raw
        split = self._hyb_split
        order = self.hp.order
        xt0 = jnp.asarray(xt0_np)

        def _zeros(tree):
            return jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), tree
            )

        box = {"x0": xt0_np.copy()}

        def _prep():
            try:
                box["out"] = prepare_light(xt0)
            except Exception:  # pragma: no cover - overlap is optional
                pass

        def _steps():
            try:
                sh = jax.eval_shape(prep_raw, xt0)
                carry, aux0 = _zeros(sh)
                xt_k = jnp.zeros((self.n + 1,), jnp.float64)
                step1 = step_fn if split is None else step_small
                carry, _, caches = step1(carry, aux0, 1, xt_k, None)
                if split is None:
                    if order >= 2:
                        step_fn(carry, aux0, 2, xt_k, caches)
                    return
                if split >= 2:  # half-capacity k>=2 variant
                    carry, _, caches = step_small(
                        carry, aux0, 2, xt_k, caches
                    )
                # promote + the full-capacity variant used after it
                carry = self._hyb[2](carry)
                step_fn(carry, aux0, split + 1, xt_k, caches)
            except Exception:  # pragma: no cover - overlap is optional
                pass

        tp = threading.Thread(target=_prep, daemon=True)
        ts = threading.Thread(target=_steps, daemon=True)
        tp.start()
        ts.start()
        self._warm_prep = (tp, box)
        self._warm_threads = (tp, ts)

    def join_warm_threads(self):
        """Block until any `_cold_warm` background compiles finish.

        Warm-timing harnesses call this before starting the clock so a
        still-running compile thread cannot steal the (single) host
        core from the timed re-solve."""
        for t in getattr(self, "_warm_threads", ()):
            t.join()
        self._warm_threads = ()

    def _take_warm_prep(self, xt0_np):
        """Join the prepare_light warm thread and return its result if
        it ran on this exact start point; None otherwise.  One-shot."""
        wp = getattr(self, "_warm_prep", None)
        self._warm_prep = None
        if wp is None:
            return None
        tp, box = wp
        if not np.array_equal(box["x0"], xt0_np):
            return None
        tp.join()
        return box.get("out")

    def _expand_hybrid(self, xt0_np, v_np):
        """Full expansion with host-side sparse direct solves."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        hp = self.hp
        n = self.n
        if self._solver_mode() in (
            "dense_chol", "band_chol"
        ) and not hp.xcoeff_l2_penalty:
            out = self._expand_hybrid_devloop(xt0_np, v_np)
            if out is not None:
                return out
            if verbose_mode():
                print("%s: indefinite stiffness; host-LU fallback"
                      % self._solver_mode())
        jac_asm, step_small, promote, step_fn, prepare_light = (
            self._hybrid_fns()
        )
        split = self._hyb_split
        asm = self._assembler()
        xt0 = jnp.asarray(xt0_np)
        pen = hp.xcoeff_l2_penalty
        fact = getattr(self, "_fact", None)
        reuse = self._fact_reusable(fact, xt0_np)
        self._last_fact_reused = reuse
        if reuse:
            with ScopedProfiler("build_sparse_coeff", block=True):
                wp = self._take_warm_prep(xt0_np)
                carry, aux = (
                    wp if wp is not None else prepare_light(xt0)
                )
            A = fact["A"]
            solve = fact["solve"]
            gt_asm_np = fact["gt_asm"]
        else:
            self._cold_warm(xt0_np)  # no-op if prefetch started it
            pre = self._take_prefetched_jac(xt0_np)
            # dispatch order matters: prepare_light goes to the device
            # queue right behind the Jacobian/assembly and is NOT waited
            # on here, so the engine-buffer initialization executes on
            # the device WHILE the host factorizes below (the profiler's
            # block=True barrier serializes this only under SANM_PROFILE)
            with ScopedProfiler("build_sparse_coeff"):
                data, gt_asm, _E = (
                    pre if pre is not None else jac_asm(xt0)
                )
                wp = self._take_warm_prep(xt0_np)
                carry, aux = (
                    wp if wp is not None else prepare_light(xt0)
                )
            with ScopedProfiler("sparse_prep"):
                if self._solver_mode() == "cg":
                    # device-resident PCG, host-driven in fixed-trip
                    # jitted chunks between the per-order dispatches
                    from .linear import SparseCG

                    cg = SparseCG(asm, data, l2_penalty=pen)
                    solve = lambda b: np.asarray(cg.solve(jnp.asarray(b)))
                    data_np = np.asarray(data)
                    A = sp.csr_matrix(
                        (data_np, (asm.csr_rowidx, asm.csr_cols)),
                        shape=(n, n),
                    )
                    gt_asm_np = (
                        np.asarray(gt_asm) if self.is_implicit else None
                    )
                else:
                    data_np = np.asarray(data)
                    A = sp.csr_matrix(
                        (data_np, (asm.csr_rowidx, asm.csr_cols)),
                        shape=(n, n),
                    )
                    solve = self._splu_factorize(A, pen)
                    gt_asm_np = (
                        np.asarray(gt_asm) if self.is_implicit else None
                    )
            ncmp = n + 1 if self.is_implicit else n
            self._fact = {
                "x0": xt0_np[:ncmp].copy(),
                "A": A,
                "solve": solve,
                "gt_asm": gt_asm_np,
            }
        grad_t = gt_asm_np if self.is_implicit else v_np
        with ScopedProfiler("sparse_solve"):
            xgt = solve(grad_t)
        t1 = 1.0 / np.sqrt(xgt @ xgt + 1.0)
        x1 = -t1 * xgt
        xgt_dot_x1 = x1 @ xgt
        coeffs = np.zeros((hp.order + 1, n + 1))
        coeffs[0] = xt0_np
        coeffs[1, :n] = x1
        coeffs[1, n] = t1
        diag = []
        sanity = hp.sanity_check and not pen
        # fused loop: one device dispatch (commit k + bias k+1) per order
        with ScopedProfiler("order_step", block=True):
            step1 = step_fn if split is None else step_small
            carry, b_dev, caches = step1(
                carry, aux, 1, jnp.asarray(coeffs[1]), None
            )
        for k in range(2, hp.order + 1):
            with ScopedProfiler("bias_pull"):
                b = np.asarray(b_dev)
            with ScopedProfiler("sparse_solve"):
                xb = solve(b)
            tk = (xb @ x1) / (t1 - xgt_dot_x1)
            xk = -tk * xgt - xb
            coeffs[k, :n] = xk
            coeffs[k, n] = tk
            if sanity:
                with ScopedProfiler("eqn_check_host"):
                    resid = A @ xk + grad_t * tk + b
                    scale = max(np.linalg.norm(grad_t * tk + b), 1e-30)
                    diag.append(np.linalg.norm(resid) / scale)
            if k < hp.order:
                with ScopedProfiler("order_step", block=True):
                    if split is not None and k == split + 1:
                        carry = promote(carry)
                    step = (
                        step_fn
                        if split is None or k > split
                        else step_small
                    )
                    carry, b_dev, caches = step(
                        carry, aux, k, jnp.asarray(coeffs[k]), caches
                    )
        return coeffs, np.asarray(diag)

    def _expansion_impl(self, xt0, v):
        hp = self.hp
        n = self.n
        eng = self.tfn.engine()
        gin0 = self._shard(self.remap_inp.apply(self.prepare_inp(xt0)))
        eng.start(gin0)

        def graph_in_k(xt_k):
            return self.remap_inp.apply(self.prepare_inp(xt_k))

        # ---- order 1: Jacobian, assembly, factorization --------------
        bias = eng.order_bias()
        if bias is not None:
            raise SANMError("order-1 bias must be structurally zero")
        with ScopedProfiler("build_sparse_coeff"):
            jacf = lambda g: self.tfn(g)
            J = batched_jacobian(jacf, gin0)
            asm = self._assembler()
            data, gt_asm = asm.assemble_csr(J)
        grad_t = gt_asm if self.is_implicit else v
        with ScopedProfiler("sparse_prep"):
            solver = self._make_solver(asm, data)
        with ScopedProfiler("sparse_solve"):
            xgt = solver.solve(grad_t)
        # x1 . x1 + t1^2 = 1  (anm.cpp:244-246)
        t1 = 1.0 / jnp.sqrt(jnp.vdot(xgt, xgt) + 1.0)
        x1 = -t1 * xgt
        xgt_dot_x1 = jnp.vdot(x1, xgt)
        xt_1 = jnp.concatenate([x1, t1[None]])

        sanity = hp.sanity_check and not hp.xcoeff_l2_penalty

        def order_step(b_flat):
            """back-substitution + scalar recurrence for one order k>=2
            (anm.cpp:251-263)."""
            with ScopedProfiler("sparse_solve"):
                xbi = solver.solve(b_flat)
            ti = jnp.vdot(xbi, x1) / (t1 - xgt_dot_x1)
            xi = -ti * xgt - xbi
            return xi, ti

        def eqn_check(xi, ti, b_flat):
            # A x_i + gt t_i + b_i ~= 0  (anm.cpp:271-285)
            resid = solver.apply(xi) + grad_t * ti + b_flat
            scale = jnp.maximum(
                jnp.linalg.norm(grad_t * ti + b_flat), 1e-30
            )
            return jnp.linalg.norm(resid) / scale

        if self._loop_mode() == "unroll":
            coeffs = [xt0, xt_1]
            diag_eqn_err = []
            if sanity:
                diag_eqn_err.append(
                    eqn_check(x1, t1, jnp.zeros((n,), xt0.dtype))
                )
            for i in range(2, hp.order + 1):
                eng.push(graph_in_k(coeffs[-1]))
                b_out = self.remap_out.apply(eng.order_bias())
                b_flat = (
                    jnp.zeros((n,), xt0.dtype)
                    if b_out is None
                    else b_out.reshape(-1)
                )
                xi, ti = order_step(b_flat)
                coeffs.append(jnp.concatenate([xi, ti[None]]))
                if sanity:
                    diag_eqn_err.append(eqn_check(xi, ti, b_flat))
            diag = (
                jnp.stack(diag_eqn_err)
                if diag_eqn_err
                else jnp.zeros((0,), xt0.dtype)
            )
            return jnp.stack(coeffs), diag

        # ---- scan mode: one compiled body for orders 2..N -------------
        from ..taylor_scan import ScanEngine

        eng.push(graph_in_k(xt_1))
        seng = ScanEngine(eng, hp.order)
        XT = jnp.zeros((hp.order + 1, n + 1), xt0.dtype)
        XT = XT.at[0].set(xt0).at[1].set(xt_1)
        diag0 = jnp.zeros((hp.order + 1,), xt0.dtype)
        if sanity:
            diag0 = diag0.at[1].set(
                eqn_check(x1, t1, jnp.zeros((n,), xt0.dtype))
            )

        def body(state, k):
            carry, XT, diag = state
            b_out, caches = seng.order_bias(carry, k)
            if isinstance(b_out, tuple):
                raise SANMError("multi-output graphs unsupported in ANM")
            if b_out is None:
                oav = self.tfn.jaxpr.outvars[0].aval
                b_out = jnp.zeros(oav.shape, oav.dtype)
            b_flat = self.remap_out.apply(b_out).reshape(-1)
            xi, ti = order_step(b_flat)
            xt_i = jnp.concatenate([xi, ti[None]])
            XT = XT.at[k].set(xt_i)
            if sanity:
                diag = diag.at[k].set(eqn_check(xi, ti, b_flat))
            carry = seng.push(carry, k, graph_in_k(xt_i), caches)
            return (carry, XT, diag), None

        state0 = (seng.init_carry(), XT, diag0)
        (carry, XT, diag), _ = jax.lax.scan(
            body, state0, jnp.arange(2, hp.order + 1)
        )
        return XT, diag[1:] if sanity else jnp.zeros((0,), xt0.dtype)

    def _assembler(self):
        """Lazily built static-topology assembler (host work, once)."""
        if getattr(self, "_asm", None) is None:
            B = self.remap_inp.out_shape[0]
            idim = self.remap_inp.n_out // B
            odim = self.remap_out.inp_size // B
            from .remap import SparseAssembler

            self._asm = SparseAssembler(
                self.remap_out, self.remap_inp, B, odim, idim, self.n
            )
        return self._asm

    def _solver_mode(self):
        # sticky per-solve fallback set when a devloop expansion fails
        # its numerical checks (see solve_expansion_coeffs)
        ov = getattr(self, "_solver_override", None)
        if ov is not None:
            return ov
        mode = self.hp.solver
        if mode == "auto":
            # the in-graph dense factorization (f32 QR + f64 refinement)
            # for small systems; host sparse LU (hybrid loop) above
            # dense_limit, which is also what large systems need for
            # O(nnz) memory
            mode = "dense" if self.n <= self.hp.dense_limit else "host_lu"
        return mode

    def _make_solver(self, asm, data):
        """Factorize once per continuation step (reference
        ``SparseSolver::prepare``, ``libsanm/sparse_solver.cpp:327-421``)."""
        mode = self._solver_mode()
        pen = self.hp.xcoeff_l2_penalty
        if mode == "dense":
            A = asm.assemble_dense_from_csr(data)
            return DenseFactorSolver(A, pen)
        if mode == "host_lu":
            from .linear import HostLUSolver

            return HostLUSolver(asm, data, pen)
        if mode == "cg":
            from .linear import SparseCG

            return SparseCG(asm, data, l2_penalty=pen)
        if mode == "dense_chol":
            from .linear import DeviceCholSolver

            return DeviceCholSolver(asm, data, l2_penalty=pen)
        if mode == "band_chol":
            from .band import DeviceBandCholSolver

            return DeviceBandCholSolver(asm, data, l2_penalty=pen)
        raise SANMError(f"unknown solver mode {mode}")

    # -- host control -----------------------------------------------------
    def init_xt0(self, x, t):
        x = np.asarray(x).reshape(-1)
        sanm_assert(x.size == self.n)
        self.xt0 = np.concatenate([x, [float(t)]])

    def _eval_fx_np(self, xt0):
        """Residual evaluation f(x0) in strict-IEEE NumPy f64.

        The residual decides convergence against the paper's 1e-10
        absolute force-RMS target, so it is evaluated by one exact
        NumPy forward pass per continuation restart, independent of the
        backend's compile flags; the expansion itself stays on the
        device, and its coefficient noise is absorbed by the
        error-correcting restarts."""
        if getattr(self, "_np_eval", None) is None:
            from ..taylor import numpy_eval

            self._np_eval = numpy_eval(self.tfn)
        gin = self.remap_inp.apply_np(np.asarray(self.prepare_inp(xt0)))
        out = self._np_eval(gin)
        return self.remap_out.apply_np(out).reshape(-1)

    def solve_expansion_coeffs(self):
        with ScopedProfiler("solve_expansion_coeffs", block=True):
            self._maybe_prefetch_jac()
            with ScopedProfiler("eval_fx0_np"):
                fx = self._eval_fx_np(self.xt0)
            if not self.on_fx0_computed(np.asarray(fx)):
                # drop the speculative Jacobian dispatch and any warm
                # prepare_light result: nothing will consume them and
                # they pin device buffers for the solver's remaining
                # lifetime otherwise
                self._prefetched = None
                self._warm_prep = None
                self.xt_coeffs = self.xt0[None, :]
                return
            try:
                self._expand_and_check()
            except SANMNumericalError:
                if getattr(self, "_last_fact_reused", False):
                    # the stale-Jacobian expansion went numerically bad:
                    # drop the cached factorization and redo this
                    # restart with a fresh one
                    self._fact = None
                    self._expand_and_check()
                elif (
                    self._loop_mode() == "hybrid"
                    and self._solver_mode() in ("dense_chol", "band_chol")
                ):
                    # the f32-factor devloop passed its isfinite gate
                    # but the expansion failed the order checks — the
                    # factor itself can be the weak link (measured: jet
                    # NHI gravity violates orthogonality at 1.8e-2
                    # through the band factor while host LU solves it;
                    # the f64 graph retry alone cannot fix a solver
                    # problem).  Fall back to exact host sparse LU for
                    # the REST of this solve (sticky), then escalate to
                    # the f64 graph retry if the failure persists.
                    if verbose_mode():
                        print(
                            "%s expansion failed checks; host-LU "
                            "fallback" % self._solver_mode()
                        )
                    self._solver_override = "host_lu"
                    self._factor_gate_fails = (
                        getattr(self, "_factor_gate_fails", 0) + 1
                    )
                    self._fact_dev = None
                    try:
                        self._expand_and_check()
                    except SANMNumericalError:
                        self._retry_f64()
                else:
                    self._retry_f64()
        self._iter += 1
        if verbose_mode():
            print(
                "ANM iter %d: bound=%g t_max=%g |x_k|=%s"
                % (
                    self._iter,
                    self._t_max_a,
                    self._t_max,
                    [
                        float(np.linalg.norm(c))
                        for c in self.xt_coeffs
                    ],
                )
            )

    def _retry_f64(self):
        """Redo the current restart with f64 graph passes — the
        mixed-precision expansion went non-finite or failed its checks
        (rare, extreme-distortion ARAP states); same error-correction
        philosophy as the reference's restarts
        (``libsanm/anm.cpp:464-491``).  Re-raises the active
        SANMNumericalError when the retry is not applicable (already
        f64, non-hybrid loop, or disabled)."""
        if not (
            self._loop_mode() == "hybrid"
            and self._pass_dtype() == jnp.float32
            and getattr(self, "_f64_retry", True)
        ):
            raise
        self._dtype_override = "f64"
        self._hyb = None
        self._devfns = None
        try:
            self._expand_and_check()
        finally:
            self._dtype_override = None
            self._hyb = None
            self._devfns = None

    def _expand_and_check(self):
        hp = self.hp
        if self._loop_mode() == "hybrid":
            coeffs, diag = self._expand_hybrid(
                self.xt0, self._gt_payload()
            )
        else:
            self._last_fact_reused = False
            coeffs, diag = self._expand_jit(
                jnp.asarray(self.xt0), jnp.asarray(self._gt_payload())
            )
        coeffs = np.asarray(coeffs)
        diag = np.asarray(diag)
        if not np.isfinite(coeffs).all():
            raise SANMNumericalError(
                "non-finite expansion coefficients"
            )
        if hp.sanity_check and diag.size:
            worst = float(diag.max())
            if not np.isfinite(worst) or worst > 1e-4:
                raise SANMNumericalError(
                    "ANM coefficient equation check failed: rel err %g"
                    % worst
                )
            # orthogonality checks (anm.cpp:279-284); relative to the
            # coefficient magnitudes since high-order terms can be huge
            d = coeffs[1:] @ coeffs[1]
            if abs(d[0] - 1) > 1e-4:
                raise SANMNumericalError("|x1|^2+t1^2 != 1: %g" % d[0])
            scales = np.linalg.norm(coeffs[2:], axis=1) * np.linalg.norm(
                coeffs[1]
            ) + 1e-30
            if len(d) > 1 and (np.abs(d[1:]) / scales).max() > 1e-4:
                raise SANMNumericalError(
                    "orthogonality violated: %g"
                    % (np.abs(d[1:]) / scales).max()
                )
        self.xt_coeffs = self._truncate_noise_tail(coeffs)
        self._estimate_valid_range()

    def _truncate_noise_tail(self, coeffs):
        """Adaptive effective order: drop trailing coefficients that are
        amplified numerical noise.

        A convergent-radius series has monotone-trending |x_k|; when
        per-order bias noise is amplified through A^{-1} the tail shows
        a V-shape — decay to a noise floor, then geometric regrowth
        (measured on armadillo-small ARAP: decay to ~1e-6 at k~7, then
        ~16x per order up to 1e14).  Including that tail collapses the
        estimated validity range (a_max uses |x_N|) and eventually
        overflows.  Truncating at the V-bottom keeps the genuinely
        informative orders; the error-correcting restarts absorb the
        (now bounded) truncation error.  The reference never needs this
        because its all-f64 CPU noise floor sits below maxr relevance.
        """
        norms = np.linalg.norm(coeffs, axis=1)
        self._tail_truncated = False
        if len(norms) < 7:
            return coeffs
        kmin = int(np.argmin(norms[1:])) + 1
        # threshold 100: genuine series plateau/oscillate within ~10x of
        # their envelope; a 100x regrowth is amplified noise.  (A first
        # 1e4 threshold let a 300x tail through on armadillo ARAP —
        # evaluated at a=3.5, its |x_20| a^20 contribution stepped the
        # continuation onto a near-singular state and the next
        # expansion overflowed.)
        if kmin >= 5 and kmin < len(norms) - 1 and (
            norms[-1] > norms[kmin] * 100.0
        ):
            if verbose_mode():
                print(
                    "ANM: truncating noise tail at order %d "
                    "(|x_%d|=%.2g, |x_N|=%.2g)"
                    % (kmin, kmin, norms[kmin], norms[-1])
                )
            self._tail_truncated = True
            return coeffs[: kmin + 1]
        return coeffs

    def _estimate_valid_range(self):
        """Reference ``estimate_valid_range`` (``libsanm/anm.cpp:117-154``):
        a_max = (maxr * |x_1| / |x_N|)^(1/(N-1)), optionally extended by
        the Pade approximant.  Uses the EFFECTIVE order (the series may
        have been noise-truncated below hp.order)."""
        coeffs = self.xt_coeffs
        n_eff = len(coeffs) - 1
        max_a_bound = (
            self.max_a_bound
            if n_eff == self.hp.order
            else polynomial.stable_x_range(n_eff)
        )
        x1n = float(np.linalg.norm(coeffs[1]))
        xback = max(float(np.linalg.norm(coeffs[-1])), 1e-15)
        a_bound = (self.hp.maxr / xback * x1n) ** (
            1.0 / (n_eff - 1)
        )
        a_bound = min(a_bound, max_a_bound)
        self._t_coeffs = coeffs[:, -1].copy()
        if not self._t_coeffs[1] > 0:
            raise SANMNumericalError(
                "t does not increase: t1=%g" % self._t_coeffs[1]
            )
        self._t_max_a = a_bound
        self._t_max = polynomial.eval_poly(self._t_coeffs, a_bound)
        if self._t_max <= self._t_coeffs[0]:
            raise SANMNumericalError(
                "t does not increase at iter %d: t0=%g tmax=%g bound=%g"
                % (self._iter, self._t_coeffs[0], self._t_max, a_bound)
            )

        self._pade = None
        import os

        use_pade = self.hp.use_pade or bool(os.environ.get("SANM_PADE"))
        if use_pade and a_bound < max_a_bound:
            with ScopedProfiler("pade_build"):
                pade = PadeApproximation(
                    self.xt_coeffs,
                    anm_cond=not self.hp.xcoeff_l2_penalty,
                )
            with ScopedProfiler("pade_est"):
                ok = pade.ok and pade.estimate_valid_range(
                    a_bound, self.hp.maxr, max_a_bound
                )
            if ok:
                self._pade = pade
                self._t_max_a = pade.t_max_a
                self._t_max = pade.t_max
            self._log_pade(a_bound, ok, pade)
        elif use_pade:
            self._log_pade(a_bound, False, None)

    def _log_pade(self, a_bound, accepted, pade):
        """Per-restart Pade acceptance record (the reference measures
        the aggregate 'Pade benefit' as iterations saved,
        ``render/gen_table_figs.py:341-359``; this logs WHY each step's
        extension was accepted or rejected and by how much it gained)."""
        rec = {
            "iter": self._iter + 1,
            "a_series": float(a_bound),
            "accepted": bool(accepted),
        }
        if accepted:
            rec["a_pade"] = float(pade.t_max_a)
            rec["gain"] = float(pade.t_max_a / a_bound)
        elif pade is not None:
            rec["reject"] = pade.reject_reason or "range estimation"
        else:
            rec["reject"] = "series bound hit stable_x_range"
        self.pade_log = getattr(self, "pade_log", [])
        self.pade_log.append(rec)
        if verbose_mode():
            print("pade:", rec)

    # -- public API (reference ANMDriverHelper public section) -------------
    def get_t_upper(self):
        return self._t_max

    def get_t_max_a(self):
        return self._t_max_a

    def get_t0(self):
        return float(self._t_coeffs[0])

    def get_nr_iter(self):
        return self._iter

    def eval_xt(self, a):
        if self._pade is not None:
            return self._pade.eval_xt(a)
        return polynomial.eval_tensor_poly(self.xt_coeffs, a)

    def eval(self, a):
        xt = self.eval_xt(a)
        return xt[: self.n], float(xt[self.n])

    def solve_a(self, t):
        """Find a such that t(a) = t (reference ``anm.cpp:174-191``)."""
        if t == self._t_max:
            return self._t_max_a
        if self._pade is not None:
            return self._pade.solve_a(t)
        sanm_assert(t >= self._t_coeffs[0] and t < self._t_max)
        lo, hi = (0.0, self._t_max_a) if self._t_max_a > 0 else (
            -self._t_max_a,
            0.0,
        )
        return polynomial.solve_eqn(self._t_coeffs, lo, hi, t)

    def update_approx(self):
        """Move the start point to the end of the validated range and
        re-expand (reference ``anm.cpp:156-159``)."""
        with ScopedProfiler("eval_xt"):
            self.xt0 = np.asarray(self.eval_xt(self._t_max_a))
        self.solve_expansion_coeffs()


class ANMSolverVecScale(_ANMDriverBase):
    """Solve f(x) + t*v = 0 for the curve x(t)
    (reference ``ANMSolverVecScale``, ``libsanm/anm.cpp:319-443``)."""

    def __init__(
        self,
        fn,
        remap_inp,
        remap_out,
        x0,
        t0,
        v,
        hyper_param=None,
        shard_elems=None,
        _defer_init=False,
    ):
        x0 = np.asarray(x0).reshape(-1)
        super().__init__(
            fn,
            remap_inp,
            remap_out,
            x0.size,
            hyper_param,
            shard_elems,
        )
        self.v = None if v is None else np.asarray(v).reshape(-1)
        if self.v is not None:
            sanm_assert(self.v.size == self.remap_out.n_out)
        self.init_xt0(x0, t0)
        if not _defer_init:
            self.solve_expansion_coeffs()

    def prepare_inp(self, xt):
        return xt[: self.n]

    def _gt_payload(self):
        return self.v

    def on_fx0_computed(self, fx) -> bool:
        self._check_t0v_match(fx)
        return True

    def _check_t0v_match(self, fx):
        """f(x0) + t0*v = 0 must hold at the start point
        (reference ``check_t0v_match``, ``libsanm/anm.cpp:343-360``)."""
        t0 = float(self.xt0[self.n])
        a = fx.reshape(-1)
        b = self.v * t0
        maxerr = (
            np.maximum(np.minimum(np.abs(a), np.abs(b)), 1.0)
            * self.hp.solution_check_tol
        )
        bad = np.abs(a + b) > maxerr
        if bad.any():
            i = int(np.argmax(np.abs(a + b)))
            raise SANMNumericalError(
                "f(x0)+t0*v is not zero: lhs=%g rhs=%g idx=%d iter=%d"
                % (a[i], b[i], i, self._iter)
            )


class ANMEqnSolver(ANMSolverVecScale):
    """Solve f(x) + y = 0 with error-correcting restarts
    (reference ``ANMEqnSolver``, ``libsanm/anm.cpp:445-491``).

    Each restart expands the homotopy f(x) + t*(f(x0)+y) = f(x0) from
    t=0; reaching t=1 solves the equation, and restarting from the
    current point re-targets the *remaining* residual — this restart IS
    the error-correction mechanism."""

    def __init__(
        self, fn, remap_inp, remap_out, x0, y, hyper_param=None,
        shard_elems=None,
    ):
        hp = hyper_param or EqnHyperParam()
        self._converge_rms = getattr(hp, "converge_rms", 1e-5)
        self._converged = False
        self._residual_rms = np.inf
        self.eqn_y = np.asarray(y).reshape(-1)
        super().__init__(
            fn, remap_inp, remap_out, x0, 0.0, None, hp,
            shard_elems, _defer_init=True,
        )
        sanm_assert(self.eqn_y.size == self.remap_out.n_out)
        self._x0_init = np.asarray(x0).reshape(-1).copy()
        self.solve_expansion_coeffs()

    def on_fx0_computed(self, fx) -> bool:
        if self._converged:
            return False
        self.v = fx.reshape(-1) + self.eqn_y
        self._residual_rms = float(
            np.sqrt(np.mean(self.v * self.v))
        )
        if self._residual_rms < self._converge_rms:
            self._converged = True
            return False
        return True

    def next_iter(self):
        """Reference ``ANMEqnSolver::next_iter`` (``anm.cpp:464-478``),
        plus a residual backoff the reference does not need: when
        residual coefficient noise survives into the series, evaluating
        at the full validated range can *increase* the residual (step
        off the solution curve); halving ``a`` until the candidate does
        not regress keeps every restart monotone.  Costs one exact
        NumPy forward evaluation per probe."""
        if self._converged:
            return self
        a = self.solve_a(1.0) if self.get_t_upper() >= 1.0 else (
            self.get_t_max_a()
        )
        prev_rms = self._residual_rms
        cand = np.asarray(self.eval_xt(a))
        if getattr(self, "_tail_truncated", False):
            # only probe when this step's series actually carried an
            # amplified-noise tail; clean expansions step like the
            # reference (saves one exact forward eval per restart)
            for _ in range(6):
                fx = self._eval_fx_np(cand)
                v = fx.reshape(-1) + self.eqn_y
                rms = float(np.sqrt(np.mean(v * v)))
                if np.isfinite(rms) and rms <= prev_rms * 1.5:
                    break
                a *= 0.5
                if verbose_mode():
                    print(
                        "ANM backoff: rms %g > 1.5x prev %g; a -> %g"
                        % (rms, prev_rms, a)
                    )
                cand = np.asarray(self.eval_xt(a))
        self.xt0 = cand
        self.xt0[self.n] = 0.0  # reset t0
        self.solve_expansion_coeffs()
        return self

    def residual_rms(self):
        return self._residual_rms

    def converged(self):
        return self._converged

    def get_x(self):
        return self.xt0[: self.n]

    def reset(self, x0=None):
        """Restart the homotopy from ``x0`` (default: the original start
        point) reusing the compiled kernels and host assembler — the
        warm path of a long-lived solver.  Runs the first expansion."""
        if x0 is None:
            x0 = self._x0_init
        self.xt0 = np.concatenate([np.asarray(x0).reshape(-1), [0.0]])
        self._converged = False
        self._residual_rms = np.inf
        self._pade = None
        self._t_max = 0.0
        self._t_max_a = 0.0
        # the sticky host-LU fallback is per-SOLVE: a transient devloop
        # check failure must not disable band/dense_chol for later,
        # independent solves on the same warm instance
        self._solver_override = None
        self.solve_expansion_coeffs()
        return self


class ANMImplicitSolver(_ANMDriverBase):
    """Solve F(x, t) = F(x0, t0) where F maps R^(n+1) -> R^n, t increasing
    from t0 (reference ``ANMImplicitSolver``, ``libsanm/anm.cpp:493-615``).
    The extra unknown t is the last input of remap_inp; its assembled
    column becomes grad_t."""

    is_implicit = True

    def __init__(
        self, fn, remap_inp, remap_out, x0, t0, hyper_param=None,
        shard_elems=None,
    ):
        x0 = np.asarray(x0).reshape(-1)
        sanm_assert(remap_inp.inp_size == x0.size + 1)
        super().__init__(
            fn, remap_inp, remap_out, x0.size, hyper_param, shard_elems
        )
        self._fx0 = None
        self.init_xt0(x0, t0)
        self.solve_expansion_coeffs()

    def prepare_inp(self, xt):
        return xt

    def on_fx0_computed(self, fx) -> bool:
        if self._fx0 is None:
            self._fx0 = fx.copy()
        else:
            scale = np.maximum(
                np.maximum(np.abs(self._fx0), np.abs(fx)), 1.0
            )
            err = float(np.max(np.abs(self._fx0 - fx) / scale))
            if err > self.hp.solution_check_tol:
                raise SANMNumericalError(
                    "check f(x0,t0)=f(x,t) failed: rel err %g" % err
                )
        return True

    def fx0(self):
        return self._fx0
