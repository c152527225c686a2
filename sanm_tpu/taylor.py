"""Taylor-coefficient propagation engine over jaxprs.

JAX redesign of the reference's symbolic layer
(``libsanm/symbolic.{h,cpp}``, ``libsanm/oprs/*``): instead of a
hand-rolled computing graph where every operator implements the
six-method ``OperatorMeta`` contract (``libsanm/symbolic.h:171-218``),
models are written as plain ``jax.numpy`` functions.  The function is
traced once to a jaxpr, and this module interprets the jaxpr with
per-primitive *incremental Taylor rules*.

Mathematical contract (identical to the reference,
``libsanm/symbolic.h:319-383``): writing the input series
``x(a) = sum_k x_k a^k`` and any intermediate/output series
``v(a) = sum_k v_k a^k``, each order-k coefficient is an affine function
of the input coefficient::

    v_k = J_v @ x_k + b_v_k

where ``J_v`` (the order-0 Jacobian) is the *same for every order k* and
``b_v_k`` depends only on coefficients of order < k.  The engine
alternates two passes per order, mirroring
``TaylorCoeffProp::compute_next_order_bias`` / ``push_xi``
(``libsanm/symbolic.cpp:140-303``):

* :meth:`TaylorEngine.order_bias` — runs every rule with the input
  order-k coefficient set to zero, producing ``b_k`` of the outputs (and
  caching each rule's convolution terms);
* :meth:`TaylorEngine.push` — once the solver has determined ``x_k``,
  re-runs only the cheap linear part of every rule (reusing the cached
  convolutions) and commits every variable's order-k coefficient to the
  series history.

All of this happens at JAX trace time: the driver unrolls the order
loop inside one ``jax.jit``, so the engine manipulates tracers and the
whole expansion compiles to a single XLA program — the replacement
for the reference's persistent worker threads
(``ParallelTaylorCoeffProp``, ``libsanm/symbolic.cpp:305-591``).

Zero coefficients are represented by ``None`` so that XLA never sees
the all-zero order-1 biases (the reference interns zero storages for
the same reason, ``libsanm/tensor.h:74-109``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
from jax._src import core as jcore

from .utils import SANMError, SANMNumericalError

# ----------------------------------------------------------------------------
# zero-coefficient helpers ("None" == structural zero)
# ----------------------------------------------------------------------------


def z_add(*xs):
    """Sum with structural-zero awareness; returns None if all are None."""
    acc = None
    for x in xs:
        if x is None:
            continue
        acc = x if acc is None else acc + x
    return acc


def z_neg(x):
    return None if x is None else -x


def z_scale(x, s):
    return None if x is None else x * s


def z_mul(a, b):
    return None if (a is None or b is None) else a * b


def materialize(x, aval):
    if x is not None:
        return x
    return jnp.zeros(aval.shape, aval.dtype)


# ----------------------------------------------------------------------------
# rule registry
# ----------------------------------------------------------------------------

# rule(engine, eqn, eqn_idx, k, in_k, cache, commit) -> (list_of_out_k, cache)
RULES: Dict[Any, Callable] = {}

# hist_needs(eqn) -> (list[bool] per invar, list[bool] per outvar)
HIST_NEEDS: Dict[Any, Callable] = {}


def register_rule(prim, rule, hist_needs=None):
    RULES[prim] = rule
    if hist_needs is not None:
        HIST_NEEDS[prim] = hist_needs


def _default_hist_needs(eqn, is_varying):
    return [False] * len(eqn.invars), [False] * len(eqn.outvars)


def _hi_params(eqn):
    """Force HIGHEST precision on float dot_generals: a backend's default
    f32 matmul may run reduced-mantissa passes (TF32 on recent NVIDIA
    GPUs, ~10 mantissa bits), which destroys high-order coefficients."""
    from jax import lax as _lx

    if eqn.primitive is _lx.dot_general_p and eqn.outvars[0].aval.dtype in (
        jnp.float64,
        jnp.float32,
    ):
        return {
            **eqn.params,
            "precision": (_lx.Precision.HIGHEST, _lx.Precision.HIGHEST),
        }
    return eqn.params


# ----------------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------------


class TaylorFn:
    """A traced model function with Taylor propagation support.

    Counterpart of the reference ``ComputingGraph`` + output ``VarNode``
    (``libsanm/symbolic.h:283-293``): construction traces ``fn`` on
    example inputs; :meth:`engine` yields a fresh per-expansion
    propagation state (the reference re-creates ``TaylorCoeffProp`` per
    expansion too, ``libsanm/anm.cpp:205``).
    """

    def __init__(self, fn: Callable, *example_inputs):
        self.closed_jaxpr = jax.make_jaxpr(fn)(*example_inputs)
        self.jaxpr = self.closed_jaxpr.jaxpr
        self.consts = self.closed_jaxpr.consts
        self._analyze()

    # -- static analysis ----------------------------------------------------
    def _analyze(self):
        jaxpr = self.jaxpr
        used = set()
        for v in jaxpr.outvars:
            if not isinstance(v, jcore.Literal):
                used.add(v)
        live = []
        for idx in range(len(jaxpr.eqns) - 1, -1, -1):
            eqn = jaxpr.eqns[idx]
            outs_used = [
                (not isinstance(v, jcore.DropVar)) and v in used
                for v in eqn.outvars
            ]
            if not any(outs_used):
                continue
            live.append((idx, eqn, outs_used))
            for v in eqn.invars:
                if not isinstance(v, jcore.Literal):
                    used.add(v)
        live.reverse()
        self.live_eqns = live
        self.outs_used = {idx: ou for idx, _, ou in live}

        # series-varying vars: transitively downstream of the graph
        # inputs.  Everything else (consts, literals, const-derived) has
        # zero coefficients at every order >= 1, so convolutions against
        # it vanish and no history needs to be stored for the partner
        # operand either — this prunes e.g. the (N+1, B, 3, 3) history
        # of Ds in F = Ds @ Dm^{-1} (Dm^{-1} is a constant).
        varying = set(v for v in jaxpr.invars)
        for idx, eqn, outs_used in live:
            if any(
                (not isinstance(v, jcore.Literal)) and v in varying
                for v in eqn.invars
            ):
                for v in eqn.outvars:
                    if not isinstance(v, jcore.DropVar):
                        varying.add(v)
        self.varying = varying

        def is_varying(v):
            return (not isinstance(v, jcore.Literal)) and v in varying

        # which vars need full series history
        need = set()
        for idx, eqn, outs_used in live:
            if eqn.primitive not in RULES:
                raise SANMError(
                    "no Taylor rule for primitive %r (eqn: %s)"
                    % (eqn.primitive.name, eqn)
                )
            fn = HIST_NEEDS.get(eqn.primitive, _default_hist_needs)
            ins_need, outs_need = fn(eqn, is_varying)
            for v, n in zip(eqn.invars, ins_need):
                if n and is_varying(v):
                    need.add(v)
            for v, n, u in zip(eqn.outvars, outs_need, outs_used):
                if n and u:
                    need.add(v)
        self.need_hist = need

    # -- plain evaluation ---------------------------------------------------
    def __call__(self, *xs):
        """Plain forward evaluation (reference ``symbolic::eval_unary_func``,
        ``libsanm/symbolic.cpp:44-60``)."""
        outs = jcore.eval_jaxpr(self.jaxpr, self.consts, *xs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def engine(self) -> "TaylorEngine":
        return TaylorEngine(self)


class TaylorEngine:
    """Per-expansion Taylor propagation state (cf. reference
    ``TaylorCoeffProp``, ``libsanm/symbolic.h:319-383``)."""

    def __init__(self, tfn: TaylorFn):
        self.tfn = tfn
        self.jaxpr = tfn.jaxpr
        self.k = -1  # last committed order
        self._pending = False
        self.hist: Dict[Any, List] = {}
        self.userdata: Dict[int, Any] = {}
        self._caches: Dict[int, Any] = {}
        self._env0: Dict[Any, Any] = {}
        self.eqn_out0: Dict[int, list] = {}
        self._const_vars = set(tfn.jaxpr.constvars)

    # -- coefficient access helpers (used by rules) ---------------------------
    def coeff(self, var, i):
        """Order-i coefficient of a var (None == zero).  Literals,
        constants, and const-derived (non-varying) vars are order-0
        only."""
        if isinstance(var, jcore.Literal):
            return var.val if i == 0 else None
        if i >= 1 and var not in self.tfn.varying:
            return None  # const-derived: zero at every higher order
        h = self.hist[var]
        if i < len(h):
            return h[i]
        if var in self._const_vars:
            return None  # constants have zero higher-order coefficients
        raise SANMError(
            "history of %r not stored up to order %d (have %d); "
            "hist_needs analysis bug" % (var, i, len(h))
        )

    def coeff0(self, var):
        return self.coeff(var, 0)

    def conv(self, u, v, k, lo=1, hi=None):
        """sum_{i=lo..hi} u_i * v_{k-i} with elementwise product
        (hi defaults to k-1).  The bread-and-butter Cauchy-product bias of
        the reference's Multiply op (``libsanm/oprs/elem_arith.cpp:181-208``).
        """
        hi = k - 1 if hi is None else hi
        if self._series_const(u) or self._series_const(v):
            return None  # a const factor zeroes every convolution term
        terms = []
        for i in range(lo, hi + 1):
            t = z_mul(self.coeff(u, i), self.coeff(v, k - i))
            if t is not None:
                terms.append(t)
        return z_add(*terms)

    def _series_const(self, var):
        """True when the var has zero coefficients at every order >= 1
        (literal / const / const-derived)."""
        return isinstance(var, jcore.Literal) or var not in self.tfn.varying

    # -- order 0 --------------------------------------------------------------
    def start(self, *x0s):
        """Evaluate order 0 through the graph and initialize series state
        (reference ``push_xi`` at order 0 / ``infer_shape_eval_bias``,
        ``libsanm/symbolic.cpp:162-204``)."""
        jaxpr = self.jaxpr
        env = {}
        for v, c in zip(jaxpr.constvars, self.tfn.consts):
            env[v] = c
        if len(x0s) != len(jaxpr.invars):
            raise SANMError(
                "expected %d inputs, got %d" % (len(jaxpr.invars), len(x0s))
            )
        for v, x in zip(jaxpr.invars, x0s):
            env[v] = jnp.asarray(x)

        def read(v):
            return v.val if isinstance(v, jcore.Literal) else env[v]

        self.eqn_out0 = {}
        for idx, eqn, outs_used in self.tfn.live_eqns:
            invals = [read(v) for v in eqn.invars]
            outs = eqn.primitive.bind(*invals, **_hi_params(eqn))
            if not eqn.primitive.multiple_results:
                outs = [outs]
            self.eqn_out0[idx] = outs
            for v, o in zip(eqn.outvars, outs):
                if not isinstance(v, jcore.DropVar):
                    env[v] = o
        self._env0 = env
        self.hist = {v: [val] for v, val in env.items()}
        self.userdata = {}
        self.k = 0
        self._pending = False
        outs = [read(v) for v in jaxpr.outvars]
        return outs[0] if len(outs) == 1 else tuple(outs)

    # -- one pass over the jaxpr at order k -----------------------------------
    def _run_pass(self, k, in_ks, commit):
        env_k = {}
        for v, xk in zip(self.jaxpr.invars, in_ks):
            env_k[v] = xk

        def read_k(v):
            if isinstance(v, jcore.Literal):
                return None
            return env_k.get(v)  # constvars & consts: zero at k>=1

        for idx, eqn, outs_used in self.tfn.live_eqns:
            in_k = [read_k(v) for v in eqn.invars]
            rule = RULES[eqn.primitive]
            cache = self._caches.get(idx) if commit else None
            out_k, cache = rule(self, eqn, idx, k, in_k, cache, commit)
            if not commit:
                self._caches[idx] = cache
            for v, o in zip(eqn.outvars, out_k):
                if not isinstance(v, jcore.DropVar):
                    env_k[v] = o

        if commit:
            for v in self.tfn.need_hist:
                h = self.hist[v]
                assert len(h) == k, "history out of sync"
                h.append(env_k.get(v))
        return [read_k(v) for v in self.jaxpr.outvars]

    def order_bias(self):
        """Compute the order-(k+1) bias of the outputs with the input
        coefficient held at zero (reference
        ``TaylorCoeffProp::compute_next_order_bias``,
        ``libsanm/symbolic.cpp:249-289``).  Returns None for an all-zero
        bias (always the case at order 1)."""
        if self._pending:
            raise SANMError("order_bias called twice without push")
        k = self.k + 1
        self._caches = {}
        outs = self._run_pass(k, [None] * len(self.jaxpr.invars), commit=False)
        self._pending = True
        return outs[0] if len(outs) == 1 else tuple(outs)

    def push(self, *xks):
        """Commit order k given the solved input coefficient(s)
        (reference ``TaylorCoeffProp::push_xi``,
        ``libsanm/symbolic.cpp:162-201``)."""
        if not self._pending:
            raise SANMError("push without preceding order_bias")
        k = self.k + 1
        outs = self._run_pass(k, list(xks), commit=True)
        self.k = k
        self._pending = False
        return outs[0] if len(outs) == 1 else tuple(outs)


def promote_island(tfn: TaylorFn, promote_prims, extend_downstream=True):
    """Precision-island analysis for :func:`cast_taylor_fn`.

    Returns ``(island_eqns, island_vars)``: the eqn indices and vars
    that must stay float64 inside an otherwise-``dtype`` pass so that a
    numerically sensitive primitive (e.g. ``sanm_svd_w``, whose order-k
    recurrences divide by near-degenerate singular-value gaps,
    reference ``libsanm/tensor_svd.cpp:275-475`` + ``clip_div`` guard
    ``:28-31``) sees exact inputs and keeps exact internal series.

    The island is the seed eqns, their full transitive *upstream*
    closure (so the primitive's input series carries no low-precision
    rounding), plus the *downstream* closure through add/sub/neg chains
    whose var operands are all island — those are the
    cancellation-prone consumers (ARAP's ``P = mu (F - W)`` subtracts
    two nearly equal f64 tensors; rounding them to f32 first loses the
    difference)."""
    from jax import lax as _lx

    island_eqns: set = set()
    island_vars: set = set()
    if not promote_prims:
        return island_eqns, island_vars
    promote_prims = set(promote_prims)
    eqn_of = {idx: eqn for idx, eqn, _ in tfn.live_eqns}
    producer = {}
    for idx, eqn, _ in tfn.live_eqns:
        for v in eqn.outvars:
            if not isinstance(v, jcore.DropVar):
                producer[v] = idx

    # upstream closure from the seed primitives
    stack = [
        idx for idx, eqn, _ in tfn.live_eqns
        if eqn.primitive in promote_prims
    ]
    while stack:
        idx = stack.pop()
        if idx in island_eqns:
            continue
        island_eqns.add(idx)
        for v in eqn_of[idx].invars:
            if isinstance(v, jcore.Literal) or v in island_vars:
                continue
            island_vars.add(v)
            if v in producer:
                stack.append(producer[v])
    for idx in island_eqns:
        for v in eqn_of[idx].outvars:
            if not isinstance(v, jcore.DropVar):
                island_vars.add(v)

    # downstream closure through elementwise/structural chains: extend
    # when at least one var operand is island and every other var
    # operand is island or a closed-over constant (consts and literals
    # are upcast at read).  add/sub capture cancellation (ARAP's
    # P = mu (F - W) subtracts nearly equal tensors); mul/div and the
    # shape ops keep the island's f64 exactness flowing to the graph
    # output, so the per-order bias b_k of an svd-bearing model is
    # assembled without an f32 rounding stage — measured on
    # armadillo-small ARAP: f32-rounded b_k noise (~1e-7 relative) is
    # amplified ~16x per order through A^{-1} and the coefficient tail
    # explodes from a ~1e-6 V-shaped noise floor
    if not extend_downstream:
        # A/B knob: seed + upstream closure only.  Measured on the
        # degenerate-spectrum oracle (tests/test_precision_island.py):
        # the order-k bias error is ~1e-10 with the downstream extension,
        # ~2-7e-8 without it (one f32 rounding of the bias on its way
        # to the graph output), ~5e-2 with no island.  That 1e-7-class
        # floor is exactly the noise measured to stall armadillo ARAP
        # (amplified ~16x per order through A^{-1}) — the extension is
        # load-bearing, not belt-and-braces.
        return island_eqns, island_vars
    ext_prims = (
        _lx.add_p, _lx.sub_p, _lx.neg_p, _lx.mul_p, _lx.div_p,
        _lx.transpose_p, _lx.reshape_p, _lx.broadcast_in_dim_p,
        _lx.squeeze_p,
    )
    constvars = set(tfn.jaxpr.constvars)
    changed = True
    while changed:
        changed = False
        for idx, eqn, _ in tfn.live_eqns:
            if idx in island_eqns or eqn.primitive not in ext_prims:
                continue
            operand_vars = [
                v for v in eqn.invars if not isinstance(v, jcore.Literal)
            ]
            if not any(v in island_vars for v in operand_vars):
                continue
            if not all(
                v in island_vars or v in constvars for v in operand_vars
            ):
                continue
            island_eqns.add(idx)
            for v in eqn.outvars:
                if not isinstance(v, jcore.DropVar):
                    island_vars.add(v)
            changed = True
    return island_eqns, island_vars


def _vpu_dot(a, b, dimension_numbers):
    """Broadcast-multiply-sum form of the small-matmul ``dot_general``
    patterns the FEA models emit; returns None for unsupported dims."""
    (lc, rc), (lb, rb) = dimension_numbers
    if len(lc) != 1 or a.shape[lc[0]] > 4:
        return None
    if lb == () and a.ndim == 3 and b.ndim == 2 and lc == (2,) and rc == (0,):
        # (B, i, j) x (j, k) -> (B, i, k)
        return jnp.sum(
            a[:, :, :, None] * b[None, None, :, :], axis=-2
        )
    if (
        tuple(lb) == (0,) and tuple(rb) == (0,)
        and a.ndim == 3 and b.ndim == 3
        and lc == (2,) and rc == (1,)
    ):
        # batched (B, i, j) x (B, j, k) -> (B, i, k)
        return jnp.sum(
            a[:, :, :, None] * b[:, None, :, :], axis=-2
        )
    return None


def cast_taylor_fn(tfn: TaylorFn, dtype, promote_prims=()) -> TaylorFn:
    """Retrace ``tfn`` with every floating value (inputs, closed-over
    constants, literals) cast to ``dtype``.

    Used for mixed-precision order loops (``graph_dtype="f32"``): the
    high-order graph passes run in f32 while the Jacobian,
    factorization, and residual evaluations stay f64 — the ANM
    error-correcting restarts absorb the bounded coefficient noise
    (the reference runs all-f64, ``libsanm/typedefs.h:12``).

    ``promote_prims``: primitives whose eqns — plus their transitive
    upstream chain and cancellation-prone add/sub consumers — are kept
    at float64 inside the ``dtype`` pass (see :func:`promote_island`).
    The retraced jaxpr then carries mixed f32/f64 avals with explicit
    converts at the island boundary, and every engine (plain, scan)
    inherits per-buffer dtypes from the avals with no further changes.
    Used to run the ``sanm_svd_w`` Taylor recurrences in f64 inside the
    f32 pass: their ``clip_div`` divisions amplify input noise by the
    inverse singular-value gaps, which stalls ARAP continuation on
    meshes with near-degenerate element spectra (measured: force-RMS
    floor ~1e-3 on armadillo-small/human at f32, restarts bounce
    without contracting)."""
    import numpy as np

    dtype = jnp.dtype(dtype)
    f64 = jnp.dtype(jnp.float64)
    jaxpr = tfn.jaxpr
    island_eqns, island_vars = promote_island(tfn, promote_prims)

    def _cast_to(x, want):
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.floating) and x.dtype != want:
            return x.astype(want)
        return x

    def fn(*xs):
        env = {}
        for v, c in zip(jaxpr.constvars, tfn.consts):
            env[v] = jnp.asarray(c)  # cast per-read (island reads want f64)
        for v, x in zip(jaxpr.invars, xs):
            env[v] = x

        def read(v, hi):
            val = (
                jnp.asarray(v.val) if isinstance(v, jcore.Literal) else env[v]
            )
            return _cast_to(val, f64 if hi else dtype)

        constvars = set(jaxpr.constvars)

        def series_const(v):
            return (
                isinstance(v, jcore.Literal)
                or v in constvars
                or v not in tfn.varying
            )

        for idx, eqn, outs_used in tfn.live_eqns:
            hi = idx in island_eqns
            invals = [read(v, hi) for v in eqn.invars]
            if hi and eqn.primitive.name == "dot_general" and any(
                series_const(v) for v in eqn.invars
            ):
                # small f64 matmuls against a constant (e.g.
                # F = Ds @ Dm^{-1}): decompose to broadcast-sum so the
                # island's tiny products stay elementwise work on the
                # (N+1, B, 3, 3) history buffers (see ops/svd_w.py
                # _use_vpu).  The const partner also means
                # the resulting mul eqns need no history.
                out = _vpu_dot(
                    invals[0], invals[1],
                    eqn.params["dimension_numbers"],
                )
                if out is not None:
                    env[eqn.outvars[0]] = out
                    continue
            params = dict(eqn.params)
            if not hi:
                for key in ("new_dtype", "dtype", "preferred_element_type"):
                    if key in params and params[key] == f64:
                        params[key] = dtype
            outs = eqn.primitive.bind(*invals, **params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
            for v, o in zip(eqn.outvars, outs):
                if not isinstance(v, jcore.DropVar):
                    env[v] = o
        outs = [
            read(v, hi=(not isinstance(v, jcore.Literal)) and v in island_vars)
            for v in jaxpr.outvars
        ]
        return outs[0] if len(outs) == 1 else tuple(outs)

    example = [
        jax.ShapeDtypeStruct(
            v.aval.shape,
            (f64 if v in island_vars else dtype)
            if jnp.issubdtype(v.aval.dtype, jnp.floating)
            else v.aval.dtype,
        )
        for v in jaxpr.invars
    ]
    return TaylorFn(fn, *example)


# ----------------------------------------------------------------------------
# batched Jacobian (replaces StSparseLinearTrans composition +
# accum_inp_grad reverse pass, libsanm/symbolic.cpp:206-247)
# ----------------------------------------------------------------------------


def batched_jacobian(fn: Callable, x0, out_inner_size: Optional[int] = None):
    """Dense per-batch-element Jacobian ``(B, odim, idim)`` of a
    batch-elementwise function ``fn: (B, *in_inner) -> (B, *out_inner)``.

    The reference composes structured per-op Jacobians in reverse
    topological order (``ensure_jacobian``, ``libsanm/symbolic.cpp:206-247``);
    under XLA it is both simpler and faster to push ``idim`` basis tangents
    (broadcast across the batch) through ``jax.jvp`` — the passes are
    mutually independent and XLA fuses them into large batched GEMMs.
    """
    x0 = jnp.asarray(x0)
    in_inner = x0.shape[1:]
    idim = int(math.prod(in_inner)) if in_inner else 1
    B = x0.shape[0]
    # linearize once (one primal pass), then push the idim basis
    # tangents (broadcast across the batch) through the linear map
    _, lin = jax.linearize(fn, x0)
    eye = jnp.eye(idim, dtype=x0.dtype)
    tans = jnp.broadcast_to(
        eye.reshape((idim, 1) + in_inner), (idim, B) + in_inner
    )
    if B * idim > 200_000:
        # large batches: evaluate the tangents sequentially — vmapping
        # all idim tangents materializes idim copies of the linearized
        # graph's intermediates at once, many GB for SVD-bearing graphs
        # at 42k tets
        cols = jax.lax.map(lin, tans)  # (idim, B, *out_inner)
    else:
        cols = jax.vmap(lin)(tans)
    return jnp.moveaxis(cols.reshape(idim, B, -1), 0, 2)  # (B, odim, idim)


# ----------------------------------------------------------------------------
# rules: linear structural primitives
# ----------------------------------------------------------------------------

from jax import lax  # noqa: E402


def _linear_rule(engine, eqn, idx, k, in_k, cache, commit):
    if all(x is None for x in in_k):
        return [None] * len(eqn.outvars), cache
    invals = [
        materialize(x, v.aval) if x is None else x
        for x, v in zip(in_k, eqn.invars)
    ]
    outs = eqn.primitive.bind(*invals, **_hi_params(eqn))
    if not eqn.primitive.multiple_results:
        outs = [outs]
    return outs, cache


for _p in [
    lax.transpose_p,
    lax.reshape_p,
    lax.broadcast_in_dim_p,
    lax.squeeze_p,
    lax.slice_p,
    lax.concatenate_p,
    lax.reduce_sum_p,
    lax.convert_element_type_p,
    lax.neg_p,
    lax.rev_p,
    lax.expand_dims_p if hasattr(lax, "expand_dims_p") else lax.reshape_p,
    lax.copy_p if hasattr(lax, "copy_p") else lax.reshape_p,
]:
    register_rule(_p, _linear_rule)

if hasattr(lax, "dynamic_slice_p"):
    register_rule(lax.dynamic_slice_p, _linear_rule)  # static starts only


def _add_rule(sign):
    def rule(engine, eqn, idx, k, in_k, cache, commit):
        u_k, v_k = in_k
        out = z_add(u_k, z_scale(v_k, sign) if sign != 1 else v_k)
        if out is not None and out.shape != eqn.outvars[0].aval.shape:
            out = jnp.broadcast_to(out, eqn.outvars[0].aval.shape)
        return [out], cache

    return rule


register_rule(lax.add_p, _add_rule(1))
register_rule(lax.sub_p, _add_rule(-1))


# ----------------------------------------------------------------------------
# rules: multiplicative primitives (Cauchy products)
# ----------------------------------------------------------------------------


def _mul_rule(engine, eqn, idx, k, in_k, cache, commit):
    """out = u*v:  out_k = u0*v_k + u_k*v0 + sum_{0<i<k} u_i v_{k-i}
    (reference Multiply, ``libsanm/oprs/elem_arith.cpp:181-208``)."""
    u, v = eqn.invars
    u_k, v_k = in_k
    if cache is None:
        cache = engine.conv(u, v, k)
    out = z_add(
        z_mul(engine.coeff0(u), v_k), z_mul(u_k, engine.coeff0(v)), cache
    )
    if out is not None and out.shape != eqn.outvars[0].aval.shape:
        out = jnp.broadcast_to(out, eqn.outvars[0].aval.shape)
    return [out], cache


register_rule(
    lax.mul_p,
    _mul_rule,
    lambda eqn, vy: (
        [vy(eqn.invars[1]), vy(eqn.invars[0])],
        [False],
    ),
)


def _div_rule(engine, eqn, idx, k, in_k, cache, commit):
    """out = u/v:  out_k = (u_k - out0*v_k - sum_{0<i<k} out_i v_{k-i})/v0.

    Derived from u = out*v (cf. the matinv recurrence of the reference,
    ``libsanm/oprs/linalg.cpp:146-197``, scalarized)."""
    u, v = eqn.invars
    w = eqn.outvars[0]
    u_k, v_k = in_k
    if cache is None:
        cache = engine.conv(w, v, k)
    num = z_add(u_k, z_neg(z_mul(engine.coeff0(w), v_k)), z_neg(cache))
    out = None if num is None else num / engine.coeff0(v)
    if out is not None and out.shape != w.aval.shape:
        out = jnp.broadcast_to(out, w.aval.shape)
    return [out], cache


register_rule(
    lax.div_p,
    _div_rule,
    # conv(out, v): both needed only when the denominator varies
    lambda eqn, vy: (
        [False, vy(eqn.invars[1])],
        [vy(eqn.invars[1])],
    ),
)


def _dot_general_rule(engine, eqn, idx, k, in_k, cache, commit):
    """Cauchy product of matrix products (reference BatchedMatMul bias,
    ``libsanm/oprs/linalg.cpp:24-62,382-409``)."""
    u, v = eqn.invars
    u_k, v_k = in_k
    bind = partial(lax.dot_general_p.bind, **eqn.params)
    if cache is None:
        terms = []
        if not (engine._series_const(u) or engine._series_const(v)):
            for i in range(1, k):
                ui = engine.coeff(u, i)
                vki = engine.coeff(v, k - i)
                if ui is not None and vki is not None:
                    terms.append(bind(ui, vki))
        cache = z_add(*terms)
    t1 = None if v_k is None else bind(engine.coeff0(u), v_k)
    t2 = None if u_k is None else bind(u_k, engine.coeff0(v))
    return [z_add(t1, t2, cache)], cache


register_rule(
    lax.dot_general_p,
    _dot_general_rule,
    lambda eqn, vy: (
        [vy(eqn.invars[1]), vy(eqn.invars[0])],
        [False],
    ),
)


# ----------------------------------------------------------------------------
# rules: analytic unary primitives
# ----------------------------------------------------------------------------


def _static_scalar(engine, var):
    """Extract a trace-time-constant scalar (Literal or closed-over
    const); required e.g. for the exponent of ``pow``."""
    if isinstance(var, jcore.Literal):
        return float(var.val)
    for cv, c in zip(engine.jaxpr.constvars, engine.tfn.consts):
        if cv is var:
            import numpy as _np

            return float(_np.asarray(c).reshape(()))
    raise SANMError("pow exponent must be a static constant")


def _pow_series_rule(engine, eqn, idx, k, in_k, cache, commit, p=None):
    """f = x**p (non-integer p allowed, x0 != 0):
    f_k = p*f0/x0 * x_k + (1/x0) sum_{0<i<k} ((i/k)(p+1) - 1) f_{k-i} x_i
    (reference PowImpl recurrence, ``libsanm/analytic_unary.cpp:133-137``).

    0**p with p not a non-negative integer has no Taylor series; the
    reference raises SANMNumericalError
    (``libsanm/analytic_unary.cpp:117-120``).  The same check runs here
    whenever x0 is concrete (the eager engine used by the property
    tests, and host-side evaluation); inside a jitted pass the division
    produces non-finite coefficients that the solver's isfinite gates
    catch — the error class is then reported at the solve level."""
    x = eqn.invars[0]
    if p is not None and not (float(p).is_integer() and p >= 0):
        _x0c = engine.coeff0(x)
        if not isinstance(_x0c, jax.core.Tracer):
            import numpy as _np

            if bool(_np.any(_np.asarray(_x0c) == 0.0)):
                raise SANMNumericalError(
                    "pow: zero base with non-integer exponent %r has no "
                    "Taylor expansion" % (p,)
                )
    f = eqn.outvars[0]
    x_k = in_k[0]
    x0 = engine.coeff0(x)
    f0 = engine.coeff0(f)
    if cache is None:
        terms = []
        if not engine._series_const(x):
            for i in range(1, k):
                fi = engine.coeff(f, k - i)
                xi = engine.coeff(x, i)
                t = z_mul(fi, xi)
                if t is not None:
                    terms.append(t * ((i / k) * (p + 1) - 1.0))
        s = z_add(*terms)
        cache = None if s is None else s / x0
    lin = None if x_k is None else (p * f0 / x0) * x_k
    return [z_add(lin, cache)], cache


def _make_pow_rule(get_p):
    def rule(engine, eqn, idx, k, in_k, cache, commit):
        p = get_p(engine, eqn)
        if float(p).is_integer() and p >= 0:
            # integral exponent: the convolution chain is valid at ANY
            # x0 including 0, where the analytic recurrence divides by
            # x0 (the reference's |x0|<1e-3 switch,
            # ``libsanm/analytic_unary.cpp:105-131``; unconditional
            # here — no data-dependent branching under jit)
            return _integer_pow_rule(
                engine, eqn, idx, k, in_k, cache, commit, n=int(p)
            )
        return _pow_series_rule(
            engine, eqn, idx, k, in_k, cache, commit, p=p
        )

    return rule


register_rule(
    lax.pow_p,
    _make_pow_rule(lambda eng, eqn: _static_scalar(eng, eqn.invars[1])),
    lambda eqn, vy: ([True, False], [vy(eqn.invars[0])]),
)
register_rule(
    lax.sqrt_p,
    _make_pow_rule(lambda eng, eqn: 0.5),
    lambda eqn, vy: ([True], [vy(eqn.invars[0])]),
)
register_rule(
    lax.rsqrt_p,
    _make_pow_rule(lambda eng, eqn: -0.5),
    lambda eqn, vy: ([True], [vy(eqn.invars[0])]),
)


def _log_rule(engine, eqn, idx, k, in_k, cache, commit):
    """f = log x: f_k = x_k/x0 - (1/x0) sum_{0<i<k} (i/k) f_i x_{k-i}
    (reference LogImpl, ``libsanm/analytic_unary.cpp:25-34``)."""
    x = eqn.invars[0]
    f = eqn.outvars[0]
    x_k = in_k[0]
    x0 = engine.coeff0(x)
    if cache is None:
        terms = []
        if not engine._series_const(x):
            for i in range(1, k):
                t = z_mul(engine.coeff(f, i), engine.coeff(x, k - i))
                if t is not None:
                    terms.append(t * (i / k))
        s = z_add(*terms)
        cache = None if s is None else -s / x0
    lin = None if x_k is None else x_k / x0
    return [z_add(lin, cache)], cache


register_rule(lax.log_p, _log_rule,
              lambda eqn, vy: ([True], [vy(eqn.invars[0])]))


def _exp_rule(engine, eqn, idx, k, in_k, cache, commit):
    """f = exp x: f_k = f0*x_k + sum_{0<i<k} (i/k) x_i f_{k-i}."""
    x = eqn.invars[0]
    f = eqn.outvars[0]
    x_k = in_k[0]
    f0 = engine.coeff0(f)
    if cache is None:
        terms = []
        if not engine._series_const(x):
            for i in range(1, k):
                t = z_mul(engine.coeff(x, i), engine.coeff(f, k - i))
                if t is not None:
                    terms.append(t * (i / k))
        cache = z_add(*terms)
    lin = None if x_k is None else f0 * x_k
    return [z_add(lin, cache)], cache


register_rule(lax.exp_p, _exp_rule,
              lambda eqn, vy: ([True], [vy(eqn.invars[0])]))


# ----------------------------------------------------------------------------
# integer_pow: always via series convolution with binary exponentiation —
# valid for any x0 including 0 (the reference switches to this path only
# when |x0|<1e-3, ``libsanm/analytic_unary.cpp:43-92,105-131``; doing it
# unconditionally avoids data-dependent branching under jit).
# ----------------------------------------------------------------------------


def _binary_chain(n):
    """Square-and-multiply chain computing x^n.

    Returns ``(chain, out_idx)`` where ``chain[i] = (ia, ib)`` means value
    ``V[i+1] = V[ia] * V[ib]`` with ``V[0] = x``; ``V[out_idx]`` is x^n.
    (Counterpart of the reference's binary-exponentiation convolution,
    ``libsanm/analytic_unary.cpp:46-92``.)"""
    assert n >= 2
    bits = []
    e = n
    while e:
        bits.append(e & 1)
        e >>= 1
    chain = []
    sq_idx = [0]  # V-index of x^(2^j)
    for _ in range(1, len(bits)):
        chain.append((sq_idx[-1], sq_idx[-1]))
        sq_idx.append(len(chain))
    acc = None
    for j, bit in enumerate(bits):
        if bit:
            if acc is None:
                acc = sq_idx[j]
            else:
                chain.append((acc, sq_idx[j]))
                acc = len(chain)
    # drop trailing unused squares (when the top bit product ends early —
    # cannot happen since the top bit is always set; acc is last)
    return chain, acc


def _integer_pow_rule(engine, eqn, idx, k, in_k, cache, commit, n=None):
    if n is None:
        n = eqn.params["y"]
    x = eqn.invars[0]
    x_k = in_k[0]
    x0 = engine.coeff0(x)

    if n == 1:
        return [x_k], cache
    if n == 0:
        return [None], cache
    if n < 0:
        # x^-m = 1/x^m — jnp only emits integer_pow for these via
        # reciprocal paths; handle via recurrence (requires x0 != 0).
        return _pow_series_rule(
            engine, eqn, idx, k, in_k, cache, commit, p=float(n)
        )

    chain, out_idx = _binary_chain(n)

    ud = engine.userdata.get(idx)
    if ud is None:
        # order-0 value of every chain entry
        vals0 = [x0]
        for (ia, ib) in chain:
            vals0.append(vals0[ia] * vals0[ib])
        ud = [[v] for v in vals0]
        engine.userdata[idx] = ud

    series = ud  # list over chain values of their coefficient lists

    def val_coeff(vi, i):
        if vi == 0:
            return engine.coeff(x, i) if i < k else None
        return series[vi][i] if i < len(series[vi]) else None

    if cache is None:
        # conv parts for each chain entry (orders 1..k-1 of both factors)
        cache = []
        for (ia, ib) in chain:
            terms = []
            for i in range(1, k):
                t = z_mul(val_coeff(ia, i), val_coeff(ib, k - i))
                if t is not None:
                    terms.append(t)
            cache.append(z_add(*terms))

    # propagate order-k through the chain, affine in x_k
    cur_k = [None] * (len(chain) + 1)
    cur_k[0] = x_k
    for ci, (ia, ib) in enumerate(chain):
        a0 = val_coeff(ia, 0)
        b0 = val_coeff(ib, 0)
        cur_k[ci + 1] = z_add(
            z_mul(a0, cur_k[ib]), z_mul(cur_k[ia], b0), cache[ci]
        )

    if commit:
        for vi in range(1, len(chain) + 1):
            assert len(series[vi]) == k
            series[vi].append(cur_k[vi])

    out = cur_k[out_idx]
    return [out], cache


def _integer_pow_hist_needs(eqn, is_varying):
    n = eqn.params["y"]
    # negative exponents use the analytic recurrence, which needs the
    # output series; positive ones keep their chain series in userdata.
    return [True], [n < 0 and is_varying(eqn.invars[0])]


register_rule(lax.integer_pow_p, _integer_pow_rule, _integer_pow_hist_needs)


# ----------------------------------------------------------------------------
# pure-NumPy forward evaluation of a TaylorFn
#
# Residual evaluations must be EXACT f64, independent of any backend's
# compile flags.  Interpreting the jaxpr with NumPy gives strict IEEE
# f64 with no XLA in the loop; one forward pass per continuation
# restart is host-cheap.
# ----------------------------------------------------------------------------


def _np_dot_general(a, b, dimension_numbers, **_):
    import numpy as np

    (lc, rc), (lb, rb) = dimension_numbers
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    a_spec = [None] * a.ndim
    b_spec = [None] * b.ndim
    out_batch = []
    out_a = []
    out_b = []
    for i, j in zip(lb, rb):
        ch = next(letters)
        a_spec[i] = ch
        b_spec[j] = ch
        out_batch.append(ch)
    for i, j in zip(lc, rc):
        ch = next(letters)
        a_spec[i] = ch
        b_spec[j] = ch
    for i in range(a.ndim):
        if a_spec[i] is None:
            a_spec[i] = next(letters)
            out_a.append(a_spec[i])
    for j in range(b.ndim):
        if b_spec[j] is None:
            b_spec[j] = next(letters)
            out_b.append(b_spec[j])
    spec = "%s,%s->%s" % (
        "".join(a_spec),
        "".join(b_spec),
        "".join(out_batch + out_a + out_b),
    )
    return np.einsum(spec, a, b)


def numpy_eval(tfn: TaylorFn):
    """Return a NumPy-exact forward evaluator for ``tfn``."""
    import numpy as np
    from jax import lax as _lx

    def _svd_w_np(m, require_rotation):
        from .ops.svd_w import GROUP_EPS

        u, s, vh = np.linalg.svd(m)
        if require_rotation:
            need = np.linalg.det(u) * np.linalg.det(
                np.swapaxes(vh, -1, -2)
            ) < 0
            # flip policy matching ops.svd_w (smallest group; odd groups
            # whole, else single)
            B, n = s.shape
            for bi in np.nonzero(need)[0]:
                sv = s[bi]
                best_i, best_nr = 0, n + 1
                i = 0
                # scan ALL groups; ties go to the later (smaller-value)
                # group — must match the device selection in
                # ops/svd_w.py exactly, since f(x) may read W directly
                while i < n:
                    j = i + 1
                    while j < n and sv[j - 1] - sv[j] < GROUP_EPS:
                        j += 1
                    nr = j - i
                    if nr <= best_nr or (
                        nr == best_nr + 1 and nr % 2 == 1
                    ):
                        best_i, best_nr = i, nr
                    i = j
                if best_nr == 1 or best_nr % 2 == 0:
                    sl = slice(best_i, best_i + 1)
                else:
                    sl = slice(best_i, best_i + best_nr)
                s[bi, sl] = -s[bi, sl]
                u[bi, :, sl] = -u[bi, :, sl]
        w = u @ vh
        return [u, s, w]

    def impl(eqn, invals):
        p = eqn.primitive
        prms = eqn.params
        if p is _lx.add_p:
            return invals[0] + invals[1]
        if p is _lx.sub_p:
            return invals[0] - invals[1]
        if p is _lx.mul_p:
            return invals[0] * invals[1]
        if p is _lx.div_p:
            return invals[0] / invals[1]
        if p is _lx.neg_p:
            return -invals[0]
        if p is _lx.integer_pow_p:
            return invals[0] ** prms["y"]
        if p is _lx.pow_p:
            return invals[0] ** invals[1]
        if p is _lx.log_p:
            return np.log(invals[0])
        if p is _lx.exp_p:
            return np.exp(invals[0])
        if p is _lx.sqrt_p:
            return np.sqrt(invals[0])
        if p is _lx.rsqrt_p:
            return 1.0 / np.sqrt(invals[0])
        if p is _lx.dot_general_p:
            return _np_dot_general(
                invals[0], invals[1], prms["dimension_numbers"]
            )
        if p is _lx.transpose_p:
            return np.transpose(invals[0], prms["permutation"])
        if p is _lx.reshape_p:
            return np.reshape(invals[0], prms["new_sizes"])
        if p is _lx.broadcast_in_dim_p:
            out = np.zeros(prms["shape"], invals[0].dtype)
            src = invals[0]
            expand = [
                i for i in range(len(prms["shape"]))
                if i not in prms["broadcast_dimensions"]
            ]
            s = np.expand_dims(src, tuple(expand)) if expand else src
            out[...] = s
            return out
        if p is _lx.squeeze_p:
            return np.squeeze(invals[0], axis=tuple(prms["dimensions"]))
        if p is _lx.reduce_sum_p:
            return np.sum(invals[0], axis=tuple(prms["axes"]))
        if p is _lx.concatenate_p:
            return np.concatenate(invals, axis=prms["dimension"])
        if p is _lx.slice_p:
            idx = tuple(
                slice(a, b, c)
                for a, b, c in zip(
                    prms["start_indices"], prms["limit_indices"],
                    prms["strides"] or [1] * len(prms["start_indices"]),
                )
            )
            return invals[0][idx]
        if p is _lx.convert_element_type_p:
            return invals[0].astype(prms["new_dtype"])
        if p is _lx.iota_p:
            dt = prms["dtype"]
            shape = prms["shape"]
            return np.broadcast_to(
                np.arange(shape[prms["dimension"]], dtype=dt).reshape(
                    [-1 if i == prms["dimension"] else 1
                     for i in range(len(shape))]
                ),
                shape,
            ).copy()
        if p is _lx.select_n_p:
            pred = invals[0]
            out = np.where(pred.astype(bool), invals[2], invals[1])
            return out
        if p.name == "sanm_svd_w":
            return _svd_w_np(invals[0], prms["require_rotation"])
        if p.name == "sanm_matinv":
            return np.linalg.inv(invals[0])
        if p.name == "sanm_det":
            return np.linalg.det(invals[0])
        for name, fn in [
            ("eq", np.equal), ("ne", np.not_equal), ("lt", np.less),
            ("le", np.less_equal), ("gt", np.greater),
            ("ge", np.greater_equal), ("and", np.logical_and),
            ("or", np.logical_or), ("not", np.logical_not),
            ("max", np.maximum), ("min", np.minimum),
            ("abs", np.abs), ("sign", np.sign),
        ]:
            if p.name == name:
                return fn(*invals)
        raise SANMError("numpy_eval: unsupported primitive %r" % p.name)

    consts = [
        __import__("numpy").asarray(c) for c in tfn.consts
    ]

    def run(*xs):
        import numpy as np

        env = {}
        for v, c in zip(tfn.jaxpr.constvars, consts):
            env[v] = c
        for v, x in zip(tfn.jaxpr.invars, xs):
            env[v] = np.asarray(x)

        def read(v):
            return (
                np.asarray(v.val) if isinstance(v, jcore.Literal) else env[v]
            )

        for idx, eqn, outs_used in tfn.live_eqns:
            invals = [read(v) for v in eqn.invars]
            out = impl(eqn, invals)
            outs = out if eqn.primitive.multiple_results else [out]
            for v, o in zip(eqn.outvars, outs):
                if not isinstance(v, jcore.DropVar):
                    env[v] = o
        outs = [read(v) for v in tfn.jaxpr.outvars]
        return outs[0] if len(outs) == 1 else tuple(outs)

    return run


# constant-producing primitives: value at order 0 (computed in start()),
# zero at every higher order
def _const_rule(engine, eqn, idx, k, in_k, cache, commit):
    return [None] * len(eqn.outvars), cache


register_rule(lax.iota_p, _const_rule)

# comparison / selection with *constant* predicate operands: these arise
# from jnp.where masks built out of constants (e.g. triu/eye patterns).
# They are piecewise-linear; we support them only when the predicate is
# order-0 constant (its higher-order coefficients are zero), which covers
# mask-style usage.


def _select_n_rule(engine, eqn, idx, k, in_k, cache, commit):
    pred = eqn.invars[0]
    if in_k[0] is not None:
        raise SANMError("select_n predicate must be order-0 constant")
    cases_k = [
        materialize(x, v.aval) if x is None else x
        for x, v in zip(in_k[1:], eqn.invars[1:])
    ]
    if all(x is None for x in in_k[1:]):
        return [None], cache
    out = lax.select_n(engine.coeff0(pred), *cases_k)
    return [out], cache


register_rule(lax.select_n_p, _select_n_rule)


def _cmp_rule(engine, eqn, idx, k, in_k, cache, commit):
    # comparisons feed boolean masks; their Taylor coefficients past
    # order 0 are zero (piecewise-constant).  Only valid when the inputs
    # do not cross the comparison boundary along the expansion path.
    return [None] * len(eqn.outvars), cache


for _p in [lax.eq_p, lax.ne_p, lax.lt_p, lax.le_p, lax.gt_p, lax.ge_p,
           lax.and_p, lax.or_p, lax.not_p]:
    register_rule(_p, _cmp_rule)

# abs / sign with constant-sign assumption are NOT registered: they are not
# analytic; models must avoid them on solver paths.
