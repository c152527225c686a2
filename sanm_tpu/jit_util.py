"""jit wrapper that hoists closed-over array constants out of the
compiled program.

``jax.jit`` embeds every array a traced function closes over as an XLA
constant.  The hybrid-mode solver functions close over the
``SparseAssembler``'s element-condensed remap matrices (``Lin``/``Lout``
and their index maps — ~40 MB at 42k tets), so each per-order
executable would carry its own copy of them: larger programs to
compile, serialize into the persistent compile cache and load back,
and one device copy per executable (the reference has no analog — its
remaps are host pointer walks, ``libsanm/anm.cpp:19-88``).

``jit_hoist_consts(fn)`` traces ``fn`` once per argument structure with
``jax.make_jaxpr``, converts the jaxpr's constvars into ordinary runtime
arguments, and caches the resulting (small) executable.  The constant
arrays are materialized in device memory once and passed by reference
on every call.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import tree_util

try:  # jax >= 0.4.24 keeps eval_jaxpr in jax.core
    from jax.core import eval_jaxpr
except ImportError:  # pragma: no cover
    from jax._src.core import eval_jaxpr


def _sig(args):
    leaves, treedef = tree_util.tree_flatten(args)
    avals = []
    for x in leaves:
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            avals.append(("a", tuple(x.shape), str(x.dtype)))
        else:
            # python scalars trace as weak-typed 0-d arrays; one entry
            # per python type matches jit's retrace behavior closely
            # enough for the solver's call sites (k is always int)
            avals.append(("s", type(x).__name__))
    return treedef, tuple(avals)


class _HoistedJit:
    def __init__(self, fn, donate_argnums=()):
        self._fn = fn
        self._donate = tuple(donate_argnums)
        self._cache = {}

    def __call__(self, *args):
        key = _sig(args)
        entry = self._cache.get(key)
        log = None
        if entry is None:
            import os
            import time as _time

            if os.environ.get("SANM_COMPILE_LOG"):
                log = [getattr(self._fn, "__name__", "<fn>"),
                       _time.perf_counter()]
            closed, out_shape = jax.make_jaxpr(
                self._fn, return_shape=True
            )(*args)
            jaxpr = closed.jaxpr
            consts = tuple(
                jnp.asarray(c) if hasattr(c, "shape") else c
                for c in closed.consts
            )
            n_args = len(tree_util.tree_leaves(args))

            def run(*flat_and_consts):
                flat = flat_and_consts[:n_args]
                cs = flat_and_consts[n_args:]
                return eval_jaxpr(jaxpr, list(cs), *flat)

            # jit donation is per top-level positional argument; expand
            # the user's argnums (over the original arg pytree) into the
            # flat leaf positions they occupy
            donate = []
            pos = 0
            spans = []
            for a in args:
                n = len(tree_util.tree_leaves(a))
                spans.append((pos, pos + n))
                pos += n
            for i in self._donate:
                lo, hi = spans[i]
                donate.extend(range(lo, hi))
            jitted = jax.jit(run, donate_argnums=tuple(donate))
            out_tree = tree_util.tree_structure(out_shape)
            avals = [
                jax.ShapeDtypeStruct(x.shape, x.dtype)
                if hasattr(x, "shape") else x
                for x in tree_util.tree_leaves(args)
            ]
            entry = (jitted, consts, out_tree, avals)
            self._cache[key] = entry
        jitted, consts, out_tree, _ = entry
        if log is not None:
            import sys
            import time as _time

            t_trace = _time.perf_counter()
            flat_out = jitted(*tree_util.tree_leaves(args), *consts)
            jax.block_until_ready(flat_out)
            t_done = _time.perf_counter()
            neqn = len(jaxpr.eqns)
            print(
                "[compile] %-18s trace=%6.2fs compile+run1=%7.2fs "
                "eqns=%d" % (log[0], t_trace - log[1], t_done - t_trace,
                             neqn),
                file=sys.stderr, flush=True,
            )
        else:
            flat_out = jitted(*tree_util.tree_leaves(args), *consts)
        return tree_util.tree_unflatten(out_tree, flat_out)

    def memory_analyses(self):
        """``compiled.memory_analysis()`` of every executable this
        wrapper has built, one per argument signature seen so far
        (lowers and compiles again; the persistent compile cache, when
        enabled, serves the executable)."""
        return [
            jitted.lower(*avals, *consts).compile().memory_analysis()
            for jitted, consts, _, avals in self._cache.values()
        ]


def jit_hoist_consts(fn=None, donate_argnums=()):
    """Drop-in ``jax.jit`` replacement that passes closed-over array
    constants as runtime arguments instead of baking them into the
    executable.  Positional args only (no kwargs); donation via
    ``donate_argnums`` refers to the wrapped function's arguments."""
    if fn is None:
        return partial(jit_hoist_consts, donate_argnums=donate_argnums)
    return _HoistedJit(fn, donate_argnums)
