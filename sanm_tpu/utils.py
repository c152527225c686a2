"""Base utilities: errors, timing, hierarchical profiler, RNG.

Counterpart of reference ``libsanm/utils.{h,cpp}`` (the
``sanm_assert`` exception hierarchy, ``Timer``, ``ScopedProfiler``,
``Xorshift128pRng``) and ``libsanm/stl.h``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field


class SANMError(RuntimeError):
    """Base error (reference ``libsanm/utils.h:19-50``)."""


class SANMAssertionError(SANMError):
    pass


class SANMNumericalError(SANMError):
    """Numerical failure, e.g. 0**p for non-integer p or a failed
    solution check (reference ``libsanm/utils.h:43-50``)."""


def sanm_assert(cond, msg: str = "", *fmt) -> None:
    if not cond:
        raise SANMAssertionError(msg % fmt if fmt else msg)


def verbose_mode() -> bool:
    """Reference env toggle ``SANM_VERBOSE`` (``libsanm/anm.cpp:314-317``)."""
    return os.environ.get("SANM_VERBOSE") is not None


class Timer:
    """Wall-clock timer (reference ``libsanm/utils.h:186-217``)."""

    def __init__(self):
        self._start = None
        self._accum = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> "Timer":
        if self._start is not None:
            self._accum += time.perf_counter() - self._start
            self._start = None
        return self

    def reset(self) -> "Timer":
        self._start = None
        self._accum = 0.0
        return self

    def time(self) -> float:
        extra = 0.0
        if self._start is not None:
            extra = time.perf_counter() - self._start
        return self._accum + extra


@dataclass
class _ProfNode:
    name: str
    nr_call: int = 0
    tot: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    children: dict = field(default_factory=dict)

    def child(self, name: str) -> "_ProfNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = _ProfNode(name)
        return node


class ScopedProfiler:
    """Hierarchical profiler with per-thread call stacks.

    Counterpart of the reference ``ScopedProfiler``
    (``libsanm/utils.h:225-249``, ``libsanm/utils.cpp:81-243``): tags form
    a tree keyed by the enclosing scopes; stats {nr_call, min, max, tot}
    per node are printed as an indented tree.  The reference prints at
    process exit; here call :meth:`report` (the FEA CLI does so when
    ``SANM_PROFILE`` is set).  Device work is asynchronous under JAX, so
    scopes that must measure device time should pass ``block=True`` to
    synchronize on scope exit.
    """

    _tls = threading.local()
    _root = _ProfNode("<root>")
    _lock = threading.Lock()
    enabled = os.environ.get("SANM_PROFILE") is not None

    @classmethod
    def _stack(cls):
        if not hasattr(cls._tls, "stack"):
            cls._tls.stack = [cls._root]
        return cls._tls.stack

    def __init__(self, name: str, block: bool = False):
        self.name = name
        self.block = block

    def __enter__(self):
        if not self.enabled:
            return self
        stack = self._stack()
        self._node = stack[-1].child(self.name)
        stack.append(self._node)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        if self.block:
            import jax
            import jax.numpy as jnp

            jax.effects_barrier()
            # effects_barrier only drains host callbacks; enqueue a
            # trivial computation and wait on it so asynchronously
            # dispatched device work is attributed to THIS scope rather
            # than whichever scope first touches its results
            (jnp.zeros(()) + 0.0).block_until_ready()
        dt = time.perf_counter() - self._t0
        node = self._node
        with self._lock:
            node.nr_call += 1
            node.tot += dt
            node.tmin = min(node.tmin, dt)
            node.tmax = max(node.tmax, dt)
        self._stack().pop()
        return False

    @classmethod
    def report(cls, file=None) -> str:
        lines = []

        def walk(node: _ProfNode, depth: int):
            if depth >= 0 and node.nr_call:
                lines.append(
                    "%s%s: calls=%d tot=%.4fs min=%.4fs max=%.4fs avg=%.4fs"
                    % (
                        "  " * depth,
                        node.name,
                        node.nr_call,
                        node.tot,
                        node.tmin,
                        node.tmax,
                        node.tot / node.nr_call,
                    )
                )
            for c in node.children.values():
                walk(c, depth + 1)

        walk(cls._root, -1)
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text

    @classmethod
    def get(cls, *path) -> float:
        """Total seconds accumulated under a tag path (first match by name
        walk); 0.0 if absent.  Used for the stat-JSON sparse-solver share
        (reference ``render/gen_table_figs.py:328-339``)."""
        node = cls._root
        for name in path:
            found = None

            def search(n):
                nonlocal found
                if name in n.children and found is None:
                    found = n.children[name]
                for c in n.children.values():
                    if found is None:
                        search(c)

            search(node)
            if found is None:
                return 0.0
            node = found
        return node.tot

    @classmethod
    def total(cls, name) -> float:
        """Sum of ``tot`` over EVERY node named ``name`` anywhere in the
        tree (unlike :meth:`get`, which stops at the first match).  Used
        to measure per-phase deltas, e.g. the warm-solve sparse share."""
        acc = [0.0]

        def walk(n):
            for c in n.children.values():
                if c.name == name:
                    acc[0] += c.tot
                walk(c)

        walk(cls._root)
        return acc[0]

    @classmethod
    def stats(cls, name):
        """(calls, total_seconds) summed over every node named ``name``
        (the counting companion of :meth:`total`)."""
        acc = [0, 0.0]

        def walk(n):
            for c in n.children.values():
                if c.name == name:
                    acc[0] += c.nr_call
                    acc[1] += c.tot
                walk(c)

        walk(cls._root)
        return acc[0], acc[1]

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._root = _ProfNode("<root>")
        cls._tls = threading.local()


@contextlib.contextmanager
def profiled(name: str, block: bool = False):
    with ScopedProfiler(name, block=block):
        yield


class Xorshift128pRng:
    """xorshift128+ RNG (reference ``libsanm/utils.h:252-275``), used for
    deterministic test tensors independent of JAX PRNG details."""

    def __init__(self, seed: int = 42):
        # splitmix64 seeding
        s = seed & 0xFFFFFFFFFFFFFFFF
        st = []
        for _ in range(2):
            s = (s + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
            z = s
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
            st.append(z ^ (z >> 31))
        self._s = st

    def next_u64(self) -> int:
        s0, s1 = self._s
        x = s0
        y = s1
        self._s[0] = y
        x ^= (x << 23) & 0xFFFFFFFFFFFFFFFF
        self._s[1] = x ^ y ^ (x >> 17) ^ (y >> 26)
        return (self._s[1] + y) & 0xFFFFFFFFFFFFFFFF

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return lo + (hi - lo) * (self.next_u64() >> 11) / float(1 << 53)


# ---------------------------------------------------------------------------
# hot-loop discipline tripwires.  The reference forbids Eigen heap
# allocation globally and re-enables it only in scoped regions
# (EIGEN_RUNTIME_NO_MALLOC + ScopedAllowMalloc,
# libsanm/tensor_impl_helper.h:12,45-64) — an allocation-in-hot-loop
# tripwire.  Under XLA the analogous silent hot-loop bugs are (a) an
# unintended *recompile* per call (shape/dtype/static-arg drift) and
# (b) an unintended host<->device transfer; the guards below trip on
# exactly those.  (b) is jax's own transfer_guard; (a) counts backend
# compile events via jax.monitoring.
# ---------------------------------------------------------------------------
# [compiles, compile seconds summed over threads, listener attached]
_compile_count = [0, 0.0, False]


def _ensure_compile_listener():
    if _compile_count[2]:
        return
    import jax.monitoring as mon

    def _on_dur(name, dur, **kw):
        if name == "/jax/core/compile/backend_compile_duration":
            _compile_count[0] += 1
            _compile_count[1] += dur

    mon.register_event_duration_secs_listener(_on_dur)
    _compile_count[2] = True


def compile_count() -> int:
    """Number of XLA backend compilations observed so far (process-wide;
    the listener attaches on first use)."""
    _ensure_compile_listener()
    return _compile_count[0]


def compile_seconds() -> float:
    """XLA backend-compile seconds observed so far, summed over threads
    (process-wide; the listener attaches on first use)."""
    _ensure_compile_listener()
    return _compile_count[1]


class compile_guard:
    """``with compile_guard():`` asserts that no new XLA compilation
    happens inside the scope — the warm-path discipline check: a warm
    re-solve that silently retraces is the XLA analog of the
    reference's allocation-in-hot-loop bug.  ``allow=k`` tolerates k
    compiles (e.g. a first-call site known to compile lazily).
    Enforcement raises :class:`SANMError`; set ``warn_only=True`` to
    print instead (the ``SANM_COMPILE_GUARD=warn`` harness mode)."""

    def __init__(self, allow: int = 0, warn_only: bool = False,
                 tag: str = ""):
        self.allow = int(allow)
        self.warn_only = bool(warn_only)
        self.tag = tag

    def __enter__(self):
        _ensure_compile_listener()
        self._start = _compile_count[0]
        return self

    def seen(self) -> int:
        return _compile_count[0] - self._start

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        n = self.seen()
        if n > self.allow:
            msg = (
                "compile_guard%s: %d XLA compilation(s) inside a "
                "no-compile scope (allowed %d) — a hot loop is "
                "silently retracing"
                % (" [%s]" % self.tag if self.tag else "", n, self.allow)
            )
            if self.warn_only:
                print("WARNING:", msg)
            else:
                raise SANMError(msg)
        return False
