"""Runtime lock-order witness.

Counterpart of ``denormalized_tpu/common/lockwitness.py``, a standalone
copy for the port: it observes the REAL lock acquisition order at
runtime (the way TSan's deadlock detector or the kernel's lockdep do)
and reports any two code paths that take two lock classes in opposite
orders — a deadlock waiting for the right interleaving.

Mechanism
---------
:func:`install` replaces ``threading.Lock``/``threading.RLock`` with
factories that wrap locks **created by engine code** (caller filename
under ``denormalized_tpu_torch/``) in a recording proxy; everything else
(stdlib, torch, numpy) gets the real thing and zero overhead.  Like
lockdep, ordering is tracked per lock *class* — the creation site
``file:line`` — so two instances of ``PrefetchWorker._swap_lock`` are
one node and an ABBA between two *instances* of two classes is still
caught.

On every successful acquire, for each lock class already held by the
thread, the witness records the edge ``held -> acquired`` together with
both acquisition stacks.  If the REVERSE edge was ever observed (any
thread, any time earlier in the process), that is a lock-order
violation: two code paths disagree about the global order, which is a
deadlock waiting for the right interleaving.  The violation report
carries both conflicting edges WITH both sides' stacks — the two code
paths a human needs to look at, without having to reproduce the hang.

Intentional non-goals: same-class edges (a lock class nested inside
itself is recursion/reentrancy, not order); blocking-vs-try-lock
distinction (a ``timeout=`` acquire that succeeded still participates
in ordering); cross-thread hand-off of a
plain ``Lock`` (thread A acquires, thread B releases) — held lists are
thread-local, so a hand-off would strand A's entry and mint false edges.
The engine uses ``Semaphore`` for its hand-offs (prefetch slots), which
the witness deliberately does not wrap; if a Lock hand-off ever appears,
wrap that release in ``witness-exempt`` plumbing rather than teaching
the witness about ownership transfer.

Tests that *construct* inversions on purpose use an isolated
:class:`Witness` via :func:`scoped`; :func:`install` witnesses every
lock the port's code creates from then on.
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager

# the real factories, captured at import — install() swaps the public
# names, the witness itself must keep allocating raw locks
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_PKG_MARKER = os.sep + "denormalized_tpu_torch" + os.sep
_OWN_FILE = os.path.abspath(__file__)


def _caller_site(depth: int = 2) -> str | None:
    """``file:line`` of the frame that called the lock factory, or None
    when it isn't engine code (those locks stay unwrapped)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover — shallower stack than expected
        return None
    fname = frame.f_code.co_filename
    if os.path.abspath(fname) == _OWN_FILE:
        return None  # the witness's own bookkeeping lock
    if _PKG_MARKER not in fname:
        return None
    short = fname.split(_PKG_MARKER, 1)[-1]
    return f"denormalized_tpu_torch/{short}:{frame.f_lineno}"


def _stack(limit: int = 14) -> list[str]:
    """Compact acquisition stack with the witness's own frames dropped.

    A raw ``sys._getframe`` walk, NOT ``traceback.extract_stack``: the
    latter reads source lines through linecache, and this runs on EVERY
    witnessed acquire — the witness must observe the run, not tax it."""
    out: list[str] = []
    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover
        return out
    while f is not None and len(out) < limit:
        code = f.f_code
        if os.path.abspath(code.co_filename) != _OWN_FILE:
            out.append(f"{code.co_filename}:{f.f_lineno} in {code.co_name}")
        f = f.f_back
    out.reverse()
    return out


class Violation:
    """One observed order inversion: ``first`` saw a->b, ``second`` saw
    b->a.  Each side carries (thread name, stack-of-held, stack-of-new)."""

    def __init__(self, edge_ab, first, edge_ba, second):
        self.edge_first = edge_ab  # (site_a, site_b)
        self.first = first
        self.edge_second = edge_ba
        self.second = second

    def render(self) -> str:
        a, b = self.edge_first
        lines = [
            f"lock-order violation: {a} and {b} acquired in both orders",
            f"  order {a} -> {b} (thread {self.first[0]}):",
            f"    holding {a}, acquired at:",
        ]
        lines += [f"      {ln}" for ln in self.first[1][-6:]]
        lines += [f"    then took {b} at:"]
        lines += [f"      {ln}" for ln in self.first[2][-6:]]
        lines += [
            f"  order {b} -> {a} (thread {self.second[0]}):",
            f"    holding {b}, acquired at:",
        ]
        lines += [f"      {ln}" for ln in self.second[1][-6:]]
        lines += [f"    then took {a} at:"]
        lines += [f"      {ln}" for ln in self.second[2][-6:]]
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return f"<Violation {self.edge_first} vs {self.edge_second}>"


class Witness:
    """Edge store + violation log.  All mutation happens under a private
    RAW lock, taken only AFTER the target lock was acquired (and during
    release bookkeeping) — the witness can observe deadlocks, never cause
    them."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        #: (site_a, site_b) -> (thread_name, stack_of_a, stack_of_b) —
        #: the FIRST observation of each edge, kept as the evidence base
        self._edges: dict[tuple[str, str], tuple] = {}
        self._violations: list[Violation] = []
        self._tls = threading.local()

    # -- per-thread held list -------------------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- recording -------------------------------------------------------
    def note_acquire(self, site: str) -> None:
        held = self._held()
        new_stack = _stack()
        tname = threading.current_thread().name
        with self._mu:
            for held_site, held_stack in held:
                if held_site == site:
                    continue  # reentrancy/same-class: not an order fact
                edge = (held_site, site)
                rev = (site, held_site)
                if rev in self._edges:
                    self._violations.append(Violation(
                        rev, self._edges[rev],
                        edge, (tname, held_stack, new_stack),
                    ))
                if edge not in self._edges:
                    self._edges[edge] = (tname, held_stack, new_stack)
        held.append((site, new_stack))

    def note_release(self, site: str) -> None:
        held = self._held()
        # release the most recent matching entry (RLock-style nesting)
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == site:
                del held[i]
                return

    # -- reporting -------------------------------------------------------
    def violations(self) -> list[Violation]:
        with self._mu:
            return list(self._violations)

    def edges(self) -> dict[tuple[str, str], tuple]:
        with self._mu:
            return dict(self._edges)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._violations.clear()


class WitnessedLock:
    """Recording proxy around a real lock.  Supports the full
    Lock/RLock surface the engine (and stdlib helpers like Condition)
    use: acquire/release, context manager, locked()."""

    __slots__ = ("_inner", "_site", "_witness")

    def __init__(self, inner, site: str, witness: Witness):
        self._inner = inner
        self._site = site
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.note_acquire(self._site)
        return got

    def release(self) -> None:
        self._inner.release()
        self._witness.note_release(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str):
        # threading.Condition probes _is_owned/_release_save/
        # _acquire_restore via try/except AttributeError to pick the
        # RLock-aware fast path; forward them only when the inner lock
        # really has them (RLock), so a plain Lock keeps Condition's
        # generic fallback.  wait() releasing through _release_save skips
        # witness bookkeeping on purpose: the waiting thread is parked
        # and cannot acquire anything until _acquire_restore returns, so
        # its held entry stays truthful for edge recording.
        if name in ("_is_owned", "_release_save", "_acquire_restore"):
            return getattr(self._inner, name)
        raise AttributeError(name)

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return f"<WitnessedLock {self._site} {self._inner!r}>"


# -- global install ---------------------------------------------------------

_GLOBAL = Witness()
_installed = False
_replaced = (_REAL_LOCK, _REAL_RLOCK)  # what install() patched over


def witness() -> Witness:
    """The process-global witness."""
    return _GLOBAL


def _make_factory(real, kind: str):
    def factory():
        site = _caller_site()
        inner = real()
        if site is None:
            return inner
        return WitnessedLock(inner, f"{site} ({kind})", _current())

    factory.__name__ = f"witnessed_{kind.lower()}"
    return factory


# scoped() routing is THREAD-LOCAL: only locks the scoping thread itself
# creates bind the scoped witness.  A background engine thread that
# happens to create a lock while some test is inside a scope must keep
# binding the global witness — otherwise that lock class would report
# into a discarded Witness for the rest of the process and the global
# record would go blind to it.
_TLS_ACTIVE = threading.local()


def _current() -> Witness:
    return getattr(_TLS_ACTIVE, "w", None) or _GLOBAL


def install() -> None:
    """Patch the ``threading`` lock factories (idempotent).  Only locks
    subsequently CREATED by engine code are witnessed — module-level
    engine locks are covered when this runs before the engine
    imports."""
    global _installed, _replaced
    if _installed:
        return
    _installed = True
    _replaced = (threading.Lock, threading.RLock)
    threading.Lock = _make_factory(_REAL_LOCK, "Lock")
    threading.RLock = _make_factory(_REAL_RLOCK, "RLock")


def uninstall() -> None:
    """Put back the factories ``install`` replaced: another witness (the
    JAX package's, in a shared test process) may have patched them after
    this module was imported."""
    global _installed
    if not _installed:
        return
    _installed = False
    threading.Lock, threading.RLock = _replaced


@contextmanager
def scoped():
    """Route THIS THREAD's lock creations into a fresh, isolated
    :class:`Witness` — for tests that build deliberate inversions
    without dirtying the global record.  Locks created by other threads
    (or before the scope) keep reporting to whichever witness they bound
    at creation; per-witness held lists are disjoint, so records stay
    coherent."""
    prev = getattr(_TLS_ACTIVE, "w", None)
    w = Witness()
    _TLS_ACTIVE.w = w
    try:
        yield w
    finally:
        _TLS_ACTIVE.w = prev
