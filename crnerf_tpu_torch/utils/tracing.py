"""The port's spans and counters: what the program records of its own work,
on the clock of ``torch.profiler``'s host events.

A span is a named stretch of host time on one thread::

    with tracing.span("serve.request", rid=n) as rec:
        ...
    rec.ms    # its duration, once closed

Spans nest on a thread-local stack: a span opened inside another is its
child, takes its ``rid`` (the step or request the work belongs to) unless
given one, and its duration is subtracted from the parent's self time.
A closed span is a ``Record`` in a ring of ``RING`` records kept per name,
the oldest dropped first and counted (``dropped``), so that a server that
runs for weeks holds the same memory. Recording is always on: two clock
reads and an append.

Times are ``time.time_ns()``, the clock the profiler stamps host events
with, so a record lines up with the trace of the same stretch. While a
profiler records (``torch.autograd.profiler._is_profiler_enabled``), a
span also enters ``torch.profiler.record_function(name)``: the phase
appears by name in the Chrome trace of ``Config.profile`` and in any
other profiled stretch. With no profiler running, ``record_function`` is
never entered (it costs ~10 us a use even then).

Counters are plain dicts of ints that their module increments in place
(the ops modules' ``LAUNCH_COUNTS``), registered here once with
``register`` and read together by ``counters()``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

RING = 4096     # records kept per span name

_lock = threading.Lock()
_rings: Dict[str, Deque["Record"]] = {}
_dropped: Dict[str, int] = {}
_counters: List[Dict[str, int]] = []
_local = threading.local()


class Record:
    """One closed span. ``parent``: the name of the span it was opened in
    on the same thread, or None; ``thread``: ``threading.get_ident()``;
    ``start_ns``, ``end_ns``: ``time.time_ns()``; ``self_ns``: the
    duration less what its children cover; ``profiled``: whether a
    profiler was recording when it opened."""

    __slots__ = ("name", "rid", "parent", "thread", "start_ns", "end_ns",
                 "self_ns", "profiled", "_child_ns")

    def __init__(self, name: str, rid, parent: Optional[str],
                 profiled: bool):
        self.name, self.rid, self.parent = name, rid, parent
        self.thread = threading.get_ident()
        self.profiled = profiled
        self.start_ns = self.end_ns = self.self_ns = self._child_ns = 0

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self):
        return (f"Record({self.name!r}, rid={self.rid!r}, "
                f"parent={self.parent!r}, ms={self.ms:.3f})")


def _stack() -> List[Record]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """Record the ``with`` block as a span named ``name`` (see the module's
    docstring). ``rid``: the step or request it belongs to; inherited from
    the open parent when None. ``__enter__`` returns the ``Record``, whose
    times are set when the block ends."""

    __slots__ = ("name", "rid", "rec", "_rf")

    def __init__(self, name: str, rid=None):
        self.name, self.rid = name, rid

    def __enter__(self) -> Record:
        stack = _stack()
        parent = stack[-1] if stack else None
        rid = self.rid
        if rid is None and parent is not None:
            rid = parent.rid
        profiled = _autograd_profiler._is_profiler_enabled
        rec = Record(self.name, rid,
                     parent.name if parent is not None else None, profiled)
        self.rec = rec
        stack.append(rec)
        # read before the profiler's event opens: on a process's first use,
        # entering it runs ~1 ms past the start it stamps
        rec.start_ns = time.time_ns()
        if profiled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        d = rec.end_ns - rec.start_ns
        rec.self_ns = d - rec._child_ns
        if stack:
            stack[-1]._child_ns += d
        with _lock:
            ring = _rings.get(rec.name)
            if ring is None:
                ring = _rings[rec.name] = collections.deque(maxlen=RING)
                _dropped[rec.name] = 0
            elif len(ring) == RING:
                _dropped[rec.name] += 1
            ring.append(rec)
        return False


def records(name: str) -> List[Record]:
    """The kept records of span ``name``, in the order they closed."""
    with _lock:
        return list(_rings.get(name, ()))


def dropped(name: str) -> int:
    """How many records of ``name`` the ring has dropped."""
    with _lock:
        return _dropped.get(name, 0)


def register(counts: Dict[str, int]) -> Dict[str, int]:
    """Register a module's counter dict (its keys unique across every
    registered dict) and return it; the module increments it in place."""
    with _lock:
        for other in _counters:
            same = set(other) & set(counts)
            if same:
                raise ValueError(f"counter keys registered twice: {same}")
        _counters.append(counts)
    return counts


def counters() -> Dict[str, int]:
    """Every registered counter, by key."""
    with _lock:
        return {k: v for d in _counters for k, v in d.items()}


def reset() -> None:
    """Forget every record and the dropped counts (tests)."""
    with _lock:
        _rings.clear()
        _dropped.clear()
