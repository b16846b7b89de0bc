"""The program's own spans (``crnerf_tpu_torch/utils/tracing.py``) over the
calm stretch of a traced run, for the readers of ``metrics/``.

The run's process holds the spans' records. The window is the stretch
before the profiler starts, the one the host-time means of the run's data
cover: the root records (``train.step``; ``serve.request`` that rendered)
that closed before the first of the kind's spans opened while the profiler
recorded, the last ``pre_steps`` (train) or ``frames`` (serve) of them,
and the records of their ``rid`` in that time. ``window`` gives None, and so every reader,
where it cannot fill the window: another kind of run, a program without
the spans, no profiled stretch, too few roots, or a ring that dropped
records of the window.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# kind -> (root span, the data's count of window roots, the child a root
# must have, the spans read under the window's roots)
KINDS = {
    "train": ("train.step", "pre_steps", None,
              ("train.batch_wait", "train.batch_copy", "train.forward",
               "system.render", "train.backward", "train.update")),
    "serve": ("serve.request", "frames", "serve.render",
              ("serve.lock_wait", "serve.render", "render.dispatch",
               "serve.encode")),
}


class Window:
    """The records of one window, by span name."""

    def __init__(self, n: int, spans: Dict[str, List]):
        self.n = n              # the window's roots
        self.spans = spans      # name -> the window's records of it

    def mean_ms(self, name: str, own: bool = False) -> Optional[float]:
        """The records of ``name`` (their self time with ``own``) summed
        over the window, a root's share, in ms; None without one."""
        recs = self.spans[name]
        if not recs:
            return None
        ns = sum(r.self_ns if own else r.duration_ns for r in recs)
        return 1e-6 * ns / self.n

    def between_ms(self, name: str) -> Optional[float]:
        """The mean of max(0, next start - this end) over the window's
        records of ``name`` in the order they start, in ms."""
        recs = sorted(self.spans[name], key=lambda r: r.start_ns)
        if len(recs) < 2:
            return None
        gaps = [max(0, b.start_ns - a.end_ns) for a, b in zip(recs, recs[1:])]
        return 1e-6 * sum(gaps) / len(gaps)


def window(d: Dict, kind: str) -> Optional[Window]:
    if d.get("kind") != kind:
        return None
    try:
        from crnerf_tpu_torch.utils import tracing
    except ImportError:     # a program without the spans
        return None
    root, count, needs, names = KINDS[kind]
    n = d.get(count)
    if not n:
        return None
    roots = tracing.records(root)
    kept = {k: tracing.records(k) for k in names}
    # the stretch's first span: a served stretch may open no request (the
    # clients' window ends in it) but renders in it all the same
    profiled = [r.start_ns for recs in (roots, *kept.values())
                for r in recs if r.profiled]
    if not profiled:
        return None
    first = min(profiled)
    calm = [r for r in roots if not r.profiled and r.end_ns <= first]
    if needs is not None:
        did = {r.rid for r in kept[needs] if r.parent == root}
        calm = [r for r in calm if r.rid in did]
    if len(calm) < n:
        return None
    win = calm[-n:]
    start = min(r.start_ns for r in win)
    # the window's records start after the root before it ends (a batch's
    # wait and copy precede its step) and end by ``first``
    prev = calm[-n - 1].end_ns if len(calm) > n else None
    lo = start if prev is None else min(start, prev)
    rids = {r.rid for r in win}
    spans = {root: win}
    for k in names:
        # a ring drops the records that closed first: one kept that closed
        # by ``lo`` shows the window's whole
        if tracing.dropped(k) and (not kept[k] or kept[k][0].end_ns > lo):
            return None
        spans[k] = [r for r in kept[k] if r.rid in rids
                    and r.end_ns <= first
                    and (prev is None or lo <= r.start_ns)]
    return Window(n, spans)
