"""What every cell shares: the run's settings, the card's checks, the
profiler stretch and its reading, the comparison record and the result
line."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "crnerf_tpu")
ROOT = os.path.dirname(os.path.abspath(__file__))


class BenchError(RuntimeError):
    """A run that cannot give a result: no card, too few cards, a
    forbidden module loaded."""


@dataclasses.dataclass
class Run:
    """One run of one cell."""
    name: str
    workload: Dict
    config: Dict          # the configuration file
    seed: int
    seconds: float
    trace: bool
    device: object        # torch.device
    t_process: float      # perf_counter at the start of the process
    tmp: str              # a scratch directory under TMPDIR

    @property
    def fields(self) -> Dict:
        """The Config fields of the cell: the configuration's, then the
        workload's runtime fields over them."""
        return {**self.config["fields"], **self.workload.get("runtime", {})}


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    where: str = ""       # what the value was read at (a leaf, a frame)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def load_json(*parts: str) -> Dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def forbidden_loaded() -> List[str]:
    """Modules of ``sys.modules`` whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def require_cards(n: int):
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the port "
                         "on an NVIDIA GPU and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise BenchError(f"the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``q`` percent of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


# ------------------------------------------------------------- profiler
class Stretch:
    """A ``torch.profiler`` window over part of a run, opened and closed in
    the thread that launches the work: the profiler keeps the device
    events (kernels, copies, fills) of that thread's launches, and its
    host operations and the benchmark's spans."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> "TraceSummary":
        return TraceSummary.of(self.prof, self.t1 - self.t0)


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_device_events: int
    kernels: Dict[str, List[float]]     # name -> [count, seconds]
    gaps: List[Tuple[str, float]]       # (what the host did, seconds)

    @classmethod
    def of(cls, prof, window_s: float) -> "TraceSummary":
        """From the profiler's raw events: the device's (kernels, copies
        and fills; the spans that annotate device time are left out) and
        the host's."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns() * 1e-9
            tr = (a, a + e.duration_ns() * 1e-9)
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((tr, e.name()))
            else:
                host.append((tr, e.name()))
        kernels: Dict[str, List[float]] = {}
        for (a, b), name in dev:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += b - a
        busy = _merge([tr for tr, _ in dev])
        busy_s = min(window_s, sum(b - a for a, b in busy))
        first = {}
        for (s, _), n in dev:   # the device op that starts at each time
            first.setdefault(s, n)
        longest = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _)
                          in zip(busy, busy[1:])), reverse=True)[:10]
        gaps = []
        for length, a1, b0 in longest:
            # the innermost host operation open at the gap's middle, and
            # the device operation that ends the gap
            mid = 0.5 * (a1 + b0)
            inner = [(s, n) for (s, e), n in host if s <= mid <= e]
            what = max(inner)[1] if inner else "no host op recorded"
            gaps.append((f"host in {what}; then {first.get(b0, '')[:80]}",
                         length))
        return cls(window_s, busy_s, len(dev), kernels, gaps)

    def time_of(self, names) -> float:
        """Seconds of the device events whose names contain one of
        ``names``."""
        return sum(s for n, (_, s) in self.kernels.items()
                   if any(k in n for k in names))

    def count_of(self, names) -> int:
        return sum(c for n, (c, _) in self.kernels.items()
                   if any(k in n for k in names))

    def breakdown(self) -> Dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[n[:160], s] for n, (_, s) in top],
                "idle_gaps": [[n[:160], s] for n, s in self.gaps[:10]]}


# --------------------------------------------------------------- output
def emit(result: Dict, checks: List[Check]):
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    the numbers again under ``checks``, its last key."""
    for c in checks:
        at = f" at {c.where}" if c.where else ""
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}){at} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(json.dumps(result), flush=True)
