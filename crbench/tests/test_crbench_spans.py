"""The readers of the program's spans (``crbench/spans.py``): traced tiny
cells on the CPU give every such metric of the cell a finite number, the
training cell's phases of a step add up to the calm window's step time,
and a run without a profiled stretch, or of the other kind, gives none."""

import contextlib
import math
import tempfile
import time

import pytest
import torch

from tinycell import tiny_cell

from crbench import run, spans
from crbench.traffic import trainer

SPAN_METRICS = [m for m in run.benchmark()["per_layer"]
                if m["source"] == "program_span"
                and m["name"] != "serve.render_ms"]
TRAIN_PHASES = ("train.batch_wait_ms", "train.batch_copy_ms",
                "train.nets_host_ms", "train.render_host_ms",
                "train.backward_host_ms", "train.update_host_ms")


@pytest.fixture
def fresh_records():
    from crnerf_tpu_torch.utils import tracing

    tracing.reset()
    yield
    tracing.reset()


def run_cell(cell, wl, cfg, seconds):
    """A traced run of a tiny cell's ``wl`` and ``cfg`` on the CPU, on one
    thread (a step on threads that share their cores with other processes
    can take longer than the window) -> its per-layer metrics."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            return run.run_cell(
                cell, wl, cfg, 1234567890123, seconds, True,
                torch.device("cpu"),
                run.metrics_for(run.benchmark(), cell, True), tmp,
                time.perf_counter())["result"]["metrics"]
    finally:
        torch.set_num_threads(threads)


def names_for(cell):
    return {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}


def test_every_span_metric_is_listed_with_its_cells():
    assert len(SPAN_METRICS) == 11
    assert names_for("train_stash_g1") == set(TRAIN_PHASES)
    assert names_for("serve_320x240_c4") == names_for("serve_320x240_c1")
    assert len(names_for("serve_320x240_c1")) == 5


def test_traced_tiny_train_cell_splits_its_step(fresh_records,
                                                monkeypatch):
    torch.manual_seed(0)
    seen = {}
    drive = trainer.run

    def keep(r):
        out = drive(r)
        seen.update(out["data"])
        return out

    monkeypatch.setattr(trainer, "run", keep)
    # the stretch from the window's second step or so, and a window longer
    # than a step of a loaded machine, so that it opens inside the window
    wl, cfg = tiny_cell("train_stash_g1")
    wl.update(trace_from=0.02, trace_steps=5)
    got = run_cell("train_stash_g1", wl, cfg, 8.0)
    diag = {k: v for k, v in seen.items()
            if k in ("steps", "window_s", "pre_steps", "pre_s",
                     "stretch_steps")}
    for name in TRAIN_PHASES:
        assert name in got, (name, diag)
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    step_ms = 1e3 * seen["pre_s"] / seen["pre_steps"]
    total = sum(got[n]["value"] for n in TRAIN_PHASES)
    assert abs(total - step_ms) <= 0.25 * step_ms, (total, step_ms)
    assert got["train.nets_host_ms"]["value"] > 0
    assert got["train.render_host_ms"]["value"] > 0
    # the same data read as the serving kind, or with no stretch: nothing
    assert spans.window({**seen, "kind": "serve"}, "serve") is None
    assert spans.window(seen, "serve") is None
    assert spans.window({**seen, "pre_steps": 10 ** 6}, "train") is None


def test_traced_tiny_serve_cell_reads_every_phase(fresh_records):
    torch.manual_seed(0)
    wl, cfg = tiny_cell("serve_320x240_c4")
    wl["trace_seconds"] = 2.0     # a render or two of a loaded machine
    got = run_cell("serve_320x240_c4", wl, cfg, 8.0)
    for name in names_for("serve_320x240_c4"):
        assert name in got, name
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    assert got["serve.lock_wait_ms"]["value"] > 0   # four clients, one lock


class Clock:
    """A stand-in for the time module: time_ns reads ``now``, in ms."""

    def __init__(self):
        self.now = 0

    def time_ns(self):
        return self.now * 1_000_000


@pytest.fixture
def fake(fresh_records, monkeypatch):
    """The spans on a clock the test moves, and a switch for whether a
    profiler records."""
    from crnerf_tpu_torch.utils import tracing

    clock = Clock()
    monkeypatch.setattr(tracing, "time", clock)
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: contextlib.nullcontext())

    def profiling(on):
        monkeypatch.setattr(tracing._autograd_profiler,
                            "_is_profiler_enabled", on)

    return tracing, clock, profiling


def phase(tracing, clock, name, ms, rid=None):
    with tracing.span(name, rid=rid):
        clock.now += ms


def fake_steps(tracing, clock, profiling, n, n_calm):
    """Step i waits 1 ms and copies 2, then a step of a 3 + 4 ms forward
    (4 of it the renderer), a 5 ms backward and a 6 ms update, 1 ms of its
    own; the steps from ``n_calm`` on open while a profiler records."""
    for i in range(n):
        profiling(i >= n_calm)
        phase(tracing, clock, "train.batch_wait", 1, rid=i)
        phase(tracing, clock, "train.batch_copy", 2, rid=i)
        with tracing.span("train.step", rid=i):
            clock.now += 1
            with tracing.span("train.forward"):
                clock.now += 3
                phase(tracing, clock, "system.render", 4)
            phase(tracing, clock, "train.backward", 5)
            phase(tracing, clock, "train.update", 6)
    profiling(False)


def test_train_window_is_the_calm_stretch(fake):
    tracing, clock, profiling = fake
    fake_steps(tracing, clock, profiling, 8, 5)
    w = spans.window({"kind": "train", "pre_steps": 3}, "train")
    assert [r.rid for r in w.spans["train.step"]] == [2, 3, 4]
    assert [w.mean_ms(n) for n in ("train.batch_wait", "train.batch_copy",
                                   "system.render", "train.backward",
                                   "train.update")] == [1, 2, 4, 5, 6]
    assert w.mean_ms("train.forward", own=True) == 3
    # the six phases: the step time less the step's own 1 ms
    assert 1 + 2 + 3 + 4 + 5 + 6 == 22 - 1
    assert spans.window({"kind": "train", "pre_steps": 6}, "train") is None
    assert spans.window({"kind": "train", "pre_steps": 3}, "serve") is None


def test_no_stretch_or_dropped_records_read_nothing(fake, monkeypatch):
    tracing, clock, profiling = fake
    fake_steps(tracing, clock, profiling, 5, 5)     # nothing profiled
    assert spans.window({"kind": "train", "pre_steps": 3}, "train") is None
    tracing.reset()
    monkeypatch.setattr(tracing, "RING", 5)
    fake_steps(tracing, clock, profiling, 8, 5)
    assert tracing.dropped("train.batch_wait") == 3
    # the rings hold steps 3-7: step 4 alone is read whole (step 3's
    # records, closed before it, are kept); with step 3, whose own records
    # are the oldest kept, nothing shows that none of them was dropped;
    # step 2's were
    w = spans.window({"kind": "train", "pre_steps": 1}, "train")
    assert [r.rid for r in w.spans["train.step"]] == [4]
    assert w.mean_ms("train.batch_wait") == 1
    assert w.mean_ms("train.forward", own=True) == 3
    assert spans.window({"kind": "train", "pre_steps": 2}, "train") is None
    assert spans.window({"kind": "train", "pre_steps": 3}, "train") is None


def test_serve_window_and_the_gaps_between_renders(fake):
    tracing, clock, profiling = fake
    for i in range(6):
        profiling(i >= 4)
        with tracing.span("serve.request", rid=i):
            clock.now += 1
            if i != 2:          # a request that renders nothing
                phase(tracing, clock, "serve.lock_wait", 2)
                with tracing.span("serve.render"):
                    clock.now += 1
                    phase(tracing, clock, "render.dispatch", 3)
                    clock.now += 10
                phase(tracing, clock, "serve.encode", 4)
        clock.now += 5          # the reply's trip and the next request's
    profiling(False)
    w = spans.window({"kind": "serve", "frames": 2}, "serve")
    assert [r.rid for r in w.spans["serve.request"]] == [1, 3]
    assert [w.mean_ms(n) for n in ("serve.lock_wait", "render.dispatch",
                                   "serve.encode")] == [2, 3, 4]
    assert w.mean_ms("serve.request", own=True) == 1
    # render 1 ends at 43 ms, request 2 (no render) runs from 52 to 53,
    # render 3 starts at 61: 18 ms between them
    assert w.between_ms("serve.render") == 18
    assert spans.window({"kind": "serve", "frames": 4}, "serve") is None
