"""The port's spans and counters (``crnerf_tpu_torch/utils/tracing.py``) on
the CPU: nesting, ``rid`` inheritance, self time and one stack per thread;
the rings' bound and dropped count; the records on the profiler's clock and
``record_function`` entered only while a profiler records; the spans of a
Trainer's steps (and their names in ``Config.profile``'s Chrome trace) and
of a render over a loopback server, whose reply's ``ms`` is its
``serve.render`` record; the server's ``stats`` from those records; and
every ops module's ``LAUNCH_COUNTS`` in ``tracing.counters()``."""

import base64
import json
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crnerf_tpu_torch import Config
from crnerf_tpu_torch.apps.serve import RenderService, Server, request, warmup
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.ops import (
    composite,
    conv,
    fused_mlp,
    fused_render,
    pipe_render,
    sincos,
    sublane_stores,
)
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.utils import tracing

torch.set_num_threads(2)

STEP_SPANS = ("train.forward", "system.render", "train.backward",
              "train.update", "train.batch_wait", "train.batch_copy")
REQUEST_SPANS = ("serve.lock_wait", "serve.render", "render.dispatch",
                 "serve.encode")


@pytest.fixture(autouse=True)
def fresh_records():
    tracing.reset()
    yield
    tracing.reset()


def _one(name):
    recs = tracing.records(name)
    assert len(recs) == 1, (name, recs)
    return recs[0]


def test_nesting_rid_and_self_time():
    with tracing.span("outer", rid=7) as outer:
        time.sleep(0.002)
        with tracing.span("inner") as inner:
            time.sleep(0.002)
            with tracing.span("innermost"):
                pass
        with tracing.span("other", rid=9):
            time.sleep(0.001)
    assert _one("outer") is outer and _one("inner") is inner
    other, innermost = _one("other"), _one("innermost")
    assert (outer.parent, inner.parent, innermost.parent, other.parent) == (
        None, "outer", "inner", "outer")
    assert (outer.rid, inner.rid, innermost.rid, other.rid) == (7, 7, 7, 9)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= other.start_ns
    assert other.end_ns <= outer.end_ns
    assert outer.self_ns == (outer.duration_ns - inner.duration_ns
                             - other.duration_ns)
    assert inner.self_ns == inner.duration_ns - innermost.duration_ns
    assert outer.self_ns >= 2_000_000 and inner.self_ns >= 2_000_000
    assert other.self_ns == other.duration_ns
    assert {r.thread for r in (outer, inner, innermost, other)} == {
        threading.get_ident()}
    assert not any(r.profiled for r in (outer, inner, innermost, other))
    assert outer.ms == pytest.approx(outer.duration_ns * 1e-6)


def test_one_stack_per_thread_under_many_threads():
    n_threads, n_spans = 24, 150
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(k):
            for i in range(n_spans):
                with tracing.span("t.outer", rid=(k, i)):
                    with tracing.span("t.inner"):
                        pass

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    outer, inner = tracing.records("t.outer"), tracing.records("t.inner")
    assert len(outer) == len(inner) == n_threads * n_spans
    assert tracing.dropped("t.outer") == tracing.dropped("t.inner") == 0
    assert {r.rid for r in outer} == {r.rid for r in inner} == {
        (k, i) for k in range(n_threads) for i in range(n_spans)}
    assert all(r.parent == "t.outer" for r in inner)
    assert all(r.parent is None for r in outer)
    by_rid = {r.rid: r for r in outer}
    for r in inner:   # each inner span sits in its own thread's outer one
        o = by_rid[r.rid]
        assert r.thread == o.thread
        assert o.start_ns <= r.start_ns <= r.end_ns <= o.end_ns
        assert o.self_ns == o.duration_ns - r.duration_ns
    assert len({r.thread for r in outer}) > 1


def test_ring_keeps_the_latest_and_counts_the_dropped():
    extra = 10
    for i in range(tracing.RING + extra):
        with tracing.span("ring", rid=i):
            pass
    kept = tracing.records("ring")
    assert len(kept) == tracing.RING >= 4096
    assert tracing.dropped("ring") == extra
    assert [r.rid for r in kept] == list(range(extra, tracing.RING + extra))
    assert tracing.dropped("never") == 0 and tracing.records("never") == []
    tracing.reset()
    assert tracing.records("ring") == [] and tracing.dropped("ring") == 0


def test_records_on_the_profilers_clock(monkeypatch):
    entered = []
    real = tracing.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    with tracing.span("clock.off"):
        time.sleep(0.001)
    assert entered == [] and not _one("clock.off").profiled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with real("warm"):   # the process's first event sets the op up
            pass
        with tracing.span("clock.on"):
            time.sleep(0.003)
    assert entered == ["clock.on"]
    rec = _one("clock.on")
    assert rec.profiled
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "clock.on"]
    assert len(events) == 1
    e = events[0]
    assert abs(e.start_ns() - rec.start_ns) < 1_000_000
    assert abs(e.start_ns() + e.duration_ns() - rec.end_ns) < 1_000_000
    with tracing.span("clock.after"):
        pass
    assert entered == ["clock.on"] and not _one("clock.after").profiled


# ------------------------------------------------------------ the Trainer
TRAIN_CFG = Config(batch_size=64, N_samples=8, N_importance=8, netdepth=2,
                   netwidth=32, nerf_out_dim=16, N_emb_xyz=10, N_vocab=10,
                   appearance_wh=(64, 48), num_epochs=1, val_every_epochs=0,
                   chunk=256, log_every=1000, profile=True,
                   profile_steps=(1, 3))
K_STEPS = 4


def test_trainer_steps_carry_their_spans(tmp_path):
    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=(24, 18),
                                 appearance_wh=TRAIN_CFG.appearance_wh)
    cfg = TRAIN_CFG.replace(save_dir=str(tmp_path), exp_name="spans")
    tr = Trainer(cfg, scene, device="cpu")
    assert tr.iters_per_epoch > K_STEPS
    inner = tr.step_fn

    def stop_after(state, batch, draws=None):
        out = inner(state, batch, draws)
        if state.step == K_STEPS:
            tr.request_stop()
        return out

    tr.step_fn = stop_after
    tr.fit()
    steps = tracing.records("train.step")
    assert [r.rid for r in steps] == list(range(K_STEPS))
    assert all(r.parent is None for r in steps)
    parents = {"train.forward": "train.step", "system.render":
               "train.forward", "train.backward": "train.step",
               "train.update": "train.step", "train.batch_wait": None,
               "train.batch_copy": None}
    for name in STEP_SPANS:
        recs = tracing.records(name)
        assert [r.rid for r in recs] == list(range(K_STEPS)), name
        assert {r.parent for r in recs} == {parents[name]}, name
    for s in steps:
        kids = {n: next(r for r in tracing.records(n) if r.rid == s.rid)
                for n in STEP_SPANS}
        assert kids["train.batch_wait"].end_ns <= kids[
            "train.batch_copy"].start_ns <= kids[
            "train.batch_copy"].end_ns <= s.start_ns
        assert s.start_ns <= kids["train.forward"].start_ns <= kids[
            "system.render"].start_ns <= kids["system.render"].end_ns <= kids[
            "train.forward"].end_ns <= kids["train.backward"].start_ns <= kids[
            "train.backward"].end_ns <= kids["train.update"].start_ns <= kids[
            "train.update"].end_ns <= s.end_ns
        assert s.profiled == (s.rid in (1, 2))
    # Config.profile's window names the program's phases
    trace = os.path.join(str(tmp_path), "traces", "spans",
                         "steps_1_3.trace.json")
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.forward", "system.render",
            "train.backward", "train.update"} <= names


# -------------------------------------------------------------- the server
SERVE_CFG = Config(N_samples=8, N_importance=8, netdepth=2, netwidth=32,
                   nerf_out_dim=16, N_emb_xyz=10, appearance_wh=(64, 48),
                   chunk=256, compute_dtype="float32", use_mask=False)
C2W = [[1, 0, 0, 0.1], [0, 1, 0, -0.05], [0, 0, 1, 1.5]]


def _render_req(**kw):
    return {"op": "render", "wh": [16, 12], "c2w": C2W, "fov": 60.0,
            "near": 0.5, "far": 2.5, "style_id": "s", "inline": True, **kw}


def _nearest_rank(values, q):
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def test_a_served_render_carries_its_spans_and_stats():
    torch.manual_seed(0)
    svc = RenderService(SERVE_CFG, CrNerfSystem(SERVE_CFG))
    warmup(svc, "16x12")
    assert tracing.records("serve.render")   # the warm-up rendered
    stats = svc.handle({"op": "stats"})
    assert stats["renders"] == 0 and stats["p50_ms"] is None
    assert stats["p95_ms"] is None and stats["lock_wait_p95_ms"] is None
    wa, ha = SERVE_CFG.appearance_wh
    svc.styles["s"] = np.zeros((1, ha, wa, 3), np.float32)
    server = Server(svc, "127.0.0.1", 0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        host, port = server.server_address
        replies = [request(host, port, _render_req()) for _ in range(3)]
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=30)
    assert not serving.is_alive()
    assert all(r["ok"] for r in replies), replies
    assert all(base64.b64decode(r["png_b64"]) for r in replies)
    reqs = tracing.records("serve.request")
    assert len(reqs) == 3 and len({r.rid for r in reqs}) == 3
    renders = {r.rid: r for r in tracing.records("serve.render")
               if r.rid is not None}
    for req, reply in zip(reqs, replies):
        assert req.parent is None
        for name in REQUEST_SPANS:
            kids = [r for r in tracing.records(name) if r.rid == req.rid]
            assert len(kids) == 1, name
            k = kids[0]
            assert req.start_ns <= k.start_ns <= k.end_ns <= req.end_ns
            assert k.parent == ("serve.render" if name == "render.dispatch"
                                else "serve.request"), name
        render = renders[req.rid]
        assert reply["ms"] == round(render.ms, 2)
        covered = sum(next(r for r in tracing.records(n)
                           if r.rid == req.rid).duration_ns
                      for n in ("serve.lock_wait", "serve.render",
                                "serve.encode"))
        assert req.self_ns == req.duration_ns - covered
    stats = svc.handle({"op": "stats"})
    ms = [renders[r.rid].ms for r in reqs]
    waits = [r.ms for r in tracing.records("serve.lock_wait")]
    assert stats["renders"] == 3
    assert stats["p50_ms"] == round(_nearest_rank(ms, 50), 2)
    assert stats["p95_ms"] == round(_nearest_rank(ms, 95), 2) == round(
        max(ms), 2)
    assert stats["lock_wait_p95_ms"] == round(_nearest_rank(waits, 95), 2)
    warmup(svc, "16x12")
    assert svc.handle({"op": "stats"})["renders"] == 0


def test_stats_percentiles_are_nearest_rank(monkeypatch):
    svc = RenderService(SERVE_CFG, CrNerfSystem(SERVE_CFG))
    times = iter(range(0, 10 ** 9, 10 ** 6))   # each read 1 ms on
    monkeypatch.setattr(tracing.time, "time_ns", lambda: next(times))
    for n in (3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4):
        with tracing.span("serve.render"):
            for _ in range(n - 1):
                time.time_ns()
    monkeypatch.undo()
    stats = svc.handle({"op": "stats"})
    # 20 renders of these ms: ranks 10 and 19 of the sorted list
    assert stats["renders"] == 20
    assert (stats["p50_ms"], stats["p95_ms"]) == (4.0, 9.0)


def test_counters_hold_every_ops_modules_launch_counts():
    every = tracing.counters()
    mods = (composite, conv, fused_mlp, fused_render, pipe_render, sincos,
            sublane_stores)
    keys = [k for m in mods for k in m.LAUNCH_COUNTS]
    assert sorted(every) == sorted(keys)
    assert all(every[k] == m.LAUNCH_COUNTS[k] for m in mods
               for k in m.LAUNCH_COUNTS)
    before = sincos.LAUNCH_COUNTS["sincos"]
    sincos.LAUNCH_COUNTS["sincos"] += 1
    try:
        assert tracing.counters()["sincos"] == before + 1
    finally:
        sincos.LAUNCH_COUNTS["sincos"] -= 1
    with pytest.raises(ValueError):
        tracing.register({"sincos": 0})
