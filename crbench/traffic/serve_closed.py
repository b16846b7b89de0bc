"""Serving traffic: ``clients`` closed-loop clients over loopback TCP
against ``apps/serve.py``'s ``Server`` wrapping a ``RenderService`` of
``crnerf_tpu_torch``, with seeded weights and seeded style images.

Set-up: the system is built on the device and the seeded weights,
shaped into a scene whose frames depend on the pose and the style, are
copied in, the service is warmed up by the program's own
``warmup(svc, "WxH")``, ``styles`` seeded PNGs are registered with
``encode_style``, and the client process (``serve_client``, standard
library only) connects and sends its warm-up requests. The window opens
when the client reads ``go``. The seed picks the weights, the style
images, the first pose of the path and the order of the styles; every
seed asks for the same frames' sizes in the same closed loop.
"""

from __future__ import annotations

import base64
import gc
import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List

import numpy as np

from crbench import camera, pngcodec
from crbench.harness import Check, Run, Stretch, percentile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def style_images(seed: int, n: int, appearance_wh) -> List[np.ndarray]:
    """``n`` seeded (Ha, Wa, 3) uint8 style images: a random colour field
    of 8 x 8 cells tinted by a random colour of the image's own, smoothly
    interpolated, with pixel noise."""
    rng = np.random.default_rng(seed + 1)
    wa, ha = appearance_wh
    ys, xs = np.linspace(0, 7, ha), np.linspace(0, 7, wa)
    out = []
    for _ in range(n):
        grid = rng.uniform(0, 255, (8, 8, 3))
        grid = 0.6 * rng.uniform(0, 255, (1, 1, 3)) + 0.4 * grid
        rows = np.stack([np.interp(ys, np.arange(8), grid[:, j, c])
                         for j in range(8) for c in range(3)], -1)
        rows = rows.reshape(ha, 8, 3)
        img = np.stack([np.interp(xs, np.arange(8), rows[i, :, c])
                        for i in range(ha) for c in range(3)], -1)
        img = img.reshape(wa, ha, 3).transpose(1, 0, 2)
        img = img + rng.normal(0, 12, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def frame_readings(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """A served uint8 frame against the reference's: the mean absolute
    difference in levels (``frame_gap``), the shares of values more than
    2, 8 and 16 levels off, in percent (``frame_off2``, ``frame_off8``,
    ``frame_off16``), and the share of 8 x 8 blocks whose mean in a
    channel is more than 4 levels off (``frame_blk8_off4``)."""
    keys = ("frame_gap", "frame_off2", "frame_off8", "frame_off16",
            "frame_blk8_off4")
    if got.shape != want.shape:
        return {k: float("inf") for k in keys}
    d = got.astype(np.int32) - want.astype(np.int32)
    h, w = (n // 8 * 8 for n in d.shape[:2])
    blocks = d[:h, :w].reshape(h // 8, 8, w // 8, 8, -1).mean((1, 3))
    a = np.abs(d)
    return dict(zip(keys, (float(a.mean()), float(100.0 * (a > 2).mean()),
                           float(100.0 * (a > 8).mean()),
                           float(100.0 * (a > 16).mean()),
                           float(100.0 * (np.abs(blocks) > 4).mean()))))


def serve_inputs(fields: Dict, w: Dict, seed: int, shapes: Dict, device):
    """The seed's weights, shaped into a scene (``weights.served_scene``),
    and its style images -> (name -> tensor on ``device``, [(Ha, Wa, 3)
    uint8])."""
    import torch

    from crbench.weights import seeded_entries, served_scene

    entries = seeded_entries(shapes, seed, device)
    styles = style_images(seed, w["styles"], fields["appearance_wh"])
    served_scene(entries, fields, w, [
        torch.as_tensor(s, device=device).float() / 255.0 * 2.0 - 1.0
        for s in styles], device)
    return entries, styles


def plan_of(r: Run, port: int, out: str) -> Dict:
    rng = np.random.default_rng(r.seed + 2)
    w = r.workload
    n = w["path_frames"]
    styles = [f"s{k}" for k in rng.permutation(w["styles"])]
    return dict(host="127.0.0.1", port=port, clients=w["clients"],
                seconds=r.seconds, wh=w["wh"], fov=w["fov"], near=w["near"],
                far=w["far"], poses=camera.path_poses(n).tolist(),
                offset=int(rng.integers(n)), styles=styles,
                warm_requests=w["warm_requests"], timeout=300.0,
                checked_frames=w["checked_frames"],
                sample_seed=int(rng.integers(2 ** 31)), out=out)


class Funnel:
    """In a traced run, the renders of the profiled stretch run on the
    main thread, the one that started CUDA and the profiler: the profiler
    keeps only the device work launched from the thread it runs in, and a
    render launched from another thread while it runs can lose it the
    stretch's device events. The renders are serialised by the service's
    lock anyway; outside the stretch the handler threads render as they do
    untraced."""

    def __init__(self, svc):
        self.render = svc._render
        svc._render = self._render
        self.tasks: "queue.Queue" = queue.Queue()
        self.lock = threading.Lock()
        self.on, self.waiting, self.direct = False, 0, 0

    def _render(self, *args):
        with self.lock:
            on = self.on
            self.waiting += on
            self.direct += not on
        if not on:
            try:
                return self.render(*args)
            finally:
                with self.lock:
                    self.direct -= 1
        done = Future()
        self.tasks.put((args, done))
        try:
            return done.result()
        finally:
            with self.lock:
                self.waiting -= 1

    def _run_one(self, timeout: float) -> None:
        try:
            args, done = self.tasks.get(timeout=timeout)
        except queue.Empty:
            return
        try:
            done.set_result(self.render(*args))
        except Exception as e:   # the handler thread raises it
            done.set_exception(e)

    def serve(self, seconds: float, start=lambda: None) -> None:
        """Take the renders onto this thread, wait until none runs on a
        handler thread, call ``start`` (the profiler's), run the renders
        here for ``seconds``, then until no handler waits for one."""
        with self.lock:
            self.on = True
        while True:
            with self.lock:
                if self.direct == 0:
                    break
            time.sleep(0.001)
        start()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self._run_one(0.01)
        with self.lock:
            self.on = False
        while True:
            with self.lock:
                idle = self.waiting == 0
            if idle and self.tasks.empty():
                return
            self._run_one(0.01)


def run(r: Run) -> Dict:
    import torch

    from crbench.reference.frame import frame_u8
    from crbench.weights import floating_shapes, load_into
    from crbench.yardstick import frame_flops
    from crnerf_tpu_torch import Config
    from crnerf_tpu_torch.apps.serve import RenderService, Server, warmup
    from crnerf_tpu_torch.render.system import CrNerfSystem

    fields, w = r.fields, r.workload
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in fields.items()})
    with torch.device(r.device):
        system = CrNerfSystem(cfg)
    entries, styles = serve_inputs(fields, w, r.seed,
                                   floating_shapes(system), r.device)
    load_into(system, entries)
    svc = RenderService(cfg, system.eval())
    warmup(svc, "{}x{}".format(*w["wh"]))
    sdir = os.path.join(r.tmp, "styles")
    os.makedirs(sdir, exist_ok=True)
    for k, img in enumerate(styles):
        path = os.path.join(sdir, f"s{k}.png")
        with open(path, "wb") as f:
            f.write(pngcodec.encode(img))
        resp = svc.handle({"op": "encode_style", "id": f"s{k}",
                           "image_path": path})
        if not resp.get("ok"):
            raise RuntimeError(f"encode_style: {resp}")
    funnel = Funnel(svc) if r.trace else None
    server = Server(svc, "127.0.0.1", 0)
    serving = threading.Thread(target=server.serve_forever)
    serving.start()
    out = os.path.join(r.tmp, "client.json")
    plan = plan_of(r, server.server_address[1], out)
    client = subprocess.Popen(
        [sys.executable, "-m", "crbench.traffic.serve_client"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO)
    stretch = Stretch() if r.trace else None
    try:
        client.stdin.write(json.dumps(plan) + "\n")
        client.stdin.flush()
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the client process did not get ready")
        client.stdin.write("go\n")
        client.stdin.flush()
        t_go = time.perf_counter()
        if stretch is not None:
            time.sleep(w["trace_from"] * r.seconds)
            # the profiler's start (seconds of set-up) in the client's
            # clock, less a frame: the requests before it are calm
            calm_until = time.perf_counter() - t_go - 1.0
            funnel.serve(w["trace_seconds"], stretch.start)
            stretch.stop()
        client.stdin.close()
        client.wait(timeout=r.seconds + 600)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
        server.shutdown()
        server.server_close()
        serving.join()
    if client.returncode != 0:
        raise RuntimeError(f"client process exited {client.returncode}")
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    with open(out) as f:
        got = json.load(f)
    del svc, system, server
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    recs = got["records"]
    ok = [x for x in recs if x["ok"]]
    lat_ms = [1e3 * (x["recv"] - x["send"]) if x["ok"] else float("inf")
              for x in recs]
    frames = sum(1 for x in ok if x["recv"] <= r.seconds)
    wh = tuple(w["wh"])
    hw = (wh[1], wh[0])
    K = camera.fov_k(wh, w["fov"])
    got_r: Dict[str, tuple] = {}
    for i, b64 in sorted(got["kept"].items(), key=lambda kv: int(kv[0])):
        i = int(i)
        served = pngcodec.decode(base64.b64decode(b64))
        pose = plan["poses"][(plan["offset"] + i) % len(plan["poses"])]
        style = styles[int(plan["styles"][i % len(plan["styles"])][1:])]
        want = frame_u8(entries, fields, pose, K, w["near"], w["far"], hw,
                        style.astype(np.float32) / 255.0 * 2.0 - 1.0,
                        r.device)
        for k, v in frame_readings(served, want).items():
            if k not in got_r or v > got_r[k][0]:
                got_r[k] = (v, f"request {i}")
    if not got_r:       # no frame came back to check
        got_r = {k: (float("inf"), "no frame") for k in w["limits"]}
    print("readings " + json.dumps({k: v[0] for k, v in got_r.items()}),
          file=sys.stderr, flush=True)
    checks = [Check(k, got_r[k][0], lim, got_r[k][1])
              for k, lim in w["limits"].items()]
    # the per-layer means and rate are of the requests before the profiler
    # starts: a server runs slower from then to the run's end (its hooks
    # outlive its stop)
    calm_s = r.seconds if stretch is None else calm_until
    calm = [x for x in ok if x["recv"] < calm_s]
    data = dict(kind="serve", fields=fields, wh=wh,
                frames=len(calm),
                window_s=calm_s, render_ms=[x["ms"] for x in calm],
                outside_ms=[1e3 * (x["recv"] - x["send"]) - x["ms"]
                            for x in calm],
                flops_per_frame=frame_flops(fields, wh))
    if stretch is not None:
        data["trace"] = stretch.summary()
    return dict(attempted=len(recs), failed=len(recs) - len(ok),
                e2e={"serve_frames_per_s": frames / r.seconds,
                     "serve_p95_ms": percentile(lat_ms, 95)
                     if lat_ms else float("inf"),
                     "setup_s": t_go - r.t_process},
                memory_peak_bytes=peak, checks=checks, data=data)
