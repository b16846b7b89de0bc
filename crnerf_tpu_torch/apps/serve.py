"""Persistent render server (``crnerf_tpu/apps/serve.py``): one resident
model answering renders over a line-delimited-JSON TCP protocol.

Protocol: one JSON object per line, one JSON reply per line.

  {"op": "ping"}
  {"op": "encode_style", "id": "starry", "image_path": "a.png"}
  {"op": "render", "c2w": [[...3 rows x 4...]], "wh": [W, H],
   "fov": 60.0,                 # or "K": [[3x3]]
   "near": 0.0, "far": 5.0,     # optional
   "style_id": "starry",        # or "style_image": "a.png"
   "out_path": "f.png"}         # or "inline": true -> base64 PNG
  {"op": "render_path", "scene": "brandenburg_gate", "n_frames": 24,
   "wh": [W, H], "style_id": "starry", "out_dir": "frames/"}
                                # optional: "c2w" (the path's anchor,
                                # default the scene's DEMO_ANCHORS pose),
                                # "fov", "near", "far"
  {"op": "stats"}
  {"op": "shutdown"}

Every reply carries {"ok": true/false}; render replies add the wall-clock
"ms" of the render (camera in, uint8 frame on the host); ``render_path``
replies ``frames``, ``out_dir``, ``gif`` and ``ms_total``, having written
``NNN.png`` and ``<scene>.gif`` into ``out_dir``. Renders serialize on one
lock (one card), ``render_path`` a frame at a time. PNGs and the GIF are
written by the standard-library encoders of ``utils/png.py`` and
``utils/visualization.py``; a PNG style image is decoded and resized
without an image library, another format needs PIL.

Trust model as in the JAX server: requests carry filesystem paths; the
default bind is loopback, and a non-loopback bind requires ``--root DIR``,
under which every network-supplied path must resolve.

Run:  python -m crnerf_tpu_torch serve --ckpt_path weights.npz --port 7060
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import socket
import socketserver
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from crnerf_tpu_torch import Config
from crnerf_tpu_torch.apps import add_device_arg, resolve_device
from crnerf_tpu_torch.render.camera_path import (
    DEMO_ANCHORS,
    PATH_PRESETS,
    fov_intrinsics,
    resolve_scene,
)
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.utils.lanczos import resize_lanczos
from crnerf_tpu_torch.utils.png import png_bytes, read_png
from crnerf_tpu_torch.utils.visualization import write_video


class ServeError(ValueError):
    """Client error: reported in the JSON reply, never kills the server."""


def load_style(path: str, appearance_wh) -> np.ndarray:
    """Style image -> (1, Ha, Wa, 3) in [-1, 1], RGB Lanczos-resized as the
    JAX package's video app does with PIL. A PNG is decoded and resized
    without an image library (``read_png``, ``resize_lanczos``: PIL's
    bytes); another format needs PIL."""
    with open(path, "rb") as f:
        is_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    if is_png:
        img = resize_lanczos(read_png(path, "RGB"), tuple(appearance_wh))
    else:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"decoding {path} needs PIL, which is not installed: give "
                "the style image as a PNG") from None
        img = np.asarray(Image.open(path).convert("RGB").resize(
            tuple(appearance_wh), Image.LANCZOS))
    return (np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0)[None]


class RenderService:
    """The socket-free core: one resident model and the style table.
    Tests and embedders drive ``handle(dict) -> dict`` directly."""

    def __init__(self, cfg: Config, system: CrNerfSystem,
                 root: Optional[str] = None):
        self.cfg = cfg
        self.renderer = Renderer(cfg, system)
        self.styles: Dict[str, np.ndarray] = {}
        self.lock = threading.Lock()
        self.n_renders = 0
        self.render_ms: list = []
        self._shutdown = threading.Event()
        self.root = os.path.realpath(root) if root else None

    # ----------------------------------------------------------- helpers
    def _check_path(self, path: str) -> str:
        if self.root is None:
            return path
        real = os.path.realpath(path)
        if real != self.root and not real.startswith(self.root + os.sep):
            raise ServeError(f"path {path!r} escapes the server --root "
                             "sandbox")
        return real

    def _load_style(self, path: str) -> np.ndarray:
        path = self._check_path(path)
        if not os.path.exists(path):
            raise ServeError(f"style image not found: {path}")
        return load_style(path, self.cfg.appearance_wh)

    def _style_from(self, req: Dict) -> np.ndarray:
        if "style_id" in req:
            try:
                return self.styles[req["style_id"]]
            except KeyError:
                raise ServeError(
                    f"unknown style_id {req['style_id']!r}; "
                    f"known: {sorted(self.styles)}"
                ) from None
        if "style_image" in req:
            return self._load_style(req["style_image"])
        raise ServeError("request needs style_id or style_image")

    def _cam_from(self, req: Dict) -> tuple:
        try:
            w, h = (int(x) for x in req["wh"])
            c2w = np.asarray(req["c2w"], np.float32)
        except (KeyError, TypeError, ValueError) as e:
            raise ServeError(f"bad/missing wh or c2w: {e}") from None
        if c2w.shape != (3, 4):
            raise ServeError(f"c2w must be 3x4, got {c2w.shape}")
        if w < 1 or h < 1:
            raise ServeError(f"wh must be positive, got {[w, h]}")
        if "K" in req:
            K = np.asarray(req["K"], np.float32)
            if K.shape != (3, 3):
                raise ServeError(f"K must be 3x3, got {K.shape}")
        else:
            K = fov_intrinsics((w, h), float(req.get("fov", 60.0)))
        near = float(req.get("near", 0.0))
        far = float(req.get("far", 5.0))
        return c2w, K, near, far, (h, w)

    def _render(self, cam, style, hw) -> Dict:
        c2w, K, near, far = cam
        t0 = time.perf_counter()
        out = self.renderer.fetch(self.renderer.render_frame_cam_async(
            c2w, K, near, far, hw, style, outputs="rgb_u8"))
        ms = (time.perf_counter() - t0) * 1e3
        self.n_renders += 1
        self.render_ms.append(ms)
        return {"rgb": out["rgb_u8"], "ms": round(ms, 2)}

    # --------------------------------------------------------------- ops
    def op_ping(self, req):
        dev = self.renderer.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return {"device": str(dev), "device_name": name,
                "styles": sorted(self.styles)}

    def op_encode_style(self, req):
        if "id" not in req or "image_path" not in req:
            raise ServeError("encode_style needs id and image_path")
        self.styles[str(req["id"])] = self._load_style(req["image_path"])
        return {"styles": sorted(self.styles)}

    def op_render(self, req):
        if not req.get("inline") and "out_path" not in req:
            raise ServeError("render needs inline:true and/or out_path")
        c2w, K, near, far, hw = self._cam_from(req)
        style = self._style_from(req)
        with self.lock:
            r = self._render((c2w, K, near, far), style, hw)
        resp = {"ms": r["ms"], "wh": [hw[1], hw[0]]}
        png = png_bytes(r["rgb"])
        if req.get("inline"):
            resp["png_b64"] = base64.b64encode(png).decode("ascii")
        if "out_path" in req:
            out_path = self._check_path(req["out_path"])
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            with open(out_path, "wb") as f:
                f.write(png)
            resp["out_path"] = out_path
        return resp

    def op_render_path(self, req):
        if "out_dir" not in req:
            raise ServeError("render_path needs out_dir")
        style = self._style_from(req)
        w, h = (int(x) for x in req.get("wh", (320, 240)))
        key = resolve_scene(str(req.get("scene", "")))
        spec = PATH_PRESETS[key]
        if "n_frames" in req:
            spec = dataclasses.replace(spec, n_frames=int(req["n_frames"]))
        anchor = (np.asarray(req["c2w"], np.float32) if "c2w" in req
                  else DEMO_ANCHORS.get(key))
        if anchor is None:
            raise ServeError(f"no demo anchor for {key}; pass c2w")
        out_dir = self._check_path(req["out_dir"])
        os.makedirs(out_dir, exist_ok=True)
        frames, t0 = [], time.perf_counter()
        K = fov_intrinsics((w, h), float(req.get("fov", 60.0)))
        near = float(req.get("near", 0.0))
        far = float(req.get("far", 5.0))
        for i, c2w in enumerate(spec.poses(anchor)):
            with self.lock:   # a frame at a time: renders interleave
                r = self._render((c2w, K, near, far), style, (h, w))
            with open(os.path.join(out_dir, f"{i:03d}.png"), "wb") as f:
                f.write(png_bytes(r["rgb"]))
            frames.append(r["rgb"])
        gif = write_video(os.path.join(out_dir, key), frames)
        return {"frames": len(frames), "out_dir": out_dir, "gif": gif,
                "ms_total": round((time.perf_counter() - t0) * 1e3, 1)}

    def op_stats(self, req):
        ms = sorted(self.render_ms)
        pct = (
            lambda q: round(ms[min(len(ms) - 1, int(q * len(ms)))], 2)
        ) if ms else (lambda q: None)
        return {"renders": self.n_renders, "p50_ms": pct(0.50),
                "p95_ms": pct(0.95), "styles": sorted(self.styles)}

    def op_shutdown(self, req):
        self._shutdown.set()
        return {"shutting_down": True}

    def handle(self, req) -> Dict:
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON object"}
        op = req.get("op")
        fn = {
            "ping": self.op_ping, "encode_style": self.op_encode_style,
            "render": self.op_render, "render_path": self.op_render_path,
            "stats": self.op_stats, "shutdown": self.op_shutdown,
        }.get(op)
        if fn is None:
            return {"ok": False, "error": f"unknown op {op!r}"}
        try:
            resp = fn(req)
        except ServeError as e:
            return {"ok": False, "error": str(e)}
        except Exception as e:  # the server survives a bad request
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        resp["ok"] = True
        return resp


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        svc: RenderService = self.server.service  # type: ignore[attr-defined]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                req = json.loads(raw)
            except json.JSONDecodeError as e:
                resp = {"ok": False, "error": f"bad json: {e}"}
            else:
                resp = svc.handle(req)
            self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))
            self.wfile.flush()
            if svc._shutdown.is_set():
                # shutdown() joins the serve loop: call it from another
                # thread, never inline in a handler
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return


def warmup(svc: RenderService, sizes: str) -> None:
    """Render the named WxH sizes once before accepting connections (first
    launches build the kernel and warm the allocator), then zero the
    latency stats."""
    ww, wh_ = svc.cfg.appearance_wh
    for size in filter(None, sizes.split(",")):
        w, h = (int(x) for x in size.lower().split("x"))
        style = np.zeros((1, wh_, ww, 3), np.float32)
        c2w, K, near, far, hw = svc._cam_from(
            {"wh": [w, h], "c2w": np.eye(3, 4, dtype=np.float32).tolist()})
        svc._render((c2w, K, near, far), style, hw)
        print(f"warmup {w}x{h} done", flush=True)
    svc.n_renders = 0
    svc.render_ms.clear()


class Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, svc: RenderService, host="127.0.0.1", port=0):
        super().__init__((host, port), _Handler)
        self.service = svc


def request(host: str, port: int, req: Dict, timeout=600.0,
            max_reply_bytes=256 << 20) -> Dict:
    """One-shot client: send one request, read one reply line."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode("utf-8"))
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError(
                    "server closed connection mid-reply "
                    f"({len(buf)} bytes buffered, no trailing newline)")
            buf += chunk
            if len(buf) > max_reply_bytes:
                raise ConnectionError(
                    f"reply exceeds {max_reply_bytes} bytes without a "
                    "newline; aborting")
    return json.loads(buf.decode("utf-8"))


def load_system(cfg: Config, ckpt_path: str,
                device: torch.device) -> CrNerfSystem:
    """weights.npz (or a directory holding one) -> the port's system."""
    from crnerf_tpu_torch.utils.weights import load_into

    if os.path.isdir(ckpt_path):
        ckpt_path = os.path.join(ckpt_path, "weights.npz")
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"no weights.npz at {ckpt_path}")
    return load_into(CrNerfSystem(cfg), ckpt_path).to(device).eval()


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="crnerf render server (torch)")
    p.add_argument("--ckpt_path", type=str, required=True,
                   help="weights.npz in the save_weights_only layout, or a "
                        "directory holding one")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7060)
    add_device_arg(p)
    p.add_argument("--N_samples", type=int, default=256)
    p.add_argument("--N_importance", type=int, default=256)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--use_pallas", type=int, default=1, choices=(0, 1),
                   help="0: the NerfMLP module per point, not the kernels")
    p.add_argument("--pallas_render", type=int, default=1, choices=(0, 1),
                   help="0: the fused MLP kernel per point and compositing "
                        "in plain PyTorch, not the fused render kernel")
    # architecture knobs must match the checkpoint
    p.add_argument("--netdepth", type=int, default=8)
    p.add_argument("--netwidth", type=int, default=256)
    p.add_argument("--nerf_out_dim", type=int, default=64)
    p.add_argument("--appearance_wh", nargs=2, type=int, default=[224, 160])
    p.add_argument("--warmup", type=str, default="",
                   help="comma list of WxH sizes to render once before "
                        "serving, e.g. 320x240")
    p.add_argument("--root", type=str, default="",
                   help="sandbox dir: network-supplied paths must resolve "
                        "under it (required for non-loopback binds)")
    args = p.parse_args(argv)
    if not args.root and args.host not in ("127.0.0.1", "localhost", "::1"):
        p.error("non-loopback --host requires --root (requests carry "
                "filesystem paths)")
    device = resolve_device(p, args.device)
    cfg = Config(
        N_samples=args.N_samples, N_importance=args.N_importance,
        chunk=args.chunk, appearance_wh=tuple(args.appearance_wh),
        netdepth=args.netdepth, netwidth=args.netwidth,
        nerf_out_dim=args.nerf_out_dim, compute_dtype=args.compute_dtype,
        use_pallas=bool(args.use_pallas),
        pallas_render=bool(args.pallas_render),
        use_mask=False,  # serve = the decode path
    )
    system = load_system(cfg, args.ckpt_path, device)
    svc = RenderService(cfg, system, root=args.root or None)
    warmup(svc, args.warmup)
    server = Server(svc, args.host, args.port)
    host, port = server.server_address
    print(f"serving on {host}:{port} (ops: ping, encode_style, render, "
          "render_path, stats, shutdown)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        # let handler threads finish their replies: a daemon thread still
        # running when the interpreter finalizes is torn down mid-call,
        # which aborted the process (SIGABRT) under load
        for t in threading.enumerate():
            if t is not threading.main_thread():
                t.join(timeout=5)
    return port


if __name__ == "__main__":
    main()
