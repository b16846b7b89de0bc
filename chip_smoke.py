#!/usr/bin/env python3
"""Drive the PyTorch port (crnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # build, kernel checks, serve

Phases, each fatal on failure:
  1. versions, the card's name and power limit; no CUDA device -> exit 1
  2. build every kernel of the serving path from csrc/ with nvcc (sm_90a)
  3. kernel against its plain PyTorch version at full width (8x256, C=64)
     on 1024 rays, S=256 and S=512, bf16 and fp32, exact encode and the
     recurrence; max abs error of weights, fmap and depth against the
     stated tolerances, and the kernel's time beside the plain version's
  4. serve at full size: RenderService with seeded random weights
     round-tripped through a weights.npz and the weight bridge, ping,
     3 inline 320x240 renders at 256+256 samples, stats; the launch
     counters are zeroed just before and read just after
Prints a {"kernels": [...]} line, the card line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when a
phase fails or no CUDA device is present.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, "build")   # listed in .gitignore
sys.path.insert(0, REPO)

N_RAYS = 1024
FRAME_WH = (320, 240)
N_RENDERS = 3
SEED = 0


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


@contextlib.contextmanager
def full_fp32():
    """fp32 references at full fp32: no TF32 in matmuls or convolutions
    inside the block; the flags are restored after it, so the served path
    runs with the process's own settings."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def time_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def full_width_params(seed: int, device):
    """Seeded 8x256, C=64 NerfMLP weights (PyTorch's default init) in the
    kernel's (in, out) layout."""
    import torch

    from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
    from crnerf_tpu_torch.ops.fused_render import mlp_params_from_module

    torch.manual_seed(seed)
    return mlp_params_from_module(NerfMLP(depth=8, width=256,
                                          out_dim=64).to(device))


def phase_build():
    from crnerf_tpu_torch.ops import _build, fused_render

    t0 = time.perf_counter()
    fused_render._lib()
    dt = time.perf_counter() - t0
    log = _build.BUILD_LOG.get("fused_render_fwd.cu", "(cached build)")
    print(f"[build] fused_render_fwd.cu in {dt:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("[build]  " + line.strip())


def phase_kernel(device, seed: int):
    """Kernel against render_fwd_plain on the same inputs. Returns the
    per-case records and the worst case's timing at the serve config
    (bf16, recurrence encode)."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    params = full_width_params(seed, device)
    gen = torch.Generator().manual_seed(seed + 1)
    n = N_RAYS
    o = (torch.randn(n, 3, generator=gen) * 0.5).to(device)
    d = torch.randn(n, 3, generator=gen)
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(device)
    before = fr.LAUNCH_COUNTS["fused_render_fwd"]
    records = []
    ok = True
    for s in (256, 512):
        z = torch.sort(torch.rand(n, s, generator=gen) * 4.0 + 0.5,
                       -1).values.to(device)
        noise = torch.randn(n, s, generator=gen).to(device)
        for dt_name, dt in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            kw = fr.prepare_kernel_weights(params, 15, 4, dt)
            for exact in (True, False):
                with full_fp32():
                    blk_k, w_k = fr.fused_render_apply(kw, o, d, z, noise,
                                                       exact_encode=exact)
                    blk_p, w_p = fr.render_fwd_plain(params, o, d, z, noise,
                                                     15, 4, dt, exact)
                    torch.cuda.synchronize()
                err = (
                    (w_k - w_p).abs().max().item(),
                    (blk_k[:, :64] - blk_p[:, :64]).abs().max().item(),
                    (blk_k[:, 64] - blk_p[:, 64]).abs().max().item(),
                )
                finite = bool(torch.isfinite(blk_k).all()
                              and torch.isfinite(w_k).all())
                tol = fr.KERNEL_TOL[dt]
                passed = finite and all(e <= t for e, t in zip(err, tol))
                ms = time_ms(lambda: fr.fused_render_apply(
                    kw, o, d, z, noise, exact_encode=exact))
                plain_ms = time_ms(lambda: fr.render_fwd_plain(
                    params, o, d, z, noise, 15, 4, dt, exact))
                rec = dict(S=s, dtype=dt_name, exact=exact,
                           err_weights=err[0], err_fmap=err[1],
                           err_depth=err[2], tol=tol, ms=ms,
                           plain_ms=plain_ms, ok=passed)
                records.append(rec)
                print(f"[kernel] S={s} {dt_name:8s} exact={exact!s:5s} "
                      f"max|dw|={err[0]:.3e} max|dfmap|={err[1]:.3e} "
                      f"max|ddepth|={err[2]:.3e} tol={tol} "
                      f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                      f"{'ok' if passed else 'FAIL'}")
                ok &= passed
    if fr.LAUNCH_COUNTS["fused_render_fwd"] <= before:
        raise PhaseError("kernel launch counter did not rise")
    if not ok:
        raise PhaseError("kernel disagrees with its plain version")
    return records


def serve_config(compute_dtype: str = "bfloat16"):
    """The eval leg of bench.py: 256+256 samples, 8x256 MLPs, C=64,
    appearance encoder + StyleNet + CGNet mask on a 224x160 style image."""
    from crnerf_tpu_torch import Config

    return Config(N_samples=256, N_importance=256, appearance_wh=(224, 160),
                  compute_dtype=compute_dtype)


def seeded_weights_npz(cfg, seed: int, path: str):
    """A seeded random system (PyTorch's default init, random BatchNorm
    running statistics) written as weights.npz in the JAX package's
    save_weights_only layout; returns its state_dict."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.render.system import CrNerfSystem
    from crnerf_tpu_torch.utils import weights as bridge

    torch.manual_seed(seed)
    src = CrNerfSystem(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.uniform(-0.2, 0.2, m.num_features).astype("f4")))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, m.num_features).astype("f4")))
    bridge.save_npz(bridge.flax_from_state_dict(src), path)
    return src.state_dict()


def decode_png_rgb8(data: bytes):
    """Decoder for the server's PNGs (8-bit RGB, filter 0), stdlib only."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise PhaseError("reply is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise PhaseError(f"PNG depth/type {depth}/{ctype}")
        elif tag == b"IDAT":
            idat += body
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if raw[:, 0].any():
        raise PhaseError("unexpected PNG row filter")
    return raw[:, 1:].reshape(h, w, 3)


C2W = [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 2.5]]
NEAR, FAR = 0.5, 4.5
# The card (kernel, cuDNN, cuBLAS) against the CPU (plain versions) on a
# small frame, at fp32 and bf16: (rgb max, rgb mean) abs error, rgb in
# [0, 1]. Only summation order and sin/cos ulps differ, and at bf16 both
# sides round at the same points. Measured on an H100: 6e-8 max at fp32,
# 0 at bf16, while the bf16 frame differs from the fp32 one by 1.5e-4 max,
# 5.7e-5 mean (printed beside the check): the mean bound separates them.
REF_HW = (12, 16)
REF_DTYPES = ("float32", "bfloat16")
REF_TOL = (1e-4, 1e-5)


def phase_serve(device, seed: int, workdir: str, profile_dir=None):
    """RenderService at full size through the kernel; returns (launches,
    p50 ms)."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.apps.serve import (
        RenderService,
        load_system,
        warmup,
    )
    from crnerf_tpu_torch.ops import fused_render

    cfg = serve_config()
    path = os.path.join(workdir, "weights.npz")
    want = seeded_weights_npz(cfg, seed, path)
    system = load_system(cfg, path, device)
    got = system.state_dict()
    for k, v in want.items():
        if not torch.equal(v, got[k].cpu()):
            raise PhaseError(f"weights.npz round trip changed {k}")
    svc = RenderService(cfg, system)
    wa, ha = cfg.appearance_wh
    style = np.random.default_rng(seed).uniform(
        -1, 1, (1, ha, wa, 3)).astype(np.float32)
    svc.styles["smoke"] = style
    w, h = FRAME_WH
    req = {"op": "render", "wh": [w, h], "c2w": C2W, "fov": 60.0,
           "near": NEAR, "far": FAR, "style_id": "smoke", "inline": True}
    warmup(svc, f"{w}x{h}")    # first launches: weight layout, allocator

    for k in fused_render.LAUNCH_COUNTS:
        fused_render.LAUNCH_COUNTS[k] = 0
    ping = svc.handle({"op": "ping"})
    replies = [svc.handle(req) for _ in range(N_RENDERS)]
    stats = svc.handle({"op": "stats"})
    launches = dict(fused_render.LAUNCH_COUNTS)

    if not (ping["ok"] and ping["device"] == str(device)):
        raise PhaseError(f"ping: {ping}")
    print(f"[serve] ping {ping}")
    for i, r in enumerate(replies):
        if not r.get("ok"):
            raise PhaseError(f"render {i}: {r}")
        img = decode_png_rgb8(base64.b64decode(r["png_b64"]))
        if img.shape != (h, w, 3) or img.dtype != np.uint8:
            raise PhaseError(f"render {i}: image {img.shape} {img.dtype}")
        print(f"[serve] render {i}: {r['ms']:.1f} ms, {img.shape} u8, "
              f"mean {img.mean():.2f}, min {img.min()}, max {img.max()}")
    if not stats["ok"] or stats["renders"] != N_RENDERS:
        raise PhaseError(f"stats: {stats}")
    print(f"[serve] stats {stats}")
    if launches["fused_render_fwd"] <= 0:
        raise PhaseError("the serve path never launched fused_render_fwd")
    print(f"[serve] launches {launches}")

    # full outputs (the CGNet mask included) are finite and in range
    full = svc.renderer.fetch(svc.renderer.render_frame_cam_async(
        np.asarray(C2W, np.float32), _fov_k(w, h), NEAR, FAR, (h, w),
        style, outputs="full"))
    for k, v in full.items():
        if not np.isfinite(v).all():
            raise PhaseError(f"full render: {k} not finite")
    if not (0 <= full["rgb"].min() and full["rgb"].max() <= 1
            and 0 <= full["mask"].min() and full["mask"].max() <= 1):
        raise PhaseError("full render: rgb or mask outside [0, 1]")
    print(f"[serve] full outputs finite: rgb {full['rgb'].shape}, depth "
          f"[{full['depth'].min():.3f}, {full['depth'].max():.3f}], "
          f"mask [{full['mask'].min():.3f}, {full['mask'].max():.3f}]")
    reference_check(seed, path, device, style)
    if profile_dir:
        profile_frame(svc, req, profile_dir)
    return launches["fused_render_fwd"], stats["p50_ms"]


def _fov_k(w, h):
    from crnerf_tpu_torch.render.camera_path import fov_intrinsics

    return fov_intrinsics((w, h))


def reference_check(seed: int, path: str, device, style):
    """A small frame rendered on the card (kernel) against the same
    weights on the CPU (plain versions), at fp32 and at the served bf16."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.apps.serve import load_system
    from crnerf_tpu_torch.render.inference import Renderer

    h, w = REF_HW
    out = {}
    for dt_name in REF_DTYPES:
        cfg = serve_config(dt_name)
        precision = (full_fp32 if dt_name == "float32"
                     else contextlib.nullcontext)
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            r = Renderer(cfg, load_system(cfg, path, dev))
            with precision():
                out[dt_name, where] = r.fetch(r.render_frame_cam_async(
                    np.asarray(C2W, np.float32), _fov_k(w, h), NEAR, FAR,
                    (h, w), style))
    failed = []
    tol_max, tol_mean = REF_TOL
    for dt_name in REF_DTYPES:
        err = np.abs(out[dt_name, "card"]["rgb"] - out[dt_name, "cpu"]["rgb"])
        derr = np.abs(out[dt_name, "card"]["depth"]
                      - out[dt_name, "cpu"]["depth"])
        print(f"[serve] card vs cpu {dt_name} {w}x{h}: rgb max "
              f"{err.max():.3e} mean {err.mean():.3e} (tol {tol_max}, "
              f"{tol_mean}); depth max {derr.max():.3e}")
        if err.max() > tol_max or err.mean() > tol_mean:
            failed.append(dt_name)
    cross = np.abs(out["bfloat16", "card"]["rgb"]
                   - out["float32", "cpu"]["rgb"])
    print(f"[serve] card bf16 vs cpu fp32 (what a path computed at fp32 "
          f"would differ by): rgb max {cross.max():.3e} mean "
          f"{cross.mean():.3e}")
    if failed:
        raise PhaseError(f"card render disagrees with the CPU at {failed}")


def profile_frame(svc, req, out_dir: str):
    """torch.profiler over one render: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.handle(req)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    with open(os.path.join(out_dir, "serve_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, "serve_trace.json"))
    print("[profile]\n" + table)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile_dir", type=str, default="",
                   help="also profile one serve render into this directory")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    try:
        import crnerf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"[card] {card}")
    device = torch.device("cuda", 0)
    try:
        phase_build()
        records = phase_kernel(device, SEED)
        os.makedirs(BUILD, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            launches, p50 = phase_serve(device, SEED, workdir,
                                        args.profile_dir or None)
        print(f"[serve] p50 {p50} ms per {FRAME_WH[0]}x{FRAME_WH[1]} "
              f"frame at 256+256 samples, bf16 ({card})")
    except Exception as e:  # any phase failing fails the run
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    # the serve path's pass at its own shape: S=512, bf16, recurrence
    main_kernel = next(r for r in records
                       if r["S"] == 512 and r["dtype"] == "bfloat16"
                       and not r["exact"])
    print(json.dumps({"kernels": [{
        "name": "fused_render_fwd",
        "route": "cuda",
        "source": "crnerf_tpu_torch/csrc/fused_render_fwd.cu",
        "replaces": "crnerf_tpu/ops/fused_render.py:348",
        "launches": launches,
        "max_abs_err": max(max(r["err_weights"], r["err_fmap"],
                               r["err_depth"]) for r in records),
        "ms": main_kernel["ms"],
        "plain_ms": main_kernel["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
