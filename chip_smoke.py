#!/usr/bin/env python3
"""Drive the PyTorch port (crnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # build, kernel checks, serve, train

Phases, each fatal on failure:
  1. versions, the card's name and power limit; no CUDA device -> exit 1
  2. build every kernel from csrc/ with nvcc (sm_90a), the sources side by
     side
  3. the forward kernel against its plain PyTorch version at full width
     (8x256, C=64) on 1024 rays, S=256 and S=512, bf16 and fp32, exact
     encode and the recurrence; max abs error of weights, fmap and depth
     against the stated tolerances, and the kernel's time beside the plain
     version's; then the same at the serve path's own launch, an 8192-ray
     tile at S=256 and S=512, bf16 with the recurrence; then its xyz-in
     form (one jittered coordinate per sample point) on 1024 rays x 128 in
     both dtypes and encodes and at the pertube_cord step's own launches
     (16,384 rays, S=64 and 128, bf16), where without jitter it gives the
     rays-in launch's bits
  4. the training kernels at full width on 1024 rays, S=64 and S=128, bf16
     with the recurrence and fp32 with the exact encode: the stash forward
     (outputs bit-identical to the no-stash forward, stash against the
     plain version's) and the two backward kernels against the plain
     backward on the same stash, with random non-zero cotangents; twice on
     the same inputs gives the same bits; then the same at the train
     step's own launches, 16,384 rays at S=64 and S=128, bf16 with the
     recurrence (the plain versions over 1024-ray slices of the inputs)
  4b. the recompute backward (no stash from the forward; rays-in and
     xyz-in) against its plain version at the same shapes, twice for the
     same bits, against the stash backward on the same inputs, its scratch
     rows against the stash route's, and its scratch at two batch sizes
  4c. the compositing kernel against its plain version at 8192 x 512 x 64
     and a ragged shape, on the fused forward's own sigma and features
     against the fused forward's outputs, and once as its users call it
  4d. the per-point fused MLP pair at full width: the forward against its
     plain version on 1024 x 128 points, bf16 with the recurrence and fp32
     exact, one direction per ray and one per point, a ragged shape, then
     at the launches of its paths (16,384 x 64 and x 128, 8192 x 256 and x
     512, bf16), and through composite against the fused render's xyz-in
     ray block at fp32; the backward against its plain version on one
     shared forward (tight bound) and from the inputs (loose bound), twice
     for the same bits, at its own slab size against one slab, and its
     scratch at two batch sizes
  4e. the conv spikes' kernels (S1, S4) and the sincos kernel (S3): the 3x3
     conv forward and its weight gradient at the spike's shape (8 x 160 x
     224, 64 -> 64), at enc_a's conv3 in the train step (16 x 160 x 224,
     64 -> 64) and at two ragged shapes, the gradient twice for the same
     bits; the packed 2x2 conv at the encoder's two levels (4C = 256, 512)
     and at two ragged shapes, and, after _d2s, against the 3x3 conv of the
     reflect-padded original; sin/cos at the spike's five scales against
     float64 (the fast intrinsics' error printed); each kernel against its
     plain version, with its time beside the plain version's, cuDNN's (or
     torch.sin + torch.cos) and its bound; then the three spike tools as a
     user runs them, counters zeroed before and read after
  4f. the last two spikes' kernels: the pipelined fused render forward (S2)
     against the fused render forward (K1) on the same inputs, for every
     rays-per-CTA P, at 1024 rays x S=256 and 512, at the spike's 8192 x
     128 and at the serve tile, 8192 x 512 (the same bits), and against
     its plain version on 1024 rays; the encode-block assembly (S5) in its
     three modes against its plain version on real (sin, cos) states at
     2048 tiles and at an odd 37: the outputs, the bf16 blocks themselves
     (the same bits in base and stores) and the rows it zeroes; times
     beside K1's (S2) or cuBLAS's (S5) and the bounds; then the two spike
     tools as a user runs them, counters zeroed before and read after
  5. serve at full size: RenderService with seeded random weights
     round-tripped through a weights.npz and the weight bridge, ping,
     2 inline 320x240 renders at 256+256 samples, stats; the launch
     counters are zeroed just before and read just after
  6. train at full size: the flagship config (16 grids of 1024 rays, 64+64
     samples, 8x256, bf16) on the synthetic scene through make_train_step;
     warm-up, timed steps, one profiled step, CGNet's mask and parameter
     gradients on the step's style images with TF32 allowed in cuDNN, as a
     user's process has it, against the same with TF32 off (the same bits:
     its convolutions are pinned to IEEE fp32), and a small fp32 step on
     the card against the same step on the CPU; the
     launch counters are zeroed just before the timed steps and read just
     after
  7. the two no-stash routes of the same step, pallas_stash=False (rays-in
     forward, recompute backward) and pertube_cord=True (xyz-in forward,
     recompute backward): warm-up, timed steps, launch counters, no stash
     alive after a forward, peak memory beside the stash route's, a small
     fp32 step of each on the card against the CPU, and pallas_stash=False
     against the stash route on the same batch and draws
  8. the per-point route, pallas_render=False, through the same entry
     points: 2 served frames (two fused-MLP launches per tile, none of the
     fused render's) against the full route's frame, a small frame card
     against CPU; the flagship training step (one fused-MLP forward and
     one backward launch per pass, none of the fused render's), a small
     fp32 step card against CPU, its NeRF gradients against the stash
     route's; and one timed reading of the module route, pallas_train=False
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
SERVE_TILE = 8192     # rays per launch on the serve path (Config.chunk)
FRAME_WH = (320, 240)
N_RENDERS = 2
SEED = 0
TRAIN_GRIDS = 16
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_STAGED = 2, 4, 2
# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def _counters():
    from crnerf_tpu_torch.ops import (
        conv,
        fused_mlp,
        fused_render,
        pipe_render,
        sincos,
        sublane_stores,
    )

    return (fused_render.LAUNCH_COUNTS, fused_mlp.LAUNCH_COUNTS,
            conv.LAUNCH_COUNTS, sincos.LAUNCH_COUNTS,
            pipe_render.LAUNCH_COUNTS, sublane_stores.LAUNCH_COUNTS)


def zero_counts():
    """Every kernel's launch count to 0 (the compositing kernel's has its
    own phase)."""
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_counts():
    """The launch counts of the fused render, fused MLP, conv, sincos,
    pipelined render and sublane-stores kernels."""
    return {k: v for counts in _counters() for k, v in counts.items()}


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
    """One nvcc per source, all started together."""
    import threading

    from crnerf_tpu_torch.ops import (
        _build,
        composite,
        conv,
        fused_mlp,
        fused_render,
        pipe_render,
        sincos,
        sublane_stores,
    )

    t0 = time.perf_counter()
    errors = []

    def build(loader):
        try:
            loader()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    loaders = {"fused_render_fwd.cu": fused_render._lib,
               "fused_render_bwd.cu": fused_render._lib_bwd,
               "fused_render_bwd_recompute.cu": fused_render._lib_recompute,
               "composite.cu": composite._lib,
               "fused_mlp_fwd.cu": fused_mlp._lib_fwd,
               "fused_mlp_bwd.cu": fused_mlp._lib_bwd,
               "conv.cu": conv._lib,
               "sincos.cu": sincos._lib,
               "pipe_render_fwd.cu": pipe_render._lib,
               "sublane_stores.cu": sublane_stores._lib}
    threads = [threading.Thread(target=build, args=(f,))
               for f in loaders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    dt = time.perf_counter() - t0
    for source in loaders:
        log = _build.BUILD_LOG.get(source, "(cached build)")
        print(f"[build] {source} (all {len(loaders)} sources in {dt:.1f} s)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("[build]  " + line.strip())


def ray_slices(n: int):
    """N_RAYS-ray slices of n rays: a plain version holds a dozen fp32
    copies of its points' activations, so at the main paths' launch shapes
    it runs slice by slice over the kernel's inputs."""
    return [slice(i, min(i + N_RAYS, n)) for i in range(0, n, N_RAYS)]


def ray_inputs(n: int, s: int, gen, device):
    """Seeded origins, unit directions, sorted z and sigma noise."""
    import torch

    o = torch.randn(n, 3, generator=gen, device=device) * 0.5
    d = torch.randn(n, 3, generator=gen, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    z = torch.sort(torch.rand(n, s, generator=gen, device=device) * 4.0
                   + 0.5, -1).values
    noise = torch.randn(n, s, generator=gen, device=device)
    return o, d, z, noise


def drain(it):
    for _ in it:
        pass


def jittered_points(o, d, z, gen):
    """The rays' sample points o + d*z moved by 1e-5 * U[0, 1): (N, S, 3)
    f32, as the pertube_cord renderer makes them."""
    import torch

    u = torch.rand((*z.shape, 3), generator=gen, device=z.device)
    return (o[:, None, :] + d[:, None, :] * z[..., None]
            + 1e-5 * u).contiguous()


def forward_case(device, params, gen, n: int, s: int, dt, exact: bool,
                 xyz_in: bool = False):
    """The forward kernel on n rays x s samples against render_fwd_plain
    on the same inputs (slice by slice) -> record. ``xyz_in``: the kernel's
    xyz-in form on jittered points; and with the unjittered points handed
    in as xyz it must give the rays-in launch's bits."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    o, d, z, noise = ray_inputs(n, s, gen, device)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    xyz = jittered_points(o, d, z, gen) if xyz_in else None

    def plain():        # one slice's results alive at a time
        for sl in ray_slices(n):
            yield sl, fr.render_fwd_plain(
                params, o[sl], d[sl], z[sl], noise[sl], 15, 4, dt, exact,
                xyz=None if xyz is None else xyz[sl])

    def kernel():
        return fr.fused_render_apply(kw, None if xyz_in else o, d, z, noise,
                                     exact_encode=exact, xyz=xyz)

    err = [0.0, 0.0, 0.0]
    same_bits = True
    with full_fp32():
        blk_k, w_k = kernel()
        if xyz_in:
            exact_pts = (o[:, None, :] + d[:, None, :]
                         * z[..., None]).contiguous()
            blk_x, w_x = fr.fused_render_apply(kw, None, d, z, noise,
                                               exact_encode=exact,
                                               xyz=exact_pts)
            blk_r, w_r = fr.fused_render_apply(kw, o, d, z, noise,
                                               exact_encode=exact)
            same_bits = torch.equal(blk_x, blk_r) and torch.equal(w_x, w_r)
            del exact_pts, blk_x, w_x, blk_r, w_r
        for sl, (blk_p, w_p) in plain():
            for i, e in enumerate((
                    (w_k[sl] - w_p).abs().max().item(),
                    (blk_k[sl, :64] - blk_p[:, :64]).abs().max().item(),
                    (blk_k[sl, 64] - blk_p[:, 64]).abs().max().item())):
                err[i] = max(err[i], e)
    tol = fr.KERNEL_TOL[dt]
    passed = (bool(torch.isfinite(blk_k).all() and torch.isfinite(w_k).all())
              and all(e <= t for e, t in zip(err, tol)) and same_bits)
    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: drain(plain()), reps=3 if n == N_RAYS else 1)
    f_fwd, _, _ = mlp_work(params)
    # per ray the forward reads [o | d] (or 3 coordinates a point), z,
    # noise and the dir encode and writes the ray block and the weights,
    # all f32
    b_ms, b_by = bound(n * s * f_fwd,
                       n * ((3 * s if xyz_in else 8) + 2 * s + 27 + 128
                            + s) * 4, dt == torch.bfloat16)
    dt_name = str(dt)[6:]
    form = ("xyz-in, no-jitter bits equal rays-in "
            f"{same_bits}, " if xyz_in else "")
    print(f"[kernel] {form}{n} rays x S={s} {dt_name:8s} exact={exact!s:5s} "
          f"max|dw|={err[0]:.3e} max|dfmap|={err[1]:.3e} "
          f"max|ddepth|={err[2]:.3e} tol={tol} kernel {ms:.3f} ms "
          f"({n * s * f_fwd / ms / 1e9:.0f} TFLOP/s) plain {plain_ms:.3f} "
          f"ms bound {b_ms:.3f} ms ({b_by}) {'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, exact=exact, xyz_in=xyz_in,
                err_weights=err[0], err_fmap=err[1], err_depth=err[2],
                tol=tol, ms=ms, plain_ms=plain_ms, bound=(b_ms, b_by),
                ok=passed)


def phase_kernel(device, seed: int):
    """The forward kernel against its plain version: 1024 rays at S=256
    and S=512 in both dtypes and encodes, then the serve path's own launch
    (SERVE_TILE rays, bf16, recurrence), then the xyz-in form. Returns the
    per-case records."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cases = [(N_RAYS, s, dt, exact) for s in (256, 512)
             for dt in (torch.bfloat16, torch.float32)
             for exact in (True, False)]
    cases += [(SERVE_TILE, s, torch.bfloat16, False) for s in (256, 512)]
    # the xyz-in form: 1024 rays, then the pertube_cord step's own launches
    cases += [(N_RAYS, 128, dt, exact, True)
              for dt in (torch.bfloat16, torch.float32)
              for exact in (True, False)]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, True)
              for s in (64, 128)]
    before = dict(fr.LAUNCH_COUNTS)
    records = [forward_case(device, params, gen, *case) for case in cases]
    if any(fr.LAUNCH_COUNTS[k] <= before[k]
           for k in ("fused_render_fwd", "fused_render_fwd_xyz")):
        raise PhaseError("kernel launch counter did not rise")
    if not all(r["ok"] for r in records):
        raise PhaseError("kernel disagrees with its plain version")
    return records


def serve_config(compute_dtype: str = "bfloat16", **kw):
    """The eval leg of bench.py: 256+256 samples, 8x256 MLPs, C=64,
    appearance encoder + StyleNet + CGNet mask on a 224x160 style image.
    ``kw``: the fields that select another route."""
    from crnerf_tpu_torch import Config

    return Config(N_samples=256, N_importance=256, appearance_wh=(224, 160),
                  compute_dtype=compute_dtype, **kw)


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


# The per-point route's frame against the full route's, same weights, style
# and camera, bf16: (rgb max, rgb mean, depth max). The two differ in the
# sigma head's policy (fp32 on unrounded weights against bf16) and in where
# the compositing sums run: the size of what bf16 against fp32 changes in a
# frame (the reference check prints it), so the rgb mean bound is that
# check's, the rgb max bound one bf16 step of a value near 1, and the depth
# bound the forward kernel's own at bf16 (depth is fp32 and not quantised
# by the decoder, so it is the number that can show a difference).
ROUTE_FRAME_TOL = (4e-3, 1e-4, 5e-3)


def phase_serve(device, seed: int, workdir: str, profile_dir=None,
                full_frame=None, **route):
    """RenderService at full size through the kernels of the route that
    ``route`` (Config fields) selects; returns (launches of its forward
    kernel, p50 ms, the frame's float outputs). ``full_frame``: the full
    route's frame, which a per-point route's must match."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.apps.serve import (
        RenderService,
        load_system,
        warmup,
    )
    cfg = serve_config(**route)
    key = "fused_render_fwd" if cfg.pallas_render else "fused_mlp_fwd"
    tag = "serve" if cfg.pallas_render else "serve pallas_render=False"
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

    zero_counts()
    ping = svc.handle({"op": "ping"})
    replies = [svc.handle(req) for _ in range(N_RENDERS)]
    stats = svc.handle({"op": "stats"})
    launches = read_counts()

    if not (ping["ok"] and ping["device"] == str(device)):
        raise PhaseError(f"ping: {ping}")
    print(f"[{tag}] ping {ping}")
    for i, r in enumerate(replies):
        if not r.get("ok"):
            raise PhaseError(f"render {i}: {r}")
        img = decode_png_rgb8(base64.b64decode(r["png_b64"]))
        if img.shape != (h, w, 3) or img.dtype != np.uint8:
            raise PhaseError(f"render {i}: image {img.shape} {img.dtype}")
        print(f"[{tag}] render {i}: {r['ms']:.1f} ms, {img.shape} u8, "
              f"mean {img.mean():.2f}, min {img.min()}, max {img.max()}")
    if not stats["ok"] or stats["renders"] != N_RENDERS:
        raise PhaseError(f"stats: {stats}")
    print(f"[{tag}] stats {stats}")
    # a coarse and a fine launch per tile of Config.chunk rays, nothing else
    tiles = -(-w * h // cfg.chunk)
    want = {k: (2 * tiles * N_RENDERS if k == key else 0) for k in launches}
    if launches != want:
        raise PhaseError(f"{tag}: launch counters {launches}, expected "
                         f"{want}")
    print(f"[{tag}] launches {launches} ({tiles} tiles a frame)")

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
    print(f"[{tag}] full outputs finite: rgb {full['rgb'].shape}, depth "
          f"[{full['depth'].min():.3f}, {full['depth'].max():.3f}], "
          f"mask [{full['mask'].min():.3f}, {full['mask'].max():.3f}]")
    if full_frame is not None:
        err = np.abs(full["rgb"] - full_frame["rgb"])
        derr = np.abs(full["depth"] - full_frame["depth"]).max()
        print(f"[{tag}] against the full route's frame: rgb max "
              f"{err.max():.3e} mean {err.mean():.3e}, depth max {derr:.3e} "
              f"(bounds {ROUTE_FRAME_TOL})")
        if (err.max() > ROUTE_FRAME_TOL[0] or err.mean() > ROUTE_FRAME_TOL[1]
                or derr > ROUTE_FRAME_TOL[2]):
            raise PhaseError(f"{tag}: the frame differs from the full "
                             "route's")
    reference_check(seed, path, device, style, tag, **route)
    if profile_dir:
        profile_frame(svc, req, profile_dir)
    return launches[key], stats["p50_ms"], full


def _fov_k(w, h):
    from crnerf_tpu_torch.render.camera_path import fov_intrinsics

    return fov_intrinsics((w, h))


def reference_check(seed: int, path: str, device, style, tag="serve",
                    **route):
    """A small frame rendered on the card (kernel) against the same
    weights on the CPU (plain versions), at fp32 and at the served bf16,
    on the route that ``route`` selects."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.apps.serve import load_system
    from crnerf_tpu_torch.render.inference import Renderer

    h, w = REF_HW
    out = {}
    for dt_name in REF_DTYPES:
        cfg = serve_config(dt_name, **route)
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
        print(f"[{tag}] card vs cpu {dt_name} {w}x{h}: rgb max "
              f"{err.max():.3e} mean {err.mean():.3e} (tol {tol_max}, "
              f"{tol_mean}); depth max {derr.max():.3e}")
        if err.max() > tol_max or err.mean() > tol_mean:
            failed.append(dt_name)
    cross = np.abs(out["bfloat16", "card"]["rgb"]
                   - out["float32", "cpu"]["rgb"])
    print(f"[{tag}] card bf16 vs cpu fp32 (what a path computed at fp32 "
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


def mlp_work(params):
    """Operations per sample point of one pass, from the weights' shapes:
    (forward, backward chain, backward weight gradient) in FLOP, products
    only (2 per multiply-add)."""
    mats = [*params.trunk_w, params.sigma_w, params.final_w, params.dir_w,
            params.feat_w]
    fwd = 2.0 * sum(m.numel() for m in mats)
    width = params.final_w.shape[0]
    d_xyz = params.trunk_w[0].shape[0]
    # the chain: the sigma head once and the feature head twice again (one
    # pass per phase), then dz @ W^T through the feature head, the dir
    # layer's hidden rows, the final layer, the sigma head and the hidden
    # rows of trunk layers 1..L-1
    hidden = sum(w.shape[0] - (d_xyz if w.shape[0] > width else 0)
                 for w in params.trunk_w[1:]) * width
    chain = 2.0 * (2 * params.sigma_w.numel() + 3 * params.feat_w.numel()
                   + width * params.dir_w.shape[1] + params.final_w.numel()
                   + hidden)
    return fwd, chain, fwd


def bound(flops, nbytes, bf16=True):
    """-> (bound_ms, bound_by): the larger of operations over the peak
    rate of their type and bytes over the memory rate."""
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# Stash of the kernel against the plain version's, over the largest
# activation. fp32: summation order only. bf16: equal apart from values
# whose fp32 sum fell on the other side of a rounding boundary and what
# those carry downstream: (share of entries that may differ, largest
# difference).
STASH_TOL_FP32 = 1e-4
STASH_TOL_BF16 = (0.02, 1.0 / 64)


def train_config(**kw):
    """The train leg of bench.py at the Config defaults: 16 grids of
    32x32 rays, 64 + 64 samples, 8x256 MLPs, C=64, bf16, Adam 5e-4."""
    from crnerf_tpu_torch import Config

    base = dict(appearance_wh=(224, 160), compute_dtype="bfloat16",
                grids_per_step=TRAIN_GRIDS, N_vocab=1500)
    base.update(kw)
    return Config(**base)


def make_trainer(cfg, device, seed: int, scene_wh, chunks: int):
    """Seeded system, optimizer, state, step function and staged batches on
    ``device``, through the entry points a user would call."""
    import torch

    from crnerf_tpu_torch.data.pipeline import TrainPipeline
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from crnerf_tpu_torch.render.system import CrNerfSystem
    from crnerf_tpu_torch.train.optim import make_optimizer
    from crnerf_tpu_torch.train.state import TrainState
    from crnerf_tpu_torch.train.step import make_train_step

    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=scene_wh,
                                 appearance_wh=cfg.appearance_wh)
    pipe = TrainPipeline(scene, batch_size=cfg.batch_size)
    torch.manual_seed(seed)
    system = CrNerfSystem(cfg).to(device)
    opt, sched = make_optimizer(cfg, pipe.iterations, system.parameters())
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    state = TrainState.create(system, opt, cfg.N_vocab, 32, cfg.nerf_out_dim,
                              generator=gen)
    step = make_train_step(system, opt, sched,
                           grids_per_step=cfg.grids_per_step,
                           grad_accum_chunks=chunks)
    staged = [{k: torch.from_numpy(v).to(device)
               for k, v in pipe.make_global_batch(
                   0, i, cfg.grids_per_step).items()}
              for i in range(TRAIN_STAGED)]
    return state, step, staged


def timed_steps(state, step, staged, n: int, first: int = 0):
    """-> (ms per step, losses as floats, last metrics)."""
    import torch

    times, losses, m = [], [], None
    for i in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, staged[i % len(staged)])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    return times, losses, m


def profile_step(state, step, batch, out_dir, step_ms: float):
    """torch.profiler over one step: device time by kind of kernel, and
    the device's idle share against ``step_ms``, the median step measured
    without the profiler (tracing ~4,000 launches slows the host several
    times over, so the profiled step's own wall clock says nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = (("K1 render_fwd_kernel (every form)", ("render_fwd_kernel",)),
             ("K2 chain render_bwd_chain_kernel",
              ("render_bwd_chain_kernel",)),
             ("K4 mlp_fwd_kernel (forward and the backward's recompute)",
              ("mlp_fwd_kernel",)),
             ("K4 chain mlp_bwd_chain_kernel", ("mlp_bwd_chain_kernel",)),
             ("wgrad_bf16_kernel + reduce_partials",
              ("wgrad_bf16_kernel", "wgrad_f32_kernel",
               "reduce_partials_kernel")),
             ("convolutions (cuDNN)", ("conv", "cudnn", "wgrad", "dgrad",
                                       "implicit_gemm", "xmma", "cutlass")),
             ("sort", ("sort", "radix", "merge")),
             ("Adam", ("adam", "multi_tensor_apply")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kind = {k: 0.0 for k, _ in kinds}
    by_kind["everything else"] = 0.0
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        ms = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        for kind, words in kinds:
            if any(w in low for w in words):
                by_kind[kind] += ms
                break
        else:
            by_kind["everything else"] += ms
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40))
    if n_kernels == 0:
        print("[train] profiler saw no device events: device time by "
              "kernel and idle share not measured")
        return
    busy = sum(by_kind.values())
    print(f"[train] one profiled step: {wall_ms:.1f} ms wall under the "
          f"profiler, {n_kernels} device events, device busy {busy:.1f} ms")
    for kind, ms in by_kind.items():
        print(f"[train]   {kind}: {ms:.2f} ms ({100 * ms / busy:.1f}% of "
              f"device time)")
    print(f"[train]   device idle share "
          f"{100 * max(0.0, 1 - busy / step_ms):.1f}% of the {step_ms:.1f} "
          f"ms median step")


# The small fp32 step on the card against the same step on the CPU, same
# injected draws, SGD so that the parameter delta is linear in the
# gradient. Bounds, relative: every loss term; every parameter tensor's
# delta over its largest entry, after allowing each side one ulp of the
# parameter (a delta is a difference of two roundings). Measured on an
# H100: 2.7e-7 for the losses, 6e-6 for the deltas (CGNet's; 0 elsewhere).
SMALL_STEP_TOL = dict(loss=1e-4, delta=1e-3)

# The training routes: Config fields that select them, and the kernels one
# pass of a step launches (forward, then backward).
ROUTES = {
    "stash": (dict(), ("fused_render_fwd_stash", "fused_render_bwd",
                       "fused_render_bwd_wgrad")),
    "pallas_stash=False": (dict(pallas_stash=False),
                           ("fused_render_fwd",
                            "fused_render_bwd_recompute")),
    "pertube_cord=True": (dict(pertube_cord=True),
                          ("fused_render_fwd_xyz",
                           "fused_render_bwd_recompute_xyz")),
    "pallas_render=False": (dict(pallas_render=False),
                            ("fused_mlp_fwd", "fused_mlp_bwd")),
}


def small_step_check(device, seed: int, route: str = "stash"):
    """-> the card's gradients of that step, by parameter name."""
    import torch

    cfg = train_config(
        compute_dtype="float32", grids_per_step=2, batch_size=64,
        N_samples=8, N_importance=8, netdepth=6, netwidth=64,
        nerf_out_dim=16, N_emb_xyz=10, N_vocab=8, appearance_wh=(64, 48),
        optimizer="sgd", momentum=0.0, lr=0.05, **ROUTES[route][0])
    g, b, s, i = 2, 64, 8, 8
    gen = torch.Generator().manual_seed(seed + 3)
    draws = {"z_u": torch.rand(g, b, s, generator=gen),
             "noise_coarse": torch.randn(g, b, s, generator=gen),
             "noise_fine": torch.randn(g, b, s + i, generator=gen),
             "pdf_e": torch.empty(g, b, i + 1).exponential_(generator=gen),
             # read by the pertube_cord route only
             "pertube_coarse": torch.rand(g, b, s, 3, generator=gen),
             "pertube_fine": torch.rand(g, b, s + i, 3, generator=gen)}
    out = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        state, step, staged = make_trainer(cfg, dev, seed, (24, 18), 1)
        before = {k: v.detach().clone()
                  for k, v in state.system.named_parameters()}
        with full_fp32():
            state, m = step(state, staged[0],
                            {k: v.to(dev) for k, v in draws.items()})
        out[where] = (
            {k: float(v) for k, v in m.items()},
            {k: (v.detach() - before[k]).cpu()
             for k, v in state.system.named_parameters()},
            {k: float(v.abs().max()) for k, v in before.items()})
        if where == "card":
            grads = {k: v.grad.detach().clone()
                     for k, v in state.system.named_parameters()}
    worst = dict(loss=0.0, delta=0.0)
    for k, v in out["cpu"][0].items():
        rel = abs(out["card"][0][k] - v) / max(abs(v), 1e-12)
        worst["loss"] = max(worst["loss"], rel)
    for k, d_cpu in out["cpu"][1].items():
        scale = float(d_cpu.abs().max())
        if scale == 0.0:
            continue
        ulps = 2 * torch.finfo(torch.float32).eps * out["cpu"][2][k]
        diff = float((out["card"][1][k] - d_cpu).abs().max())
        rel = max(0.0, diff - ulps) / scale
        worst["delta"] = max(worst["delta"], rel)
    print(f"[train] {route}: small fp32 step, card vs cpu: losses "
          f"{out['card'][0]['loss']:.6f} vs {out['cpu'][0]['loss']:.6f}; "
          f"worst relative difference {worst} (bounds {SMALL_STEP_TOL})")
    bad = [k for k, v in worst.items() if not v <= SMALL_STEP_TOL[k]]
    if bad:
        raise PhaseError(f"{route}: card step disagrees with the CPU step "
                         f"in {bad}")
    return grads


def stashes_alive_after_forward(state, batch):
    """One forward of the step's system under autograd -> for each fused
    render or fused MLP pass on the graph, whether a stash lives on it (a
    fused MLP pass saves its points and directions, nothing else)."""
    import torch

    state.system.train()
    with torch.enable_grad():
        res = state.system.forward_train(batch, generator=state.generator)
    todo = [res[k].grad_fn for k in ("feature_coarse", "feature_fine")]
    seen, found = set(), []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "FusedRenderTrainBackward":
            found.append(node.stash is not None)
            continue
        if type(node).__name__ == "FusedMlpTrainBackward":
            found.append(any(t.shape[-1] != 3 for t in node.saved_tensors))
            continue
        todo.extend(fn for fn, _ in node.next_functions)
    return found


def phase_train(device, seed: int, profile_dir=None, route: str = "stash"):
    """The flagship train step on the card through make_train_step, on
    one of ``ROUTES``. Returns (launch counts of the timed steps, median
    ms per step, peak GiB, the small step's gradients on the card)."""
    import statistics

    import torch

    cfg = train_config(**ROUTES[route][0])
    chunks = cfg.resolved_chunks()
    state, step, staged = make_trainer(cfg, device, seed, (112, 84), chunks)
    alive = stashes_alive_after_forward(state, staged[0])
    if alive != [route == "stash"] * 2:
        raise PhaseError(f"{route}: stash alive after the forward of the "
                         f"two passes: {alive}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, warm_losses, _ = timed_steps(state, step, staged, TRAIN_WARMUP)
    zero_counts()
    times, losses, m = timed_steps(state, step, staged, TRAIN_STEPS,
                                   first=TRAIN_WARMUP)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    all_losses = warm_losses + losses
    if not all(map(lambda x: x == x and abs(x) != float("inf"), all_losses)):
        raise PhaseError(f"non-finite loss: {all_losses}")
    for k, v in m.items():
        if not torch.isfinite(torch.as_tensor(v)).all():
            raise PhaseError(f"metric {k} not finite")
    for name, p in state.system.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise PhaseError(f"gradient of {name} missing or not finite")
    per_step = 2 * chunks     # coarse + fine pass of every chunk
    want = {k: (per_step * TRAIN_STEPS if k in ROUTES[route][1] else 0)
            for k in launches}
    if launches != want:
        raise PhaseError(f"{route}: launch counters {launches}, expected "
                         f"{want}")
    ts = torch.unique(torch.cat([b["ts"][:, 0] for b in staged]).long())
    valid = state.embedding_valid
    if not (valid[ts].all() and int(valid.sum()) == ts.numel()
            and state.embedding_cache[ts].abs().sum(1).min() > 0):
        raise PhaseError("the embedding cache did not gain the steps' rows")
    n = TRAIN_STAGED
    first, last = sum(all_losses[:n]) / n, sum(all_losses[-n:]) / n
    if not last < first:
        raise PhaseError(f"loss did not fall: first {first}, last {last} "
                         f"({all_losses})")
    med = statistics.median(times)
    rays = cfg.grids_per_step * cfg.batch_size
    print(f"[train] route {route}: no stash alive after a forward: "
          f"{not any(alive)}")
    print(f"[train] losses {' '.join(f'{x:.5f}' for x in all_losses)}")
    print(f"[train] {route}: {TRAIN_STEPS} steps of {cfg.grids_per_step} x "
          f"{cfg.batch_size} rays, 64+64 samples, bf16, C={chunks}: median "
          f"{med:.2f} ms per step (range {min(times):.2f}-{max(times):.2f}), "
          f"{rays / med * 1e3:.0f} train rays/s, peak memory "
          f"{peak_gb:.2f} GiB, psnr {float(m['psnr']):.2f} dB")
    print(f"[train] launches in the timed steps {launches}")
    if route != "pertube_cord=True":     # its kernels are the same two
        profile_step(state, step, staged[0],
                     profile_dir if route == "stash" else None, med)
    if route == "stash":
        tf32_check(state, staged[0])
    del state, step, staged
    grads = small_step_check(device, seed, route)
    return launches, med, peak_gb, grads


def routes_agree(a: str, grads_a, b: str, grads_b, tol: float = 1e-5):
    """Two routes' gradients of the small fp32 step on the card, same
    batch and draws: per parameter, the difference over the largest
    entry. The routes differ in the two NeRF MLPs' backward only, where
    they compute the same dz rows and group the fp32 sums over the points
    differently: those parameters are held to ``tol``. The other modules'
    gradients are printed: they run the same code on both routes, and
    cuDNN's convolution backward does not repeat its own bits (measured
    1.3e-4 between two such steps on an H100)."""
    worst = {True: (0.0, ""), False: (0.0, "")}
    for k, g in grads_a.items():
        scale = float(g.abs().max())
        if scale == 0.0:
            continue
        rel = float((grads_b[k] - g).abs().max()) / scale
        nerf = k.startswith(("nerf_coarse.", "nerf_fine."))
        if rel > worst[nerf][0]:
            worst[nerf] = (rel, k)
    print(f"[train] {b} against {a}, small fp32 step on the card: the NeRF "
          f"MLPs' gradients differ by at most {worst[True][0]:.3e} of a "
          f"parameter's largest ({worst[True][1]}; bound {tol}), the other "
          f"modules' by {worst[False][0]:.3e} ({worst[False][1]})")
    if not worst[True][0] <= tol:
        raise PhaseError(f"{b} disagrees with {a} in {worst[True][1]}")


def train_kernel_bounds(params, kw, pts: int, bf16: bool):
    """Bounds of the training kernels over ``pts`` sample points: each
    kernel alone (the chain writes the dz buffer and the weight gradient
    reads it back), and the backward as a whole, the function the two
    replace: stash in, weight gradients out, no dz in device memory."""
    from crnerf_tpu_torch.ops import fused_render as fr

    lay = fr.grad_layout(kw.dims)
    esz = 2 if bf16 else 4
    f_fwd, f_chain, f_wgrad = mlp_work(params)
    return dict(
        fwd_stash=bound(pts * f_fwd, pts * lay.sc * esz, bf16),
        chain=bound(pts * f_chain,
                    pts * (lay.o_hf + kw.dims["HP"] + lay.dc) * esz, bf16),
        wgrad=bound(pts * f_wgrad,
                    pts * (lay.sc + lay.dc) * esz + lay.wt * 4, bf16),
        bwd_whole=bound(pts * (f_chain + f_wgrad),
                        pts * lay.sc * esz + (lay.wt + lay.bt) * 4, bf16),
    )


def train_kernels_case(device, params, gen, n: int, s: int, dt,
                       exact: bool):
    """K1-stash and the two K2 kernels on n rays x s samples against their
    plain versions on the same inputs, stash and random non-zero
    cotangents. The plain versions run over 1024-ray slices, and the
    slices' gradients are summed in fp64. -> record."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    c = 64
    bf16 = dt == torch.bfloat16
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    lay = fr.grad_layout(kw.dims)
    slices = ray_slices(n)
    o, d, z, noise = ray_inputs(n, s, gen, device)
    g_ray = torch.zeros(n, fr._round_up(c + 1, fr.LANE), device=device)
    g_ray[:, :c + 1] = torch.randn(n, c + 1, generator=gen,
                                   device=device) * 0.1
    g_w = torch.randn(n, s, generator=gen, device=device) * 0.1
    dir_blk = fr.dir_block(kw, d, exact)

    def points(sl):
        return slice(sl.start * s, sl.stop * s)

    def fwd_plain():        # one slice's results alive at a time
        for sl in slices:
            yield fr.render_fwd_plain(params, o[sl], d[sl], z[sl], noise[sl],
                                      15, 4, dt, exact, stash=True)

    def chain_plain(st):
        for sl in slices:
            yield fr.bwd_chain_plain(kw, z[sl], noise[sl], dir_blk[sl],
                                     st[points(sl)], g_ray[sl], g_w[sl])

    def wgrad_plain(st, dz):
        gw = torch.zeros(lay.wt, dtype=torch.float64, device=device)
        for sl in slices:
            gw += fr.bwd_wgrad_plain(kw, st[points(sl)], dz[points(sl)])
        return gw

    with full_fp32():
        blk0, w0, _ = fr.render_fwd(kw, o, d, z, noise, exact, stash=False)
        blk1, w1, st = fr.render_fwd(kw, o, d, z, noise, exact, stash=True)
        dz_k, gb_k = fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w)
        gw_k = fr.bwd_wgrad(kw, st, dz_k)
        dz_2, gb_2 = fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w)
        gw_2 = fr.bwd_wgrad(kw, st, dz_2)
        repeat_bits = (torch.equal(dz_k, dz_2) and torch.equal(gb_k, gb_2)
                       and torch.equal(gw_k, gw_2))
        del dz_2
        err_fwd = st_differ = st_max = st_scale = 0.0
        for sl, (blk_p, w_p, st_p) in zip(slices, fwd_plain()):
            err_fwd = max(err_fwd, (w1[sl] - w_p).abs().max().item(),
                          (blk1[sl, :c + 1] - blk_p[:, :c + 1]).abs().max()
                          .item())
            diff = (st[points(sl)].float() - st_p.float()).abs()
            st_differ += (diff > 0).sum().item()
            st_max = max(st_max, diff.max().item())
            st_scale = max(st_scale, st_p.float().abs().max().item())
        gb_p = torch.zeros(lay.bt, dtype=torch.float64, device=device)
        gw_p = torch.zeros(lay.wt, dtype=torch.float64, device=device)
        for sl, (dz_p, gb_s) in zip(slices, chain_plain(st)):
            gb_p += gb_s
            gw_p += fr.bwd_wgrad_plain(kw, st[points(sl)], dz_p)
        # each kernel alone against its plain version on the same inputs
        gw_on_kernel_dz = wgrad_plain(st, dz_k)
        torch.cuda.synchronize()
    same_bits = torch.equal(blk0, blk1) and torch.equal(w0, w1)
    st_frac, st_max = st_differ / st.numel(), st_max / st_scale
    if bf16:
        st_ok = st_frac <= STASH_TOL_BF16[0] and st_max <= STASH_TOL_BF16[1]
    else:
        st_ok = st_max <= STASH_TOL_FP32
    got = fr.flatten_params(fr.unpack_grads(kw, gw_k, gb_k))
    want = fr.flatten_params(fr.unpack_grads(kw, gw_p, gb_p))
    rel = [((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
           for a, b in zip(want, got)]
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    abs_chain = (gb_k - gb_p).abs().max().item()
    abs_wgrad = (gw_k - gw_on_kernel_dz).abs().max().item()
    err_chain = abs_chain / gb_p.abs().max().item()
    err_wgrad = abs_wgrad / gw_on_kernel_dz.abs().max().item()
    passed = (same_bits and repeat_bits and st_ok and finite
              and max(rel) <= fr.GRAD_TOL[dt]
              and err_fwd <= max(fr.KERNEL_TOL[dt]))
    t_nostash = time_ms(lambda: fr.render_fwd(kw, o, d, z, noise, exact,
                                              stash=False))
    ms = dict(
        fwd_stash=time_ms(lambda: fr.render_fwd(kw, o, d, z, noise, exact,
                                                stash=True)),
        chain=time_ms(lambda: fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray,
                                           g_w)),
        wgrad=time_ms(lambda: fr.bwd_wgrad(kw, st, dz_k)),
    )
    reps = 3 if n == N_RAYS else 1
    plain = dict(fwd_stash=time_ms(lambda: drain(fwd_plain()), reps),
                 chain=time_ms(lambda: drain(chain_plain(st)), reps),
                 wgrad=time_ms(lambda: wgrad_plain(st, dz_k), reps))
    pts = n * s
    bounds = train_kernel_bounds(params, kw, pts, bf16)
    work = dict(zip(("fwd_stash", "chain", "wgrad"), mlp_work(params)))
    each = " ".join(
        f"{k} {ms[k]:.3f}/{plain[k]:.3f}/{bounds[k][0]:.3f} "
        f"({pts * work[k] / ms[k] / 1e9:.0f} TFLOP/s)" for k in work)
    dt_name = str(dt)[6:]
    print(f"[train-kernel] {n} rays x S={s} {dt_name:8s} no-stash bits "
          f"equal {same_bits}, repeat bits equal {repeat_bits}; fwd "
          f"max|d|={err_fwd:.3e}; stash: {st_frac:.2e} of entries differ, "
          f"max {st_max:.3e} of the largest; grads max rel {max(rel):.3e} "
          f"(tol {fr.GRAD_TOL[dt]}), chain alone {err_chain:.3e}, wgrad "
          f"alone {err_wgrad:.3e}; ms kernel/plain/bound: forward no stash "
          f"{t_nostash:.3f}, {each}; the backward as a whole "
          f"{ms['chain'] + ms['wgrad']:.3f} ms against a bound of "
          f"{bounds['bwd_whole'][0]:.3f} ms ({bounds['bwd_whole'][1]}, no dz "
          f"buffer) {'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, ok=passed, err_fwd=err_fwd,
                err_grad=max(rel), abs_chain=abs_chain, abs_wgrad=abs_wgrad,
                ms=ms, plain_ms=plain, bound=bounds)


def phase_train_kernels(device, seed: int):
    """K1-stash and K2 against their plain versions: 1024 rays at S=64 and
    S=128, bf16 with the recurrence and fp32 with the exact encode, then
    the train step's own launches (16,384 rays, S=64 coarse and S=128
    fine, bf16, recurrence). Returns the per-case records."""
    import torch

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    cases = [(N_RAYS, s, dt, exact) for s in (64, 128)
             for dt, exact in ((torch.bfloat16, False),
                               (torch.float32, True))]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False)
              for s in (64, 128)]
    records = [train_kernels_case(device, params, gen, *case)
               for case in cases]
    if not all(r["ok"] for r in records):
        raise PhaseError("a training kernel disagrees with its plain "
                         "version")
    return records


# The recompute backward against the stash backward on the same inputs, per
# gradient tensor over its largest value: the dz rows are the same bits, the
# fp32 sums over the points are grouped by slab.
RECOMPUTE_VS_STASH = {"float32": 1e-5, "bfloat16": 5e-4}
# The recompute backward against its plain version from the same INPUTS,
# same measure. Each side recomputes its own forward, and the backward is
# not continuous in it: a ReLU whose input lies within the two forwards'
# difference of zero (fp32: order of sums, sinf against torch.sin; bf16: an
# fp32 sum on the other side of a rounding boundary, 0.16% of the stash) is
# open on one side and shut on the other, and each such point moves a
# gradient by one point's whole term, ~1/sqrt(points) of the tensor's
# largest value. Measured on an H100 at 1024 rays x 64: 2.5e-3 (fp32),
# 1.9e-2 (bf16); at 16,384 x 128 bf16: 7.1e-3. bf16: the bound the CPU
# tests give two bf16 implementations of this backward. On ONE stash, the
# kernel's own, the two agree to GRAD_TOL like the stash backward.
RECOMPUTE_VS_PLAIN = {"float32": 1e-2, "bfloat16": 3e-2}


def recompute_bound(params, n: int, s: int, bf16: bool, xyz_in: bool):
    """Bound of the recompute backward as a function: the forward's inputs
    and the cotangents in, the gradients out; the forward again, the chain
    and the weight gradient in operations."""
    f_fwd, f_chain, f_wgrad = mlp_work(params)
    n_params = sum(t.numel() for t in (*params.trunk_w, *params.trunk_b,
                                       *params[2:]))
    per_ray = (3 * s if xyz_in else 8) + 2 * s + 27 + 128 + s
    return bound(n * s * (f_fwd + f_chain + f_wgrad),
                 (n * per_ray + n_params) * 4, bf16)


def recompute_case(device, params, gen, n: int, s: int, dt, exact: bool,
                   xyz_in: bool):
    """The recompute backward on n rays x s samples, rays-in or xyz-in
    (jittered points), at its own slab size, against its plain version on
    the same inputs and cotangents (1024-ray slices, gradients summed in
    fp64), against the plain backward on the stash the forward kernel
    writes for these inputs (the rows the slabs recompute), run twice, and
    against the stash backward. -> record."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    c = 64
    dt_name = str(dt)[6:]
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    lay = fr.grad_layout(kw.dims)
    slices = ray_slices(n)
    o, d, z, noise = ray_inputs(n, s, gen, device)
    xyz = jittered_points(o, d, z, gen) if xyz_in else None
    g_ray = torch.zeros(n, fr._round_up(c + 1, fr.LANE), device=device)
    g_ray[:, :c + 1] = torch.randn(n, c + 1, generator=gen,
                                   device=device) * 0.1
    g_w = torch.randn(n, s, generator=gen, device=device) * 0.1
    origins = None if xyz_in else o

    def kernel(slab_rays=None):
        return fr.bwd_recompute(kw, origins, d, z, noise, g_ray, g_w, exact,
                                xyz, slab_rays)

    def plain():
        gw = torch.zeros(lay.wt, dtype=torch.float64, device=device)
        gb = torch.zeros(lay.bt, dtype=torch.float64, device=device)
        for sl in slices:
            gw_s, gb_s, _ = fr.bwd_recompute_plain(
                kw, None if xyz_in else o[sl], d[sl], z[sl], noise[sl],
                g_ray[sl], g_w[sl], exact,
                None if xyz is None else xyz[sl], slab_rays=N_RAYS)
            gw += gw_s
            gb += gb_s
        return gw, gb

    def plain_on(st):       # the plain backward on a given stash
        dir_blk = fr.dir_block(kw, d, exact)
        gw = torch.zeros(lay.wt, dtype=torch.float64, device=device)
        gb = torch.zeros(lay.bt, dtype=torch.float64, device=device)
        for sl in slices:
            pts = slice(sl.start * s, sl.stop * s)
            dz_p, gb_s = fr.bwd_chain_plain(kw, z[sl], noise[sl],
                                            dir_blk[sl], st[pts], g_ray[sl],
                                            g_w[sl])
            gw += fr.bwd_wgrad_plain(kw, st[pts], dz_p)
            gb += gb_s
        return gw, gb

    key = ("fused_render_bwd_recompute_xyz" if xyz_in
           else "fused_render_bwd_recompute")
    before = dict(fr.LAUNCH_COUNTS)
    slab = fr.slab_rays_for(kw, n, s, device)
    with full_fp32():
        gw_k, gb_k, scratch = kernel()
        gw_2, gb_2, _ = kernel()
        repeat_bits = torch.equal(gw_k, gw_2) and torch.equal(gb_k, gb_2)
        del gw_2, gb_2
        # the stash route on the same inputs
        _, _, st = fr.render_fwd(kw, origins, d, z, noise, exact, stash=True,
                                 xyz=xyz)
        dz_s, gb_s = fr.bwd_chain(kw, z, noise, fr.dir_block(kw, d, exact),
                                  st, g_ray, g_w)
        gw_s = fr.bwd_wgrad(kw, st, dz_s)
        # with every ray in one slab the scratch is the stash route's
        rows_equal = None
        if slab >= n:
            rows_equal = (torch.equal(scratch[0], st)
                          and torch.equal(scratch[1], dz_s))
        del scratch, dz_s
        gw_o, gb_o = plain_on(st)
        del st
        gw_p, gb_p = plain()
        torch.cuda.synchronize()
    counted = (fr.LAUNCH_COUNTS[key] == before[key] + 2)
    got = fr.flatten_params(fr.unpack_grads(kw, gw_k, gb_k))
    want = fr.flatten_params(fr.unpack_grads(kw, gw_p, gb_p))
    k2 = fr.flatten_params(fr.unpack_grads(kw, gw_s, gb_s))
    on_stash = fr.flatten_params(fr.unpack_grads(kw, gw_o, gb_o))
    scale = [a.abs().max().clamp_min(1e-30) for a in want]

    def worst(other):
        return max(((a - b).abs().max() / m).item()
                   for a, b, m in zip(other, got, scale))

    rel, vs_k2, rel_stash = worst(want), worst(k2), worst(on_stash)
    abs_err = max((gw_k - gw_p).abs().max().item(),
                  (gb_k - gb_p).abs().max().item())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    passed = (repeat_bits and finite and counted and rows_equal is not False
              and rel <= RECOMPUTE_VS_PLAIN[dt_name]
              and rel_stash <= fr.GRAD_TOL[dt]
              and vs_k2 <= RECOMPUTE_VS_STASH[dt_name])
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=3 if n == N_RAYS else 1)
    b_ms, b_by = recompute_bound(params, n, s, dt == torch.bfloat16, xyz_in)
    work = n * s * sum(mlp_work(params))
    print(f"[recompute] {'xyz-in ' if xyz_in else 'rays-in'} {n} rays x "
          f"S={s} {dt_name:8s} slabs of {slab} rays: grads max rel "
          f"{rel:.3e} against the plain version from the inputs (tol "
          f"{RECOMPUTE_VS_PLAIN[dt_name]}), {rel_stash:.3e} against the "
          f"plain backward on the forward kernel's stash (tol "
          f"{fr.GRAD_TOL[dt]}), against the stash backward "
          f"{vs_k2:.3e} (bound {RECOMPUTE_VS_STASH[dt_name]}), repeat bits "
          f"equal {repeat_bits}, scratch rows equal the stash route's "
          f"{rows_equal}; kernel {ms:.3f} ms ({work / ms / 1e9:.0f} "
          f"TFLOP/s) plain {plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
          f"{'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, xyz_in=xyz_in, ok=passed,
                err_grad=rel, err_on_stash=rel_stash, vs_stash=vs_k2,
                abs_err=abs_err, ms=ms,
                plain_ms=plain_ms, bound=(b_ms, b_by), slab=slab)


def recompute_scratch_check(device, params, gen):
    """The recompute backward's device memory above its inputs at two
    batch sizes (8192 and 16,384 rays x 128, bf16): the same slab, so the
    same peak up to the per-ray rows it stages (a few MB)."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    s, peaks = 128, {}
    for n in (8192, 16384):
        o, d, z, noise = ray_inputs(n, s, gen, device)
        g_ray = torch.randn(n, 128, generator=gen, device=device) * 0.1
        g_w = torch.randn(n, s, generator=gen, device=device) * 0.1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gw, gb, scratch = fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w,
                                           False)
        torch.cuda.synchronize()
        peaks[n] = (torch.cuda.max_memory_allocated() - base,
                    fr.slab_rays_for(kw, n, s, device))
        del gw, gb, scratch
    (p8, r8), (p16, r16) = peaks[8192], peaks[16384]
    mib = 2 ** 20
    print(f"[recompute] scratch above the inputs: {p8 / mib:.1f} MiB at "
          f"8192 rays, {p16 / mib:.1f} MiB at 16,384 rays (slabs of {r8} and "
          f"{r16} rays, budget {fr.RECOMPUTE_SCRATCH_BYTES / mib:.0f} MiB "
          f"for the slab's stash and dz)")
    if r8 != r16 or abs(p16 - p8) > 16 * mib or p16 > (
            fr.RECOMPUTE_SCRATCH_BYTES + 256 * mib):
        raise PhaseError("the recompute backward's scratch grows with N")


def phase_recompute(device, seed: int):
    """The recompute backward against its plain version, both input forms:
    1024 rays at S=64 and S=128, bf16 with the recurrence and fp32 with the
    exact encode, then the no-stash steps' own launches (16,384 rays, S=64
    and S=128, bf16, recurrence). Returns the per-case records."""
    import torch

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    cases = [(N_RAYS, s, dt, exact, xyz_in) for xyz_in in (False, True)
             for s in (64, 128)
             for dt, exact in ((torch.bfloat16, False),
                               (torch.float32, True))]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, xyz_in)
              for xyz_in in (False, True) for s in (64, 128)]
    records = [recompute_case(device, params, gen, *case) for case in cases]
    if not all(r["ok"] for r in records):
        raise PhaseError("the recompute backward disagrees with its plain "
                         "version or with the stash backward")
    recompute_scratch_check(device, params, gen)
    return records


# ---------------------------------------------------- the per-point MLP pair
def mlp_inputs(n: int, s: int, dir_rep: int, gen, device):
    """Seeded sample points (n*s, 3) along n rays and the directions: one
    per ray (``dir_rep`` = s) or one per point (1)."""
    o, d, z, _ = ray_inputs(n, s, gen, device)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    if dir_rep == 1:
        d = d.repeat_interleave(s, 0)
    return xyz.contiguous(), d.contiguous()


def point_slices(m: int, dir_rep: int):
    """Slices of at most N_RAYS * 128 points that end on a direction's
    boundary -> (points, directions) slice pairs."""
    per = max(1, N_RAYS * 128 // dir_rep) * dir_rep
    return [(slice(i, min(i + per, m)),
             slice(i // dir_rep, -(-min(i + per, m) // dir_rep)))
            for i in range(0, m, per)]


def mlp_fwd_bound(params, m: int, n_dirs: int, c: int, bf16: bool):
    """The forward as a function: a coordinate per point and the
    directions in, features and sigma per point out, all f32."""
    return bound(m * mlp_work(params)[0],
                 (3 * m + 3 * n_dirs + m * (c + 1)) * 4, bf16)


def mlp_forward_case(device, params, gen, n: int, s: int, dt, exact: bool,
                     dir_rep: int):
    """The fused-MLP forward kernel on n*s points against mlp_fwd_plain on
    the same inputs (slice by slice) -> record."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm

    c = 64
    xyz, d = mlp_inputs(n, s, dir_rep, gen, device)
    m = xyz.shape[0]
    mkw = fm.prepare_mlp_weights(params, 15, 4, dt)
    slices = point_slices(m, dir_rep)

    def plain():
        for pts, dirs in slices:
            yield pts, fm.mlp_fwd_plain(mkw, xyz[pts], d[dirs], exact,
                                        dir_rep)

    def kernel():
        return fm.fused_mlp_apply(mkw, xyz, d, exact, dir_rep)

    err_f = err_s = 0.0
    with full_fp32():
        feat, sigma = kernel()
        scale = max(1.0, sigma.max().item())
        for pts, (f_p, s_p) in plain():
            err_f = max(err_f, (feat[pts] - f_p).abs().max().item())
            err_s = max(err_s, (sigma[pts] - s_p).abs().max().item() / scale)
    tol = fm.KERNEL_TOL[dt]
    passed = (bool(torch.isfinite(feat).all() and torch.isfinite(sigma).all())
              and bool((sigma >= 0).all()) and err_f <= tol[0]
              and err_s <= tol[1])
    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: drain(plain()), reps=3 if n == N_RAYS else 1)
    b_ms, b_by = mlp_fwd_bound(params, m, d.shape[0], c,
                               dt == torch.bfloat16)
    dt_name = str(dt)[6:]
    print(f"[mlp-kernel] forward {n} x {s} = {m} points, dir_rep {dir_rep} "
          f"{dt_name:8s} exact={exact!s:5s} max|dfeat|={err_f:.3e} "
          f"max|dsigma|={err_s:.3e} (of max(1, {scale:.2f})) tol={tol} "
          f"kernel {ms:.3f} ms ({m * mlp_work(params)[0] / ms / 1e9:.0f} "
          f"TFLOP/s, {m * (c + 1) * 4 / ms / 1e6:.1f} GB/s of stores) plain "
          f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
          f"{'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, dir_rep=dir_rep,
                err=max(err_f, err_s * scale), ms=ms, plain_ms=plain_ms,
                bound=(b_ms, b_by), ok=passed)


def mlp_composite_check(device, params, gen):
    """The fused MLP's features and sigma through composite against the
    fused render's xyz-in ray block on the same points, z and noise, at
    fp32, where the two kernels' sigma policies coincide."""
    import torch

    from crnerf_tpu_torch.core.compositing import composite
    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr

    n, s, dt = N_RAYS, 128, torch.float32
    o, d, z, noise = ray_inputs(n, s, gen, device)
    xyz = jittered_points(o, d, z, gen)
    mkw = fm.prepare_mlp_weights(params, 15, 4, dt)
    with full_fp32():
        feat, sigma = fm.fused_mlp_apply(mkw, xyz.reshape(-1, 3), d, True, s)
        w4, f4, d4 = composite(feat.reshape(n, s, -1), sigma.reshape(n, s), z,
                               noise)
        blk, w1 = fr.fused_render_apply(mkw.kw, None, d, z, noise, True,
                                        xyz=xyz)
    err = ((w4 - w1).abs().max().item(),
           (f4 - blk[:, :64]).abs().max().item(),
           (d4 - blk[:, 64]).abs().max().item())
    tol = fr.KERNEL_TOL[dt]
    ok = all(e <= t for e, t in zip(err, tol))
    print(f"[mlp-kernel] fused MLP + composite against the fused render's "
          f"xyz-in ray block ({n} x {s}, float32): max|dw|={err[0]:.3e} "
          f"max|dfmap|={err[1]:.3e} max|ddepth|={err[2]:.3e} tol={tol} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseError("the fused MLP + composite disagrees with the "
                         "fused render kernel")


# The backward at its own slab size against the same kernel with every
# point in one slab, per gradient tensor over its largest value: the dz rows
# are the same bits, the fp32 sums over the points are grouped by slab.
MLP_SLABS_VS_ONE = {"float32": 1e-5, "bfloat16": 5e-4}


def mlp_backward_case(device, params, gen, n: int, s: int, dt, exact: bool):
    """The fused-MLP backward kernel on n rays x s samples (one direction
    per ray) and random non-zero per-point cotangents: against the plain
    chain and weight gradient on its own recomputed stash (one shared
    forward: GRAD_TOL), against the plain backward from the inputs
    (GRAD_TOL_FROM_INPUTS; the plain versions run over slices, gradients
    summed in fp64), twice for the same bits, and at its own slab size
    against one slab. -> record."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr

    c = 64
    dt_name = str(dt)[6:]
    mkw = fm.prepare_mlp_weights(params, 15, 4, dt)
    lay = fm.mlp_grad_layout(mkw.kw.dims)
    xyz, d = mlp_inputs(n, s, s, gen, device)
    m = xyz.shape[0]
    g_feat = torch.randn(m, c, generator=gen, device=device) * 0.1
    g_sig = torch.randn(m, generator=gen, device=device) * 0.1
    slices = point_slices(m, s)

    def kernel(slab_points=None):
        return fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact, s, slab_points)

    def zeros():
        return (torch.zeros(lay.wt, dtype=torch.float64, device=device),
                torch.zeros(lay.bt, dtype=torch.float64, device=device))

    def plain():
        gw, gb = zeros()
        for pts, dirs in slices:
            gw_s, gb_s, _ = fm.mlp_bwd_slabs_plain(
                mkw, xyz[pts], d[dirs], g_feat[pts], g_sig[pts], exact, s,
                slab_points=pts.stop - pts.start)
            gw += gw_s
            gb += gb_s
        return gw, gb

    def plain_on(st):       # the plain backward on a given stash
        gw, gb = zeros()
        for pts, _ in slices:
            dz_p, gb_s = fm.mlp_chain_plain(mkw, st[pts], g_feat[pts],
                                            g_sig[pts])
            gw += fr.bwd_wgrad_plain(mkw.kw, st[pts], dz_p, lay)
            gb += gb_s
        return gw, gb

    before = fm.LAUNCH_COUNTS["fused_mlp_bwd"]
    slab = fm.slab_points_for(mkw, m, device)
    with full_fp32():
        gw_k, gb_k, _ = kernel()
        gw_2, gb_2, _ = kernel()
        repeat_bits = torch.equal(gw_k, gw_2) and torch.equal(gb_k, gb_2)
        del gw_2, gb_2
        gw_1, gb_1, (st, _) = kernel(slab_points=m)   # every point's stash
        gw_o, gb_o = plain_on(st)
        del st
        gw_p, gb_p = plain()
        torch.cuda.synchronize()
    counted = fm.LAUNCH_COUNTS["fused_mlp_bwd"] == before + 3

    def grads(gw, gb):
        return fr.flatten_params(fm.unpack_mlp_grads(mkw, gw, gb))

    got, one, want, on_stash = (grads(gw_k, gb_k), grads(gw_1, gb_1),
                                grads(gw_p, gb_p), grads(gw_o, gb_o))
    scale = [a.abs().max().clamp_min(1e-30) for a in want]

    def worst(a_list, b_list):
        return max(((a - b).abs().max() / sc).item()
                   for a, b, sc in zip(a_list, b_list, scale))

    rel, rel_stash, vs_one = (worst(want, got), worst(on_stash, one),
                              worst(one, got))
    abs_err = max((gw_k - gw_p).abs().max().item(),
                  (gb_k - gb_p).abs().max().item())
    largest = max(gw_p.abs().max().item(), gb_p.abs().max().item())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    passed = (repeat_bits and finite and counted
              and rel <= fm.GRAD_TOL_FROM_INPUTS[dt]
              and rel_stash <= fm.GRAD_TOL[dt]
              and vs_one <= MLP_SLABS_VS_ONE[dt_name])
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=3 if n == N_RAYS else 1)
    n_params = sum(t.numel() for t in fr.flatten_params(params))
    work = m * sum(mlp_work(params))
    # the points, the directions and the per-point cotangents in, the
    # gradients out; the forward again, the chain and the weight gradient
    b_ms, b_by = bound(work, (3 * m + 3 * n + m * (c + 1) + n_params) * 4,
                       dt == torch.bfloat16)
    print(f"[mlp-kernel] backward {n} x {s} = {m} points {dt_name:8s} slabs "
          f"of {slab} points: grads max rel {rel_stash:.3e} against the "
          f"plain backward on the kernel's own stash (tol "
          f"{fm.GRAD_TOL[dt]}), {rel:.3e} against the plain version from "
          f"the inputs (tol {fm.GRAD_TOL_FROM_INPUTS[dt]}; max abs "
          f"{abs_err:.3e}, the largest gradient {largest:.3e}), {vs_one:.3e} "
          f"against one slab (bound {MLP_SLABS_VS_ONE[dt_name]}), repeat "
          f"bits equal {repeat_bits}; kernel {ms:.3f} ms "
          f"({work / ms / 1e9:.0f} TFLOP/s) plain {plain_ms:.3f} ms bound "
          f"{b_ms:.3f} ms ({b_by}) {'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, ok=passed, err_grad=rel,
                err_on_stash=rel_stash, vs_one=vs_one, err=abs_err, ms=ms,
                plain_ms=plain_ms, bound=(b_ms, b_by), slab=slab)


def mlp_scratch_check(device, params, gen):
    """The backward's device memory above its inputs at two batch sizes
    (8192 and 16,384 rays x 128, bf16): the same slab, so the same peak."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm

    mkw = fm.prepare_mlp_weights(params, 15, 4, torch.bfloat16)
    s, peaks = 128, {}
    for n in (8192, 16384):
        xyz, d = mlp_inputs(n, s, s, gen, device)
        g_feat = torch.randn(n * s, 64, generator=gen, device=device) * 0.1
        g_sig = torch.randn(n * s, generator=gen, device=device) * 0.1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, False, s)
        torch.cuda.synchronize()
        peaks[n] = (torch.cuda.max_memory_allocated() - base,
                    fm.slab_points_for(mkw, n * s, device))
        del out
    (p8, r8), (p16, r16) = peaks[8192], peaks[16384]
    mib = 2 ** 20
    print(f"[mlp-kernel] backward scratch above the inputs: {p8 / mib:.1f} "
          f"MiB at 8192 rays, {p16 / mib:.1f} MiB at 16,384 rays (slabs of "
          f"{r8} and {r16} points, budget {fm.BWD_SCRATCH_BYTES / mib:.0f} "
          f"MiB for the slab's stash and dz)")
    if r8 != r16 or abs(p16 - p8) > 16 * mib or p16 > (
            fm.BWD_SCRATCH_BYTES + 256 * mib):
        raise PhaseError("the fused MLP backward's scratch grows with N")


def phase_mlp_kernels(device, seed: int):
    """The fused-MLP pair against its plain versions. Returns (forward
    records, backward records)."""
    import torch

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    both = ((torch.bfloat16, False), (torch.float32, True))
    fwd_cases = [(N_RAYS, 128, dt, exact, rep)
                 for dt, exact in both for rep in (128, 1)]
    fwd_cases += [(999, 77, torch.bfloat16, False, 77)]      # ragged
    fwd_cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, s)
                  for s in (64, 128)]
    fwd_cases += [(SERVE_TILE, s, torch.bfloat16, False, s)
                  for s in (256, 512)]
    fwd = [mlp_forward_case(device, params, gen, *case)
           for case in fwd_cases]
    if not all(r["ok"] for r in fwd):
        raise PhaseError("the fused MLP forward disagrees with its plain "
                         "version")
    mlp_composite_check(device, params, gen)
    bwd_cases = [(N_RAYS, s, dt, exact) for s in (64, 128)
                 for dt, exact in both]
    bwd_cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False)
                  for s in (64, 128)]
    bwd = [mlp_backward_case(device, params, gen, *case)
           for case in bwd_cases]
    if not all(r["ok"] for r in bwd):
        raise PhaseError("the fused MLP backward disagrees with its plain "
                         "version")
    mlp_scratch_check(device, params, gen)
    return fwd, bwd


def module_route_reading(device, seed: int):
    """One timed reading of the module route (pallas_train=False: the
    NerfMLP module under autograd with remat) at the flagship step: no
    kernel of the port launches. -> (median ms, peak GiB)."""
    import statistics

    import torch

    cfg = train_config(pallas_train=False)
    state, step, staged = make_trainer(cfg, device, seed, (112, 84),
                                       cfg.resolved_chunks())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    _, warm, _ = timed_steps(state, step, staged, 1)
    times, losses, _ = timed_steps(state, step, staged, 2, first=1)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches.values()):
        raise PhaseError(f"pallas_train=False launched kernels: {launches}")
    if not all(x == x and abs(x) != float("inf") for x in warm + losses):
        raise PhaseError(f"pallas_train=False: non-finite loss "
                         f"{warm + losses}")
    return statistics.median(times), peak_gb


COMPOSITE_SHAPES = ((8192, 512, 64), (1000, 200, 48))


def composite_f64(feats, sigmas, z):
    """The compositing of core.compositing.composite evaluated at
    float64."""
    import torch

    from crnerf_tpu_torch.core.compositing import (
        compute_alphas,
        weights_from_alphas,
    )

    z = z.double()
    w = weights_from_alphas(compute_alphas(sigmas.double(), z))
    return (w, torch.einsum("ns,nsc->nc", w, feats.double()),
            torch.sum(w * z, -1))


def phase_composite(device, seed: int):
    """The compositing kernel against its plain version at the serve
    tile's fine pass (8192 x 512 x 64) and a ragged shape; on the fused
    forward's own features and sigma (from the plain forward, no noise)
    against the fused forward kernel's weights, feature map and depth; then
    once as its users call it, counters zeroed before and read after.
    Returns (records, launches of that call)."""
    import torch

    from crnerf_tpu_torch.core.compositing import composite
    from crnerf_tpu_torch.ops import composite as comp
    from crnerf_tpu_torch.ops import fused_render as fr

    gen = torch.Generator(device=device).manual_seed(seed + 5)
    records = []
    for n, s, c in COMPOSITE_SHAPES:
        feats = torch.rand(n, s, c, generator=gen, device=device)
        sigmas = torch.rand(n, s, generator=gen, device=device) * 3.75 - 0.75
        z = torch.sort(torch.rand(n, s, generator=gen, device=device) * 5
                       + 0.5, -1).values
        got = comp.composite_apply(feats, sigmas, z)
        want = composite(feats, sigmas, z)
        want64 = composite_f64(feats, sigmas, z)
        err = [(a - b).abs().max().item() for a, b in zip(got, want)]
        err64 = [(a - b).abs().max().item() for a, b in zip(got, want64)]
        plain64 = [(a - b).abs().max().item() for a, b in zip(want, want64)]
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        passed = (finite
                  and all(e <= t for e, t in zip(err, comp.KERNEL_TOL))
                  and all(e <= t for e, t in zip(err64,
                                                 comp.KERNEL_TOL_F64)))
        del got, want, want64
        ms = time_ms(lambda: comp.composite_apply(feats, sigmas, z), reps=5)
        plain_ms = time_ms(lambda: composite(feats, sigmas, z), reps=5)
        # one multiply-add per feature value; features, sigma and z read
        # once, weights, feature map and depth written once
        b_ms, b_by = bound(2.0 * n * s * c,
                           (n * s * c + 3 * n * s + n * c + n) * 4,
                           bf16=False)
        print(f"[composite] {n} x {s} x {c}: max|dw|={err[0]:.3e} "
              f"max|dfmap|={err[1]:.3e} max|ddepth|={err[2]:.3e} "
              f"tol={comp.KERNEL_TOL}; against float64 "
              f"{' '.join(f'{e:.3e}' for e in err64)} "
              f"tol={comp.KERNEL_TOL_F64} (the plain version: "
              f"{' '.join(f'{e:.3e}' for e in plain64)}); kernel {ms:.3f} ms "
              f"({n * s * c * 4 / ms / 1e9:.2f} TB/s of features) plain "
              f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
              f"{'ok' if passed else 'FAIL'}")
        records.append(dict(N=n, S=s, C=c, err=max(err), ms=ms,
                            plain_ms=plain_ms, bound=(b_ms, b_by),
                            ok=passed))
    if not all(r["ok"] for r in records):
        raise PhaseError("the compositing kernel disagrees with its plain "
                         "version")

    # the fused forward's own compositing block, as a unit test: the kernel
    # on the plain forward's features and sigma against the fused forward
    params = full_width_params(seed, device)
    n, s = N_RAYS, 256
    o, d, z, _ = ray_inputs(n, s, gen, device)
    noise = torch.zeros(n, s, device=device)
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    for dt in (torch.float32, torch.bfloat16):
        kw = fr.prepare_kernel_weights(params, 15, 4, dt)
        with full_fp32():
            feat, sigma, _ = fr.render_points_plain(params, xyz, d, 15, 4, dt,
                                                    True)
            w5, f5, d5 = comp.composite_apply(feat.contiguous(),
                                              sigma.contiguous(), z)
            blk, w1 = fr.fused_render_apply(kw, o, d, z, noise, True)
        err = ((w5 - w1).abs().max().item(),
               (f5 - blk[:, :64]).abs().max().item(),
               (d5 - blk[:, 64]).abs().max().item())
        tol = fr.KERNEL_TOL[dt]
        ok = all(e <= t for e, t in zip(err, tol))
        print(f"[composite] on the fused forward's features and sigma "
              f"({n} x {s}, {str(dt)[6:]}) against the fused forward: "
              f"max|dw|={err[0]:.3e} max|dfmap|={err[1]:.3e} "
              f"max|ddepth|={err[2]:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseError("the compositing kernel disagrees with the "
                             "fused forward's compositing")

    # the exported op as its users call it, at the serve tile's size
    n, s, c = COMPOSITE_SHAPES[0]
    feats = torch.rand(n, s, c, generator=gen, device=device)
    sigmas = torch.rand(n, s, generator=gen, device=device) * 3
    z = torch.sort(torch.rand(n, s, generator=gen, device=device) * 5 + 0.5,
                   -1).values
    for k in comp.LAUNCH_COUNTS:
        comp.LAUNCH_COUNTS[k] = 0
    from crnerf_tpu_torch.ops import composite_apply
    w, fmap, depth = composite_apply(feats, sigmas, z)
    torch.cuda.synchronize()
    launches = dict(comp.LAUNCH_COUNTS)
    total = w.sum(-1)
    if not (launches["composite"] == 1 and w.shape == (n, s)
            and fmap.shape == (n, c) and depth.shape == (n,)
            and bool(torch.isfinite(fmap).all())
            and bool((total <= 1 + 1e-5).all()) and bool((w >= 0).all())
            and bool((fmap >= 0).all()) and bool((fmap <= 1 + 1e-5).all())):
        raise PhaseError(f"composite_apply: launches {launches}, or outputs "
                         "out of range")
    print(f"[composite] composite_apply at {n} x {s} x {c}: launches "
          f"{launches}, weights sum to [{total.min():.4f}, "
          f"{total.max():.4f}], depth [{depth.min():.3f}, "
          f"{depth.max():.3f}]")
    return records, launches["composite"]


# ------------------------------------------- the conv and sincos spikes
# (N, H, W, C, Co) of the 3x3 conv: the spike's shape, enc_a's conv3 in the
# train step (forward_train encodes the 16 grids' 224x160 appearance
# images), and two ragged shapes (the second takes the element-by-element
# copies: C and Co not multiples of 8)
CONV3_SHAPES = ((8, 160, 224, 64, 64), (TRAIN_GRIDS, 160, 224, 64, 64),
                (3, 37, 53, 40, 72), (2, 19, 23, 13, 21))
# (B, H, W, C) of the original and F of the packed conv: the encoder's two
# levels (scripts/spike_packed_conv.py), then two ragged ones (I = 19 and
# 11 output rows; 4C = 40 and 12)
PACKED_SHAPES = (((8, 160, 224, 64), 64), ((8, 80, 112, 128), 128),
                 ((2, 38, 54, 10), 6), ((2, 22, 30, 3), 5))


def _errs(got, want):
    """(max abs error, max abs error over max |want|), float32."""
    got, want = got.float(), want.float()
    e = (got - want).abs().max().item()
    return e, e / (want.abs().max().item() + 1e-30)


def conv3_case(device, gen, n, h, w, c, co):
    """The 3x3 forward and weight-gradient kernels at one shape against
    their plain versions, the gradient twice; -> (fwd record, dw record)."""
    import torch

    from crnerf_tpu_torch.ops import conv as cv
    from crnerf_tpu_torch.tools.spike_conv3x3 import library_dw, library_fwd

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()

    xpad, kernel, dy = normal(n, h + 2, w + 2, c), normal(3, 3, c, co), \
        normal(n, h, w, co)
    m, tag = n * h * w, f"{n} x {h} x {w}, {c} -> {co}"
    flops = 2.0 * 9 * m * c * co
    in_bytes = 2 * xpad.numel()
    cases = {  # kernel, plain version, cuDNN, bytes moved at the least
        # input and kernel read once, the f32 output written once
        "fwd": (lambda: cv.conv3x3_valid_fwd(xpad, kernel),
                lambda: cv.conv_valid_plain(xpad, kernel),
                library_fwd(xpad, kernel),
                in_bytes + 2 * kernel.numel() + 4 * m * co),
        # input and cotangent read once, the f32 gradient written once
        "dw": (lambda: cv.conv3x3_dw(xpad, dy),
               lambda: cv.conv3x3_dw_plain(xpad, dy),
               library_dw(xpad, dy, kernel.shape),
               in_bytes + 2 * dy.numel() + 4 * 9 * c * co),
    }
    recs = []
    for kind, (kern, plain, lib, nbytes) in cases.items():
        got = kern()
        with full_fp32():
            want = plain()
        abs_err, rel = _errs(got, want)
        same_bits = torch.equal(got, kern()) if kind == "dw" else True
        ok = (rel <= cv.KERNEL_TOL_F32 and same_bits
              and bool(torch.isfinite(got).all()))
        del got, want
        # 20 calls a reading: cuDNN's ~0.1 ms calls are near the host's
        # launch rate, and fewer calls measure the host
        ms = time_ms(kern, reps=20)
        with full_fp32():
            plain_ms = time_ms(plain, reps=3)
            library_ms = time_ms(lib, reps=20)
        b_ms, b_by = bound(flops, nbytes)
        bits = ("" if kind == "fwd" else ", twice: the same bits"
                if same_bits else ", twice: OTHER BITS")
        print(f"[conv] 3x3 {kind} {tag}: max|err| {abs_err:.3e} = {rel:.3e} "
              f"of the largest (bound {cv.KERNEL_TOL_F32:.0e}){bits}; kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, cuDNN {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) {'ok' if ok else 'FAIL'}")
        recs.append(dict(kind=kind, shape=(n, h, w, c, co), err=abs_err,
                         rel=rel,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound=(b_ms, b_by), ok=ok))
    return recs


def packed_case(device, shape, f):
    """The packed conv at one level against its plain version and, after
    _d2s, against the 3x3 kernel on the reflect-padded original."""
    import torch

    from crnerf_tpu_torch.ops import conv as cv
    from crnerf_tpu_torch.tools.spike_conv3x3 import library_fwd
    from crnerf_tpu_torch.tools.spike_packed_conv import (
        level_inputs,
        packed_operands,
    )

    b, h, w, c = shape
    x, k3 = level_inputs(shape, f, device)
    xp_pad, k2 = packed_operands(x, k3)
    got = cv.packed_conv(xp_pad, k2)
    with full_fp32():
        want = cv.conv_valid_plain(xp_pad, k2, torch.bfloat16)
    abs_err, rel = _errs(got, want)
    # the tie to S1: the packed output is the 3x3 sums rounded to bf16
    tie = _errs(cv._d2s(got), cv.conv3x3_valid_fwd(
        cv.reflect_pad(x, 1).contiguous(), k3))[1]
    tie_tol = 2.0 ** -8 + cv.KERNEL_TOL_F32
    ok = (rel <= cv.KERNEL_TOL_BF16 and tie <= tie_tol
          and bool(torch.isfinite(got.float()).all()))
    del got, want
    ms = time_ms(lambda: cv.packed_conv(xp_pad, k2), reps=20)
    with full_fp32():
        plain_ms = time_ms(
            lambda: cv.conv_valid_plain(xp_pad, k2, torch.bfloat16), reps=3)
        library_ms = time_ms(library_fwd(xp_pad, k2), reps=20)
    i, j = h // 2, w // 2
    flops = 2.0 * 4 * b * i * j * (4 * c) * (4 * f)
    nbytes = 2 * (xp_pad.numel() + k2.numel() + b * i * j * 4 * f)
    b_ms, b_by = bound(flops, nbytes)
    print(f"[conv] packed {b} x {h} x {w}, {c} -> {f} (4C = {4 * c}): "
          f"max|err| {abs_err:.3e} = {rel:.3e} of the largest (bound "
          f"{cv.KERNEL_TOL_BF16:.2e}); _d2s of it against the 3x3 kernel "
          f"{tie:.3e} (bound {tie_tol:.2e}); kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"cuDNN {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"{'ok' if ok else 'FAIL'}")
    return dict(shape=(b, h, w, c, f), err=abs_err, rel=rel, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound=(b_ms, b_by), ok=ok)


def sincos_cases(device):
    """The accurate variant against float64 at the spike's five scales,
    the fast one's error printed; -> records."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.ops import sincos as sc
    from crnerf_tpu_torch.tools.spike_kernel_sincos import (
        f64_err,
        unit_inputs,
    )

    x01 = unit_inputs(device)
    recs = []
    for scale in sc.SCALES:
        x = (x01 * scale).contiguous()
        s, c = sc.sincos(x)
        e64 = max(f64_err(s, x, np.sin), f64_err(c, x, np.cos))
        sf, cf = sc.sincos(x, fast=True)
        fast64 = max(f64_err(sf, x, np.sin), f64_err(cf, x, np.cos))
        ps, pc = sc.sincos_plain(x)
        err = max((s - ps).abs().max().item(), (c - pc).abs().max().item())
        ms = time_ms(lambda: sc.sincos(x), reps=20)
        plain_ms = time_ms(lambda: sc.sincos_plain(x), reps=20)
        library_ms = time_ms(lambda: (torch.sin(x), torch.cos(x)), reps=20)
        b_ms, b_by = bound(0.0, 3 * 4 * x.numel())  # x read, s and c written
        ok = e64 <= sc.F64_TOL
        print(f"[sincos] |x| <= {scale:g} rad: against float64 {e64:.3e} "
              f"(bound {sc.F64_TOL:.3e}), the fast intrinsics {fast64:.3e}; "
              f"against torch.sin / cos {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.sin + torch.cos {library_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}) {'ok' if ok else 'FAIL'}")
        recs.append(dict(scale=scale, err=err, e64=e64, fast64=fast64, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound=(b_ms, b_by), ok=ok))
    return recs


# the spike tools as a user runs them: the conv3x3 spike at its own shape
# and at the train step's batch, the packed spike, the sincos spike
SPIKE_RUNS = (("spike_conv3x3", []),
              ("spike_conv3x3", ["--n", str(TRAIN_GRIDS)]),
              ("spike_packed_conv", []), ("spike_kernel_sincos", []))


def phase_conv(device, seed: int):
    """Phase 4e. -> (3x3 records, packed records, sincos records, launches
    of the spike tools' run)."""
    import importlib

    import torch

    gen = torch.Generator(device=device).manual_seed(seed + 7)
    conv3 = [r for shape in CONV3_SHAPES
             for r in conv3_case(device, gen, *shape)]
    packed = [packed_case(device, shape, f) for shape, f in PACKED_SHAPES]
    sincos = sincos_cases(device)
    if not all(r["ok"] for r in conv3 + packed + sincos):
        raise PhaseError("a conv or sincos kernel disagrees with its plain "
                         "version, or the gradient changed its bits")
    torch.cuda.synchronize()
    zero_counts()
    for tool, argv in SPIKE_RUNS:
        mod = importlib.import_module(f"crnerf_tpu_torch.tools.{tool}")
        if mod.main(argv) != 0:
            raise PhaseError(f"{tool} {' '.join(argv)} failed")
    torch.cuda.synchronize()
    launches = read_counts()
    spikes = ("conv3x3_fwd", "conv3x3_dw", "packed_conv", "sincos")
    if not (all(launches[k] > 0 for k in spikes)
            and not any(v for k, v in launches.items() if k not in spikes)):
        raise PhaseError(f"spike tools: launch counters {launches}")
    print(f"[conv] the spike tools' launches: {launches}")
    return conv3, packed, sincos, launches


# S2 against K1: 1024 rays at S=256 and 512 (and against its plain
# version), the spike's 8192 x 128, the serve tile 8192 x 512
PIPE_SHAPES = ((N_RAYS, 256), (N_RAYS, 512), (8192, 128), (SERVE_TILE, 512))
PIPE_ENTRY = (8192, 128)          # the kernels line's shape: the spike's
SUBLANE_TILES = (2048, 37)        # the spike's count, and an odd one
# block rows each S5 mode zeroes (the TPU kernel leaves them unwritten)
SUBLANE_ZERO_ROWS = {"base": range(8, 96), "stores": range(93, 96),
                     "dmatrix": range(0)}
SPIKE_RUNS_4F = (("spike_interleave", []), ("spike_sublane_stores", []))


def pipe_case(device, params, gen, n: int, s: int):
    """S2 at n rays x s samples, bf16, recurrence, every P, against K1 on the same inputs (the same bits; else KERNEL_TOL[bf16])
    and, on N_RAYS rays, against pipe_render_plain -> records."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr
    from crnerf_tpu_torch.ops import pipe_render as pr

    dt = torch.bfloat16
    o, d, z, noise = ray_inputs(n, s, gen, device)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    blk1, w1 = fr.fused_render_apply(kw, o, d, z, noise, exact_encode=False)

    def errs(blk, w, blk_r, w_r):
        return ((w - w_r).abs().max().item(),
                (blk[:, :64] - blk_r[:, :64]).abs().max().item(),
                (blk[:, 64] - blk_r[:, 64]).abs().max().item())

    tol = fr.KERNEL_TOL[dt]
    f_fwd, _, _ = mlp_work(params)
    b_ms, b_by = bound(n * s * f_fwd, n * (8 + 2 * s + 27 + 128 + s) * 4)
    k1_ms = time_ms(lambda: fr.fused_render_apply(kw, o, d, z, noise,
                                                  exact_encode=False))
    plain_ms = None
    if n == N_RAYS or (n, s) == PIPE_ENTRY:
        plain_ms = time_ms(lambda: drain(
            pr.pipe_render_plain(params, o[sl], d[sl], z[sl], noise[sl], 15,
                                 4, dt, False) for sl in ray_slices(n)),
            reps=3 if n == N_RAYS else 1)
    recs = []
    occ = pr.pipe_render_occupancy(kw, device)
    for p in pr.PHASES:
        blk, w = pr.pipe_render_apply(kw, o, d, z, noise, False, p)
        same = torch.equal(blk, blk1) and torch.equal(w, w1)
        err_k1 = errs(blk, w, blk1, w1)
        err_plain = None
        if n == N_RAYS:
            with full_fp32():
                blk_p, w_p = pr.pipe_render_plain(params, o, d, z, noise,
                                                  15, 4, dt, False)
            err_plain = errs(blk, w, blk_p, w_p)
            del blk_p, w_p
        ok = (bool(torch.isfinite(blk).all() and torch.isfinite(w).all())
              and (same or all(e <= t for e, t in zip(err_k1, tol)))
              and (err_plain is None
                   or all(e <= t for e, t in zip(err_plain, tol))))
        del blk, w
        ms = time_ms(lambda: pr.pipe_render_apply(kw, o, d, z, noise,
                                                  False, p))
        vs_plain = ("" if err_plain is None else
                    " vs plain max|dw|={:.3e} max|dfmap|={:.3e} "
                    "max|ddepth|={:.3e} (tol {}),".format(*err_plain, tol))
        print(f"[pipe] S2 P={p} {n} rays x S={s} bf16: vs K1 "
              f"{'the same bits' if same else 'OTHER BITS, max err %s' % (err_k1,)},"
              f"{vs_plain} kernel {ms:.3f} ms "
              f"({n * s * f_fwd / ms / 1e9:.0f} TFLOP/s), K1 {k1_ms:.3f} "
              f"ms, plain "
              f"{'not timed' if plain_ms is None else '%.3f ms' % plain_ms}"
              f", bound {b_ms:.3f} ms ({b_by}), {occ} CTAs an SM "
              f"{'ok' if ok else 'FAIL'}")
        recs.append(dict(N=n, S=s, P=p, same_bits=same,
                         err_k1=max(err_k1),
                         err_plain=None if err_plain is None
                         else max(err_plain),
                         ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
                         bound=(b_ms, b_by), occupancy=occ, ok=ok))
    return recs


def sublane_case(device, mode: str, tiles: int):
    """S5 in one mode on ``tiles`` tiles of real (sin, cos) states against
    its plain version: the outputs within the mode's KERNEL_TOL of the
    largest value, the bf16 blocks themselves (read back through w = [I |
    0]) within its BLOCK_TOL (the same bits in base and stores), and the
    zero rows (a w that is zero outside them must give an exactly zero
    output); at 2048 tiles also the times on the spike's inputs, cuBLAS's
    on the prebuilt block and the bound."""
    import torch

    from crnerf_tpu_torch.ops import sublane_stores as ss
    from crnerf_tpu_torch.tools.spike_sublane_stores import (
        kernel_bound,
        real_states,
        spike_inputs,
    )

    x_spike, w = spike_inputs(tiles, device)
    x = real_states(tiles, device)
    got = ss.sublane_stores(x, w, mode)
    with full_fp32():
        want = ss.sublane_stores_plain(x, w, mode)
    abs_err, rel = _errs(got, want)
    finite = bool(torch.isfinite(got).all())
    del got, want
    blk = ss.kernel_blocks(x, mode)
    with full_fp32():
        blk_want = ss.sublane_blocks_plain(x, mode).to(torch.bfloat16).float()
    blk_err = float((blk - blk_want).abs().max())
    blk_diff = int((blk != blk_want).sum())
    del blk, blk_want
    rows = list(SUBLANE_ZERO_ROWS[mode])
    zero_ok = True
    if rows:
        w_zero = torch.zeros_like(w)
        w_zero[rows] = w[rows]
        zero_ok = not bool(ss.sublane_stores(x, w_zero, mode).any())
    ok = (rel <= ss.KERNEL_TOL[mode] and blk_err <= ss.BLOCK_TOL[mode]
          and finite and zero_ok)
    rec = dict(mode=mode, tiles=tiles, err=abs_err, rel=rel,
               blk_err=blk_err, blk_diff=blk_diff, zero_ok=zero_ok, ok=ok)
    line = (f"[sublane] S5 {mode} at {tiles} tiles, (sin, cos) states: "
            f"max|err| {abs_err:.3e} = {rel:.3e} of the largest (bound "
            f"{ss.KERNEL_TOL[mode]:.2e}); bf16 blocks max|d| {blk_err:.3e} "
            f"(bound {ss.BLOCK_TOL[mode]:.2e}), {blk_diff} entries differ; "
            f"rows {rows[0] if rows else '-'}.."
            f"{rows[-1] if rows else '-'} zero: {zero_ok}")
    if tiles == SUBLANE_TILES[0]:
        ms = time_ms(lambda: ss.sublane_stores(x_spike, w, mode), reps=20)
        with full_fp32():
            plain_ms = time_ms(
                lambda: ss.sublane_stores_plain(x_spike, w, mode), reps=3)
        a = (ss.sublane_blocks_plain(x_spike, "base").to(torch.bfloat16)
             .transpose(1, 2).reshape(-1, ss.ROWS).contiguous())
        lib_bf16 = time_ms(lambda: torch.mm(a, w), reps=20)
        library_ms = time_ms(lambda: torch.mm(a, w, out_dtype=torch.float32),
                             reps=20)
        del a
        flops, nbytes = kernel_bound(tiles)
        b_ms, b_by = bound(flops, nbytes)
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_bf16_ms=lib_bf16, bound=(b_ms, b_by))
        line += (f"; kernel {ms:.4f} ms ({1e3 * ms / tiles:.4f} us/tile), "
                 f"plain {plain_ms:.4f} ms, cuBLAS torch.mm on the prebuilt "
                 f"block {library_ms:.4f} ms f32 out, {lib_bf16:.4f} ms bf16 "
                 f"out, bound {b_ms:.4f} ms ({b_by})")
    print(line + (" ok" if ok else " FAIL"))
    return rec


def phase_spikes_4f(device, seed: int):
    """Phase 4f. -> (S2 records, S5 records, launches of the two tools'
    run)."""
    import importlib

    import torch

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    pipe = [r for n, s in PIPE_SHAPES
            for r in pipe_case(device, params, gen, n, s)]
    sub = [sublane_case(device, mode, tiles) for tiles in SUBLANE_TILES
           for mode in ("base", "stores", "dmatrix")]
    if not all(r["ok"] for r in pipe + sub):
        raise PhaseError("a pipelined render or sublane-stores kernel "
                         "disagrees with K1 or its plain version")
    torch.cuda.synchronize()
    zero_counts()
    for tool, argv in SPIKE_RUNS_4F:
        mod = importlib.import_module(f"crnerf_tpu_torch.tools.{tool}")
        if mod.main(argv) != 0:
            raise PhaseError(f"{tool} {' '.join(argv)} failed")
    torch.cuda.synchronize()
    launches = read_counts()
    # the interleave tool also launches K1 as its yardstick
    new = ("pipe_render_fwd", "sublane_stores")
    if not (all(launches[k] > 0 for k in new)
            and not any(v for k, v in launches.items()
                        if k not in new + ("fused_render_fwd",))):
        raise PhaseError(f"4f tools: launch counters {launches}")
    print(f"[pipe] the two spike tools' launches: {launches}")
    return pipe, sub, launches


def tf32_check(state, batch):
    """CGNet's mask and its parameters' gradients on the step's style
    images with TF32 allowed in cuDNN, as PyTorch's default has it in a
    user's process (set here: earlier phases' tools turn it off), against
    the same with TF32 off: its convolutions are pinned to IEEE fp32, so
    the same bits. The gradients come from a seeded cotangent on its
    logits, with cuDNN held to its deterministic algorithms
    (``tools.tf32_ab.cgnet_eval``), so that the bits do not move from run
    to run."""
    import torch

    from crnerf_tpu_torch.tools.tf32_ab import cgnet_eval

    cgnet = state.system.implicit_mask
    whole01 = (batch["whole_img"][:, 0] + 1.0) / 2.0
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        flag = torch.backends.cudnn.conv.fp32_precision
        mask, grads = cgnet_eval(cgnet, whole01)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    with full_fp32():
        ref_mask, ref_grads = cgnet_eval(cgnet, whole01)
    same = (torch.equal(mask, ref_mask)
            and all(torch.equal(a, b) for a, b in zip(grads, ref_grads)))
    err = max(float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
              for a, b in zip([mask, *grads], [ref_mask, *ref_grads]))
    print(f"[train] CGNet at a user's flags (cudnn allow_tf32 True, conv "
          f"fp32_precision {flag!r}) against TF32 off: mask and "
          f"{len(grads)} gradients "
          f"{'the same bits' if same else 'OTHER BITS'} (max {err:.3e} of "
          f"the largest)")
    if not same:
        raise PhaseError("CGNet with TF32 allowed differs from IEEE fp32: "
                         "its convolutions are not pinned")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile_dir", type=str, default="",
                   help="also profile one serve render, and write the "
                        "train step's profile table, into this directory")
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
        train_records = phase_train_kernels(device, SEED)
        recompute_records = phase_recompute(device, SEED)
        composite_records, composite_launches = phase_composite(device, SEED)
        mlp_fwd_records, mlp_bwd_records = phase_mlp_kernels(device, SEED)
        conv3_records, packed_records, sincos_records, spike_launches = \
            phase_conv(device, SEED)
        pipe_records, sublane_records, launches_4f = phase_spikes_4f(
            device, SEED)
        os.makedirs(BUILD, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            launches, p50, full_frame = phase_serve(
                device, SEED, workdir, args.profile_dir or None)
        print(f"[serve] p50 {p50} ms per {FRAME_WH[0]}x{FRAME_WH[1]} "
              f"frame at 256+256 samples, bf16 ({card})")
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            mlp_serve_launches, mlp_p50, _ = phase_serve(
                device, SEED, workdir, None, full_frame,
                pallas_render=False)
        print(f"[serve] pallas_render=False: p50 {mlp_p50} ms per frame "
              f"against {p50} on the full route ({card})")
        train_launches, step_ms, peak, grads = phase_train(
            device, SEED, args.profile_dir or None)
        print(f"[train] median {step_ms:.2f} ms per step, "
              f"{TRAIN_GRIDS * 1024 / step_ms * 1e3:.0f} train rays/s "
              f"({card})")
        route_launches = {}
        for route in ("pallas_stash=False", "pertube_cord=True",
                      "pallas_render=False"):
            route_launches[route], r_ms, r_peak, r_grads = phase_train(
                device, SEED, None, route)
            print(f"[train] route {route}: median {r_ms:.2f} ms per step "
                  f"against {step_ms:.2f} on the stash route, "
                  f"{TRAIN_GRIDS * 1024 / r_ms * 1e3:.0f} train rays/s, peak "
                  f"memory {r_peak:.2f} GiB against {peak:.2f} ({card})")
            if not r_peak < peak:
                raise PhaseError(f"{route}: peak memory {r_peak:.2f} GiB is "
                                 f"not below the stash route's {peak:.2f}")
            if route == "pallas_stash=False":
                routes_agree("stash", grads, route, r_grads)
            if route == "pallas_render=False":
                # another forward (the dir term's sum, compositing outside)
                # and autograd's compositing backward: fp32 rounding apart
                routes_agree("stash", grads, route, r_grads, tol=1e-3)
        m_ms, m_peak = module_route_reading(device, SEED)
        print(f"[train] route pallas_train=False (the module under autograd "
              f"with remat): median {m_ms:.2f} ms per step against "
              f"{step_ms:.2f} on the stash route, peak memory {m_peak:.2f} "
              f"GiB ({card})")
    except Exception as e:  # any phase failing fails the run
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    # every kernel's entry at the shape its main path gives it: the serve
    # tile's fine pass (8192 rays x S=512) and the train step's fine pass
    # (16,384 rays x S=128), bf16, recurrence encode
    main_kernel = next(r for r in records
                       if r["N"] == SERVE_TILE and r["S"] == 512)
    tk = next(r for r in train_records
              if r["N"] == TRAIN_GRIDS * 1024 and r["S"] == 128)

    def at_fine_pass(recs, xyz_in):
        return next(r for r in recs if r["N"] == TRAIN_GRIDS * 1024
                    and r["S"] == 128 and r["xyz_in"] == xyz_in)

    def entry(name, source, replaces, n_launch, err, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r.get("library_ms")}

    def train_kernel(key):      # one kernel's numbers of the stash pair
        return {k: tk[k][key] for k in ("ms", "plain_ms", "bound")}

    def fwd_err(xyz_in):
        return max(max(r["err_weights"], r["err_fmap"], r["err_depth"])
                   for r in records if r["xyz_in"] == xyz_in)

    def recompute_err(xyz_in):
        return max(r["abs_err"] for r in recompute_records
                   if r["xyz_in"] == xyz_in)

    k1, k2, k3 = ("crnerf_tpu/ops/fused_render.py:348",
                  "crnerf_tpu/ops/fused_render.py:648",
                  "crnerf_tpu/ops/fused_render.py:437")
    fwd_cu = "crnerf_tpu_torch/csrc/fused_render_fwd.cuh"
    bwd_cu = "crnerf_tpu_torch/csrc/fused_render_bwd.cuh"
    rec_cu = "crnerf_tpu_torch/csrc/fused_render_bwd_recompute.cu"
    route_a = route_launches["pallas_stash=False"]
    route_b = route_launches["pertube_cord=True"]
    route_c = route_launches["pallas_render=False"]
    k4_fwd = next(r for r in mlp_fwd_records
                  if r["N"] == SERVE_TILE and r["S"] == 512)
    k4_bwd = next(r for r in mlp_bwd_records
                  if r["N"] == TRAIN_GRIDS * 1024 and r["S"] == 128)
    conv_cuh = "crnerf_tpu_torch/csrc/conv_fwd.cuh"
    conv3_train = [r for r in conv3_records
                   if r["shape"] == CONV3_SHAPES[1]]
    print(json.dumps({"kernels": [
        # launched by the serve path and by the pallas_stash=False route
        entry("fused_render_fwd", fwd_cu, k1,
              launches + route_a["fused_render_fwd"], fwd_err(False),
              main_kernel),
        entry("fused_render_fwd_stash", fwd_cu, k1,
              train_launches["fused_render_fwd_stash"],
              max(r["err_fwd"] for r in train_records),
              train_kernel("fwd_stash")),
        entry("fused_render_bwd", bwd_cu, k2,
              train_launches["fused_render_bwd"],
              max(r["abs_chain"] for r in train_records),
              train_kernel("chain")),
        entry("fused_render_bwd_wgrad", bwd_cu, k2,
              train_launches["fused_render_bwd_wgrad"],
              max(r["abs_wgrad"] for r in train_records),
              train_kernel("wgrad")),
        entry("K1 xyz-in", fwd_cu, k1, route_b["fused_render_fwd_xyz"],
              fwd_err(True), at_fine_pass(records, True)),
        entry("K3 rays-in", rec_cu, k3,
              route_a["fused_render_bwd_recompute"], recompute_err(False),
              at_fine_pass(recompute_records, False)),
        entry("K3 xyz-in", rec_cu, k3,
              route_b["fused_render_bwd_recompute_xyz"], recompute_err(True),
              at_fine_pass(recompute_records, True)),
        entry("K5", "crnerf_tpu_torch/csrc/composite.cu",
              "crnerf_tpu/ops/composite.py:34", composite_launches,
              max(r["err"] for r in composite_records),
              composite_records[0]),
        # launched by the pallas_render=False serve path and training step
        entry("K4 fwd", "crnerf_tpu_torch/csrc/fused_mlp_fwd.cuh",
              "crnerf_tpu/ops/fused_mlp.py:431",
              mlp_serve_launches + route_c["fused_mlp_fwd"],
              max(r["err"] for r in mlp_fwd_records), k4_fwd),
        entry("K4 bwd", "crnerf_tpu_torch/csrc/fused_mlp_bwd.cu",
              "crnerf_tpu/ops/fused_mlp.py:494", route_c["fused_mlp_bwd"],
              max(r["err"] for r in mlp_bwd_records), k4_bwd),
        # launched by the spike tools (phase 4e); the conv entries' numbers
        # at enc_a's conv3 in the train step and at the encoder's conv3
        # level, sincos's at the anchor scale 1280 rad
        entry("conv3x3 fwd", conv_cuh, "scripts/spike_conv3x3.py:30",
              spike_launches["conv3x3_fwd"],
              max(r["err"] for r in conv3_records if r["kind"] == "fwd"),
              conv3_train[0]),
        entry("conv3x3 dw", "crnerf_tpu_torch/csrc/conv.cu",
              "scripts/spike_conv3x3.py:74", spike_launches["conv3x3_dw"],
              max(r["err"] for r in conv3_records if r["kind"] == "dw"),
              conv3_train[1]),
        entry("packed conv", conv_cuh, "scripts/spike_packed_conv.py:39",
              spike_launches["packed_conv"],
              max(r["err"] for r in packed_records), packed_records[0]),
        entry("sincos", "crnerf_tpu_torch/csrc/sincos.cu",
              "scripts/spike_kernel_sincos.py:24", spike_launches["sincos"],
              max(r["err"] for r in sincos_records),
              next(r for r in sincos_records if r["scale"] == 1280.0)),
        # launched by the two spike tools of phase 4f; S2's numbers at the
        # spike's 8192 x 128 with P = 2, its error against its plain version
        # (it gives K1's bits); S5's at 2048 tiles, stores mode
        entry("pipe render fwd", "crnerf_tpu_torch/csrc/pipe_render_fwd.cu",
              "scripts/spike_interleave.py:47",
              launches_4f["pipe_render_fwd"],
              max(r["err_plain"] for r in pipe_records
                  if r["err_plain"] is not None),
              next(r for r in pipe_records
                   if (r["N"], r["S"]) == PIPE_ENTRY and r["P"] == 2)),
        entry("sublane stores", "crnerf_tpu_torch/csrc/sublane_stores.cu",
              "scripts/spike_sublane_stores.py:40",
              launches_4f["sublane_stores"],
              max(r["err"] for r in sublane_records),
              next(r for r in sublane_records
                   if r["tiles"] == SUBLANE_TILES[0]
                   and r["mode"] == "stores")),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
