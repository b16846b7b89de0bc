#!/usr/bin/env python3
"""Drive the PyTorch port (crnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # build, kernel checks, serve, train

Phases, each fatal on failure:
  1. versions, the card's name and power limit; no CUDA device -> exit 1
  2. build every kernel from csrc/ with nvcc (sm_90a), the sources side by
     side; ptxas's registers and spills printed, and the phase fails on
     its note C7520 (it serialised a kernel's wgmma) or on a spill in a
     wgmma kernel of the NeRF MLP (WGMMA_KERNELS: the fused render
     forward's two instances and its chain, in their own libraries and in
     the recompute's, the fused MLP's forward, both instances, and its
     chain)
  3. the forward kernel's mma.sync variant against its plain PyTorch
     version at full width (8x256, C=64) on 1024 rays, S=256 and S=512,
     bf16 and fp32, exact encode and the recurrence; max abs error of
     weights, fmap and depth against the stated tolerances, and the
     kernel's time beside the plain version's; then the same at the serve
     path's own launch, an 8192-ray tile at S=256 and S=512, bf16 with the
     recurrence, and at the pallas_stash=False step's (16,384 x 128); then
     its xyz-in form (one jittered coordinate per sample point) on 1024
     rays x 128 in both dtypes and encodes and at the pertube_cord step's
     own launches (16,384 rays, S=64 and 128, bf16), where without jitter
     it gives the rays-in launch's bits; then the wgmma variant (bf16) on
     1024 rays at S=256 and 512 in both encodes, its xyz-in form, and at
     the serve launches (8192 x 256 and 512) and at the no-stash steps'
     launches (routes A and B: 16,384 x 128 rays-in, x 64 and x 128
     xyz-in), against its plain version and against the mma.sync variant
     on the same inputs, the two timed in turns (medians of 6 readings)
     with TFLOP/s and share of the bound
  4. the training kernels at full width on 1024 rays, S=64 and S=128, bf16
     with the recurrence and fp32 with the exact encode: the stash forward
     (outputs bit-identical to its own kernel's no-stash forward, stash
     against the plain version's) and the two backward kernels against the
     plain backward on the same stash, with random non-zero cotangents;
     twice on the same inputs gives the same bits; then the same at the
     train step's own launches, 16,384 rays at S=64 and S=128, bf16 with
     the recurrence (the plain versions over 1024-ray slices of the
     inputs). Each shape takes its variants: at bf16 the wgmma stash
     forward and chain, and beside them the mma.sync pair on the same
     inputs (its stash against the wgmma one, its chain on the wgmma stash
     against the plain version, the stash backward of each pair from its
     own forward against the other's), each kernel timed in turns with its
     counterpart (medians of 6 readings), TFLOP/s and share of the bound;
     at the step's launches the weight gradient also in turns with cuBLAS,
     one torch.mm a tile of its tile table (bf16 in, fp32 out)
  4b. the recompute backward (no stash from the forward; rays-in and
     xyz-in) on each variant (mma.sync at every shape, wgmma at bf16)
     against its plain version at the same shapes, twice for the same
     bits, against the stash backward of the same variant's pair on the
     same inputs, its scratch rows against that pair's (bit for bit), the
     wgmma variant timed in turns with mma.sync, and its scratch at two
     batch sizes; from the inputs the bound holds where no ReLU at a ray's
     last sample (delta 1e2) is open in one forward and shut in the other,
     and where one is, each such flip lies within the forwards' stated
     difference and the bound holds with those points' masks the
     kernel's; a draw that exceeded the bound without that is kept
     (``knife_edge_draw``)
  4c. the compositing kernel against its plain version at 8192 x 512 x 64
     and a ragged shape, on the fused forward's own sigma and features
     against the fused forward's outputs, and once as its users call it
  4d. the per-point fused MLP pair at full width: the forward's mma.sync
     variant against its plain version on 1024 x 128 points, bf16 with
     the recurrence and fp32 exact, one direction per ray and one per
     point, a ragged shape, then at route C's launches (16,384 x 64 and x
     128, bf16); its wgmma variant (bf16) on 1024 x 128 in both encodes
     and both direction forms, a ragged shape, points from p_base > 0, then
     at the serve launches (8192 x 256 and x 512), each against the plain
     version and against mma.sync on the same inputs and timed in turns
     with it (medians of 6 readings), TFLOP/s and share of the bound;
     and at route C's launches (16,384 x 64 and x 128);
     the forward through composite against the fused render's xyz-in
     ray block at fp32; the backward's mma.sync variant (both dtypes) and
     wgmma variant (bf16: both encodes and both direction forms, a ragged
     run, route C's launches) against its plain version on one shared
     forward (tight bound) and from the inputs (loose bound), twice for
     the same bits, at its own slab size against one slab (bf16 5e-4;
     fp32 the sums against their error model, on the kept draw too,
     ``slab_edge_draw``), the wgmma one also against mma.sync on the same
     inputs, its slab stash rows against the wgmma stash forward's (bit
     for bit) and timed in turns with mma.sync; and its scratch at two
     batch sizes
  4e. the conv spikes' kernels (S1, S4) and the sincos kernel (S3): the 3x3
     conv forward and its weight gradient at the spike's shape (8 x 160 x
     224, 64 -> 64), at enc_a's conv3 in the train step (16 x 160 x 224,
     64 -> 64) and at two ragged shapes, the gradient twice for the same
     bits; the packed 2x2 conv at the encoder's two levels (4C = 256, 512)
     and at two ragged shapes, and, after _d2s, against the 3x3 conv of the
     reflect-padded original; sin/cos at the spike's five scales against
     float64 (the fast intrinsics' error printed); each kernel against its
     plain version, with its time beside the plain version's, cuDNN's (or
     torch.sin + torch.cos) and its bound; the conv kernels and cuDNN
     timed in turns (cuDNN, kernel, kernel, cuDNN; medians of 6 readings
     of 20 calls), each beside its own bound, and the variant each shape
     took (wgmma or mma.sync, from the launch counters: a main shape, C and
     Co multiples of 64, must take wgmma); sincos and torch.sin +
     torch.cos the same way, and each one's device time (a CUDA graph of
     20 calls) beside the bound; then the three spike tools as a user runs
     them, counters zeroed before and read after (no mma.sync launch)
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
     counters are zeroed just before and read just after: every forward
     launch of a frame on the wgmma kernel, none on mma.sync
  6. train at full size: the flagship config (16 grids of 1024 rays, 64+64
     samples, 8x256, bf16) on the synthetic scene through make_train_step;
     warm-up, timed steps, one profiled step, CGNet's mask and parameter
     gradients on the step's style images with TF32 allowed in cuDNN, as a
     user's process has it, against the same with TF32 off (the same bits:
     its convolutions are pinned to IEEE fp32), and a small fp32 step on
     the card against the same step on the CPU; the
     launch counters are zeroed just before the timed steps and read just
     after: every stash forward and chain launch on the wgmma kernels, none
     on mma.sync; and around the small fp32 step, whose pair is the
     mma.sync one
  7. the two no-stash routes of the same step, pallas_stash=False (rays-in
     forward, recompute backward) and pertube_cord=True (xyz-in forward,
     recompute backward): warm-up, timed steps, launch counters (every
     forward and recompute launch of the bf16 step on the wgmma kernels,
     every one of the small fp32 step on mma.sync), no stash alive after a
     forward, peak memory beside the stash route's, a small fp32 step of
     each on the card against the CPU, and pallas_stash=False against the
     stash route on the same batch and draws
  8. the per-point route, pallas_render=False, through the same entry
     points: 2 served frames (two fused-MLP launches per tile, all on the
     wgmma forward, none on mma.sync nor of the fused render's) against
     the full route's frame, a small frame card against CPU; the flagship
     training step (one fused-MLP forward and one backward launch per
     pass, both wgmma, none of the fused render's), a small fp32 step card
     against CPU (both on mma.sync), its NeRF gradients against the stash
     route's; and one
     timed reading of the module route, pallas_train=False
  9. train, resume and evaluate from the CLI, on a phototourism cache the
     port's save_scene_cache writes (3 train images of 512x384, 2 test
     images of 384x512, appearance 224x160: 36 steps an epoch): the train
     app in this process for one epoch at the flagship config, the launch
     counters zeroed just before and read just after (every stash
     forward, chain and weight gradient launch on the wgmma kernels, K1's
     in the validations, none on mma.sync), metrics rows, a finite final
     validation, the full checkpoint and weights.npz, steps/s, rays/s and
     peak memory; then in subprocesses, as a user runs them:
     ``python -m crnerf_tpu_torch train`` sent SIGTERM once its
     metrics.jsonl shows step 20 (exit 0, "preempted: checkpointed at
     step N") and relaunched with --auto_resume to the end; the resumed
     run's last checkpoint (parameters, buffers, Adam's state, the cache
     and its validity) and final validation the straight run's bits (a
     step gives the same bits from run to run); beside the resume,
     ``eval --split val``, an empty split (exit 0), prepare, train and
     eval with no card to be seen, with the default and with --device
     cuda (non-zero exit), and ``eval --split test_test`` of the straight
     run, its PNGs the bits of an in-process Renderer on the same
     weights.npz, its median and p95 s a frame (read beside the resumed
     run); last, the in-process frames' warm time
 10. the apps that need an image codec, on phase 9's checkpoint and scene
     at the flagship config, each counted run's launch counters zeroed
     just before and read just after (every K1, stash forward, chain and
     weight gradient launch on wgmma, none on mma.sync): (a) ``eval
     --split test``, the camera path at 320x240 and 256+256, 12 frames:
     12 PNGs, a frame the in-process Renderer's bits, the GIF's blocks (12
     image descriptors of 320x240, looping), its per-frame p50 and p95;
     (b) the ``video`` app on 2 seeded style PNGs, 12 frames each, the
     same checks; (c) ``metrics`` on phase 9's test_test renders, equal to
     train/metrics.py on the same arrays, and in a subprocess with a
     render deleted (non-zero exit, "expected"); (d) serve's
     ``render_path`` through RenderService.handle, 8 frames, the style a
     PNG registered by encode_style; (e) a Blender scene of 4 train and 2
     test RGBA PNGs of 800x800 written with zlib, rows filtered with every
     filter type (decoded to the bits written, the decode time printed),
     trained at 400x400 with ``--data_perturb color occ`` for one epoch
     (39 steps at the flagship config) with panels every 10 steps and a
     profiler window over steps 10-15 (the panels and the trace checked;
     steps/s, rays/s, peak memory), then ``eval --split test_test`` and
     ``metrics`` in subprocesses
 11. data parallelism, on phase 9's cache at the flagship config: (a) one
     rank over NCCL (on a TCP store the script hosts), the Trainer for 12
     steps, the same bits as without a group; (b) two ranks of 8 grids on
     the one card over gloo (NCCL refuses two ranks on one device), CUDA
     tensors, each started as torchrun starts one, on a store the script
     hosts: one step against one process of 16 grids on the same batch and
     draws (parameters within tests/test_torch_train_step.py's one-step
     bound, the ranks' states the same bits; CGNet's gradient on the
     16-grid step's input and cotangent, 16 images at once against 8 + 8
     and against float64, each within twice the JAX package's own fp32
     distance from float64, ``CGNET_SHARE_BOUND``), the train app's
     per-rank ``run`` for one epoch (steps/s, global rays/s, each rank's
     peak memory, the launch counters zeroed just before and read just
     after: every stash forward, chain and weight gradient on wgmma, K1 in
     the sharded validations), a CLI run
     sent SIGTERM at rank 1 alone once step 20 is logged (both exit 0, one
     checkpoint), ``--auto_resume`` to the timed run's bits, and ``eval
     --split test_test`` on two ranks to the in-process render's bits;
     (c) where two cards are visible, ``train --num_devices 2`` over NCCL
     to the gloo run's bits, else a line saying it did not run
 12. the reference's own training command, on phase 9's cache at the
     flagship config: (a) ``train --encode_a --encode_c --encode_random
     --use_mask`` (Adam 5e-4, cosine) for one epoch in this process, the
     launch counters zeroed just before and read just after (every stash
     forward, chain and weight gradient on wgmma, K1 in the validations),
     a finite loss/content_constraint in every metrics row and a finite
     final validation, steps/s and peak memory beside phase 9's; (b) the
     same with ``--optimizer ranger`` straight, and stopped by SIGTERM
     once step 20 is logged (past the Lookahead syncs at 6, 12 and 18),
     then ``--auto_resume`` to the straight run's last checkpoint bit for
     bit (parameters, buffers, moments, slow weights, counts, cache); (c)
     the small fp32 step at encode_c on the stash route against
     pallas_train=False on the same batch and draws, the NeRF MLPs' and
     enc_cont's gradients under ``routes_agree``'s bound, and three radam
     steps at the flagship config, finite; (d) the zoo's legacy pair
     ``Encoder3`` -> ``Decoder3`` at 1 x 160 x 224 x 3 on seeded weights
     against the CPU (1e-5 of the largest), its backward twice for the
     same bits, and ``get_ndc_rays`` on 4096 rays against the CPU; (e)
     CGNet's ``norm="group"``: the small fp32 stash-route step card against
     CPU, one flagship bf16 step with the launch counters zeroed just
     before and read just after (every stash forward, chain and weight
     gradient on wgmma, none on mma.sync), CGNet's backward on its style
     images twice for the same bits, the step timed in turns with the
     batch-norm step, and its weights.npz served through
     RenderService.handle, one 320x240 frame at 256+256 (K1 on wgmma), the
     bits of an in-process Renderer
 13. the 2-D (data, model) mode (``parallel/tp.py``) on the module route
     (pallas_train=False: no hand kernel) at the flagship widths, two
     model ranks on the one card over gloo, each started as torchrun
     starts one, on a store the script hosts: (a) the small fp32 step
     against the one-process step on the same card and draws (parameters
     within rtol 1e-3 + 2e-5, the loss 2e-5, the replicated tensors the
     same bits on both ranks); (b) 2
     grids of 1024 rays, step 1 against one process on the same draws
     (loss and psnr 1e-3, each split leaf's Adam first moment within 1e-2
     of its largest plus half the leaf's own bf16 error, the one process's
     bf16 moment against its fp32 one; the replicas' bits), then one timed
     step: steps/s, peak memory a rank beside the one process's, the
     collectives' bytes
     a step; (c) where two cards are visible, (b) over NCCL, a rank a
     card, else a line saying it did not run
Prints a {"kernels": [...]} line, the card line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when a
phase fails or no CUDA device is present.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import functools
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


def timed_phase(fn):
    """A phase function whose seconds are printed when it returns, as
    ``[run] <name>: <s> s``."""
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"[run] {fn.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out
    return run


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


def full_width_params(seed: int, device, depth: int = 8, width: int = 256,
                      c: int = 64):
    """Seeded NerfMLP weights (PyTorch's default init) in the kernel's (in,
    out) layout: 8x256, C=64 unless named."""
    import torch

    from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
    from crnerf_tpu_torch.ops.fused_render import mlp_params_from_module

    torch.manual_seed(seed)
    return mlp_params_from_module(NerfMLP(depth=depth, width=width,
                                          out_dim=c).to(device))


# the wgmma kernels of the NeRF MLP, by the name ptxas reports: phase 2
# fails on a spill in any of their instances (the fused render's forward,
# both forms, in fused_render_fwd.cu and in the recompute's library; its
# chain, in fused_render_bwd.cu and the recompute's; the fused MLP's
# forward, both forms, in fused_mlp_fwd.cu and fused_mlp_bwd.cu; the fused
# MLP's chain; K2's weight gradient, in the three backward libraries; the
# ping-pong S2, in pipe_render_fwd.cu)
WGMMA_KERNELS = ("render_fwd_wgmma_kernel", "render_bwd_chain_wgmma_kernel",
                 "mlp_fwd_wgmma_kernel", "mlp_bwd_chain_wgmma_kernel",
                 "wgrad_wgmma_kernel", "pipe_render_wgmma_kernel")


@timed_phase
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
    serialised, spilled = [], []
    for source in loaders:
        log = _build.BUILD_LOG.get(source, "(cached build)")
        print(f"[build] {source} (all {len(loaders)} sources in {dt:.1f} s)")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            # registers, spills, and ptxas's note when it serialises wgmma
            if any(k in line for k in ("registers", "spill", "error",
                                       "Performance")):
                print("[build]  " + line.strip())
            if "C7520" in line:
                serialised.append(source)
            if (any(k in entry for k in WGMMA_KERNELS)
                    and "spill stores" in line
                    and ", 0 bytes spill stores, 0 bytes spill loads"
                    not in line):
                spilled.append(entry)
    if serialised:
        raise PhaseError(f"ptxas serialised the wgmma of {serialised} "
                         "(note C7520): a wait or branch between the "
                         "products of one group")
    if spilled:
        raise PhaseError(f"a wgmma kernel spills: {spilled}")


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
                 xyz_in: bool = False, variant: str = "mma"):
    """The forward kernel's ``variant`` on n rays x s samples against
    render_fwd_plain on the same inputs (slice by slice) -> record.
    ``xyz_in``: the kernel's xyz-in form on jittered points; and with the
    unjittered points handed in as xyz it must give the rays-in launch's
    bits. The wgmma variant is also held to the mma.sync one on the same
    inputs (KERNEL_TOL) and the two are timed in turns."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr
    from crnerf_tpu_torch.tools._common import turns_ms

    o, d, z, noise = ray_inputs(n, s, gen, device)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    xyz = jittered_points(o, d, z, gen) if xyz_in else None

    def plain():        # one slice's results alive at a time
        for sl in ray_slices(n):
            yield sl, fr.render_fwd_plain(
                params, o[sl], d[sl], z[sl], noise[sl], 15, 4, dt, exact,
                xyz=None if xyz is None else xyz[sl])

    def kernel(v=variant):
        return fr.render_fwd(kw, None if xyz_in else o, d, z, noise, exact,
                             stash=False, xyz=xyz, variant=v)[:2]

    def errs(blk, w, blk_r, w_r):
        return ((w - w_r).abs().max().item(),
                (blk[:, :64] - blk_r[:, :64]).abs().max().item(),
                (blk[:, 64] - blk_r[:, 64]).abs().max().item())

    err = [0.0, 0.0, 0.0]
    same_bits = True
    err_mma = None
    with full_fp32():
        blk_k, w_k = kernel()
        if xyz_in:
            exact_pts = (o[:, None, :] + d[:, None, :]
                         * z[..., None]).contiguous()
            blk_x, w_x, _ = fr.render_fwd(kw, None, d, z, noise, exact,
                                          False, xyz=exact_pts,
                                          variant=variant)
            blk_r, w_r, _ = fr.render_fwd(kw, o, d, z, noise, exact, False,
                                          variant=variant)
            same_bits = torch.equal(blk_x, blk_r) and torch.equal(w_x, w_r)
            del exact_pts, blk_x, w_x, blk_r, w_r
        if variant == "wgmma":
            err_mma = errs(blk_k, w_k, *kernel("mma"))
        for sl, (blk_p, w_p) in plain():
            for i, e in enumerate(errs(blk_k[sl], w_k[sl], blk_p, w_p)):
                err[i] = max(err[i], e)
    tol = fr.KERNEL_TOL[dt]
    passed = (bool(torch.isfinite(blk_k).all() and torch.isfinite(w_k).all())
              and all(e <= t for e, t in zip(err, tol)) and same_bits
              and (err_mma is None
                   or all(e <= t for e, t in zip(err_mma, tol))))
    mma_ms = None
    if variant == "wgmma":
        ms, mma_ms = turns_ms(kernel, lambda: kernel("mma"), device, reps=3)
    else:
        ms = time_ms(kernel)
    plain_ms = time_ms(lambda: drain(plain()), reps=3 if n == N_RAYS else 1)
    f_fwd, _, _ = mlp_work(params, s)
    # per ray the forward reads [o | d] (or 3 coordinates a point), z,
    # noise and the dir encode and writes the ray block and the weights,
    # all f32
    b_ms, b_by = bound(n * s * f_fwd,
                       n * ((3 * s if xyz_in else 8) + 2 * s + 27 + 128
                            + s) * 4, dt == torch.bfloat16)
    dt_name = str(dt)[6:]
    form = ("xyz-in, no-jitter bits equal rays-in "
            f"{same_bits}, " if xyz_in else "")
    vs_mma = ("" if err_mma is None else
              " vs mma.sync max|dw|={:.3e} max|dfmap|={:.3e} "
              "max|ddepth|={:.3e};".format(*err_mma))
    turns = ("" if mma_ms is None else
             f" in turns with mma.sync {mma_ms:.3f} ms "
             f"({n * s * f_fwd / mma_ms / 1e9:.0f} TFLOP/s, "
             f"{100 * b_ms / mma_ms:.0f}% of the bound),")
    print(f"[kernel] {variant} {form}{n} rays x S={s} {dt_name:8s} "
          f"exact={exact!s:5s} max|dw|={err[0]:.3e} "
          f"max|dfmap|={err[1]:.3e} max|ddepth|={err[2]:.3e} tol={tol};"
          f"{vs_mma} kernel {ms:.3f} ms ({n * s * f_fwd / ms / 1e9:.0f} "
          f"TFLOP/s, {100 * b_ms / ms:.0f}% of the bound),{turns} plain "
          f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
          f"{'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, exact=exact, xyz_in=xyz_in,
                variant=variant, err_weights=err[0], err_fmap=err[1],
                err_depth=err[2], err_mma=err_mma, tol=tol, ms=ms,
                mma_ms=mma_ms, plain_ms=plain_ms, bound=(b_ms, b_by),
                ok=passed)


@timed_phase
def phase_kernel(device, seed: int):
    """The forward kernel against its plain version. The mma.sync variant:
    1024 rays at S=256 and S=512 in both dtypes and encodes, then the
    serve path's own launch (SERVE_TILE rays, bf16, recurrence) and the
    pallas_stash=False step's, then the xyz-in form. The wgmma variant:
    1024 rays at S=256 and 512, its xyz-in form, the serve launches, each
    also against the mma.sync variant. Returns the per-case records."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cases = [(N_RAYS, s, dt, exact) for s in (256, 512)
             for dt in (torch.bfloat16, torch.float32)
             for exact in (True, False)]
    cases += [(SERVE_TILE, s, torch.bfloat16, False) for s in (256, 512)]
    cases += [(TRAIN_GRIDS * 1024, 128, torch.bfloat16, False)]
    # the xyz-in form: 1024 rays, then the pertube_cord step's own launches
    cases += [(N_RAYS, 128, dt, exact, True)
              for dt in (torch.bfloat16, torch.float32)
              for exact in (True, False)]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, True)
              for s in (64, 128)]
    # the wgmma variant: 1024 rays, its xyz-in form, the serve launches
    cases += [(N_RAYS, s, torch.bfloat16, exact, False, "wgmma")
              for s in (256, 512) for exact in (True, False)]
    cases += [(N_RAYS, 256, torch.bfloat16, False, True, "wgmma")]
    cases += [(SERVE_TILE, s, torch.bfloat16, False, False, "wgmma")
              for s in (256, 512)]
    # and the no-stash training forwards of routes A and B at their own
    # launches, each in turns with the mma.sync variant
    cases += [(TRAIN_GRIDS * 1024, 128, torch.bfloat16, False, False,
               "wgmma")]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, True, "wgmma")
              for s in (64, 128)]
    before = dict(fr.LAUNCH_COUNTS)
    records = [forward_case(device, params, gen, *case) for case in cases]
    if any(fr.LAUNCH_COUNTS[k] <= before[k]
           for k in ("fused_render_fwd", "fused_render_fwd_xyz",
                     "fused_render_fwd_mma", "fused_render_fwd_xyz_mma")):
        raise PhaseError("kernel launch counter did not rise")
    if not all(r["ok"] for r in records):
        raise PhaseError("kernel disagrees with its plain version")
    slower = [(r["S"], r["ms"], r["mma_ms"]) for r in records
              if r["variant"] == "wgmma" and r["N"] == SERVE_TILE
              and r["ms"] >= r["mma_ms"]]
    if slower:
        print(f"[kernel] the wgmma forward is not faster than mma.sync at "
              f"the serve launches (S, ms, mma.sync ms): {slower}")
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


@timed_phase
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
    print(f"[{tag}] forward launches on the wgmma kernel: "
          f"{launches[key]}, on mma.sync: {launches[key + '_mma']}")

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


def mlp_work(params, per_dir: float):
    """Operations per sample point of one pass, from the weights' shapes:
    (forward, backward chain, backward weight gradient) in FLOP, products
    only (2 per multiply-add). The dir layer's dir-encode rows make a term
    per direction (the dir term, and its weight gradient), shared by the
    ``per_dir`` points of a direction: counted once a direction."""
    width = params.final_w.shape[0]
    mats = [*params.trunk_w, params.sigma_w, params.final_w,
            params.dir_w[:width], params.feat_w]
    fwd = 2.0 * (sum(m.numel() for m in mats)
                 + params.dir_w[width:].numel() / per_dir)
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


def seeded_state(cfg, device, seed: int, scene_wh):
    """Seeded system, optimizer, schedule and state on ``device``, and
    staged batches of the synthetic scene, through the entry points a user
    would call -> (state, schedule, staged)."""
    import torch

    from crnerf_tpu_torch.data.pipeline import TrainPipeline
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from crnerf_tpu_torch.render.system import CrNerfSystem
    from crnerf_tpu_torch.train.optim import make_optimizer
    from crnerf_tpu_torch.train.state import TrainState

    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=scene_wh,
                                 appearance_wh=cfg.appearance_wh)
    pipe = TrainPipeline(scene, batch_size=cfg.batch_size)
    torch.manual_seed(seed)
    system = CrNerfSystem(cfg).to(device)
    opt, sched = make_optimizer(cfg, pipe.iterations, system.parameters())
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    state = TrainState.create(system, opt, cfg.N_vocab, 32, cfg.nerf_out_dim,
                              generator=gen)
    staged = [{k: torch.from_numpy(v).to(device)
               for k, v in pipe.make_global_batch(
                   0, i, cfg.grids_per_step).items()}
              for i in range(TRAIN_STAGED)]
    return state, sched, staged


def make_trainer(cfg, device, seed: int, scene_wh, chunks: int):
    """``seeded_state``'s state and staged batches with the step function
    -> (state, step, staged)."""
    from crnerf_tpu_torch.train.step import make_train_step

    state, sched, staged = seeded_state(cfg, device, seed, scene_wh)
    step = make_train_step(state.system, state.optimizer, sched,
                           grids_per_step=cfg.grids_per_step,
                           grad_accum_chunks=chunks)
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

    kinds = (("K1 wgmma render_fwd_wgmma_kernel (either form)",
              ("render_fwd_wgmma_kernel",)),
             ("K1 mma.sync render_fwd_kernel (every form)",
              ("render_fwd_kernel",)),
             ("K2 chain wgmma render_bwd_chain_wgmma_kernel",
              ("render_bwd_chain_wgmma_kernel",)),
             ("K2 chain mma.sync render_bwd_chain_kernel",
              ("render_bwd_chain_kernel",)),
             ("K4 wgmma mlp_fwd_wgmma_kernel (forward and the backward's "
              "recompute)", ("mlp_fwd_wgmma_kernel",)),
             ("K4 mma.sync mlp_fwd_kernel (forward and the backward's "
              "recompute)", ("mlp_fwd_kernel",)),
             ("K4 chain wgmma mlp_bwd_chain_wgmma_kernel",
              ("mlp_bwd_chain_wgmma_kernel",)),
             ("K4 chain mma.sync mlp_bwd_chain_kernel",
              ("mlp_bwd_chain_kernel",)),
             ("K2 weight gradient wgrad_wgmma_kernel (or the mma.sync / "
              "fp32 one) + reduce_partials",
              ("wgrad_wgmma_kernel", "wgrad_bf16_kernel", "wgrad_f32_kernel",
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

# The training routes: Config fields that select them, the kernels one
# pass of the flagship step launches (forward, then backward: bf16 at the
# served widths) and those one pass of the small fp32 step launches (the
# mma.sync variants and the fp32 weight gradient). K2's weight gradient runs
# in every route's backward: once a pass on the stash route, once a slab
# inside the recompute backwards (``slab_launches``); at bf16 the wgmma
# kernel, one slab a pass in the small fp32 steps.
ROUTES = {
    "stash": (dict(), ("fused_render_fwd_stash", "fused_render_bwd",
                       "fused_render_bwd_wgrad"),
              ("fused_render_fwd_stash_mma", "fused_render_bwd_mma",
               "fused_render_bwd_wgrad_fp32")),
    "pallas_stash=False": (dict(pallas_stash=False),
                           ("fused_render_fwd",
                            "fused_render_bwd_recompute",
                            "fused_render_bwd_wgrad"),
                           ("fused_render_fwd_mma",
                            "fused_render_bwd_recompute_mma",
                            "fused_render_bwd_wgrad_fp32")),
    "pertube_cord=True": (dict(pertube_cord=True),
                          ("fused_render_fwd_xyz",
                           "fused_render_bwd_recompute_xyz",
                           "fused_render_bwd_wgrad"),
                          ("fused_render_fwd_xyz_mma",
                           "fused_render_bwd_recompute_xyz_mma",
                           "fused_render_bwd_wgrad_fp32")),
    "pallas_render=False": (dict(pallas_render=False),
                            ("fused_mlp_fwd", "fused_mlp_bwd",
                             "fused_render_bwd_wgrad"),
                            ("fused_mlp_fwd_mma", "fused_mlp_bwd_mma",
                             "fused_render_bwd_wgrad_fp32")),
}


def slab_launches(route: str, n: int, device) -> int:
    """K2's weight-gradient launches of one coarse (S=64) and one fine
    (S=128) pass of n rays on a recompute route of the flagship step: one a
    slab of K3 (routes A, B) or of K4-bwd (route C), the slabs as the
    wrappers cut them."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr

    kw = fr.prepare_kernel_weights(full_width_params(SEED, device), 15, 4,
                                   torch.bfloat16)
    total = 0
    for s in (64, 128):
        if route == "pallas_render=False":
            mkw = fm.prepare_mlp_weights(kw.params, 15, 4, torch.bfloat16)
            total += -(-n * s // fm.slab_points_for(mkw, n * s, device))
        else:
            total += -(-n // fr.slab_rays_for(kw, n, s, device))
    return total


def small_step_inputs(seed: int, **kw):
    """The small fp32 step's config (2 grids of 64 rays, 8 + 8 samples,
    6 x 64, SGD) with ``kw``, and its seeded draws -> (config, draws)."""
    import torch

    cfg = train_config(
        compute_dtype="float32", grids_per_step=2, batch_size=64,
        N_samples=8, N_importance=8, netdepth=6, netwidth=64,
        nerf_out_dim=16, N_emb_xyz=10, N_vocab=8, appearance_wh=(64, 48),
        optimizer="sgd", momentum=0.0, lr=0.05, **kw)
    g, b, s, i = 2, 64, 8, 8
    gen = torch.Generator().manual_seed(seed + 3)
    draws = {"z_u": torch.rand(g, b, s, generator=gen),
             "noise_coarse": torch.randn(g, b, s, generator=gen),
             "noise_fine": torch.randn(g, b, s + i, generator=gen),
             "pdf_e": torch.empty(g, b, i + 1).exponential_(generator=gen),
             # read by the pertube_cord route only
             "pertube_coarse": torch.rand(g, b, s, 3, generator=gen),
             "pertube_fine": torch.rand(g, b, s + i, 3, generator=gen)}
    return cfg, draws


def small_step(device, seed: int, cfg, draws):
    """The small fp32 step of ``small_step_inputs``' ``cfg`` and ``draws``
    on ``device``, from its seeded weights and batch -> (metrics,
    parameter deltas on the CPU, each parameter's largest |value| before,
    gradients by parameter name, the step's launch counts)."""
    import torch

    state, step, staged = make_trainer(cfg, device, seed, (24, 18), 1)
    before = {k: v.detach().clone()
              for k, v in state.system.named_parameters()}
    zero_counts()
    with full_fp32():
        state, m = step(state, staged[0],
                        {k: v.to(device) for k, v in draws.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    params = dict(state.system.named_parameters())
    return ({k: float(v) for k, v in m.items()},
            {k: (v.detach() - before[k]).cpu() for k, v in params.items()},
            {k: float(v.abs().max()) for k, v in before.items()},
            {k: v.grad.detach().clone() for k, v in params.items()},
            launches)


def small_step_check(device, seed: int, route: str = "stash", **kw):
    """The small fp32 step of ``route`` (and the Config fields ``kw``) on
    the card against the CPU -> the card's gradients of that step, by
    parameter name, and its launch counts."""
    import torch

    cfg, draws = small_step_inputs(seed, **ROUTES[route][0], **kw)
    route += "".join(f", {k}={v}" for k, v in kw.items())
    out = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        m, deltas, scales, g, launches = small_step(dev, seed, cfg, draws)
        out[where] = (m, deltas, scales)
        if where == "card":
            grads, card_launches = g, launches
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
    return grads, card_launches


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


@timed_phase
def phase_train(device, seed: int, profile_dir=None, route: str = "stash"):
    """The flagship train step on the card through make_train_step, on
    one of ``ROUTES``. Returns (launch counts of the timed steps, median
    ms per step, peak GiB, the small step's gradients on the card, the
    small fp32 step's launch counts)."""
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
    if route != "stash":      # the weight gradient: one launch a slab
        want["fused_render_bwd_wgrad"] = TRAIN_STEPS * chunks * slab_launches(
            route, cfg.grids_per_step * cfg.batch_size // chunks, device)
    if launches != want:
        raise PhaseError(f"{route}: launch counters {launches}, expected "
                         f"{want}")
    print(f"[train] {route}: the step's forward and backward launches "
          f"{ {k: launches[k] for k in ROUTES[route][1]} }, none elsewhere")
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
    grads, small = small_step_check(device, seed, route)
    # fp32 stays on the mma.sync kernels: the small step's two passes
    want = {k: (2 if k in ROUTES[route][2] else 0) for k in small}
    print(f"[train] {route}: the small fp32 step's launches "
          f"{ {k: small[k] for k in ROUTES[route][2]} }, none elsewhere")
    if small != want:
        raise PhaseError(f"the fp32 {route} step's launches {small}, "
                         f"expected {want}")
    return launches, med, peak_gb, grads, small


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


def train_kernel_bounds(params, kw, n: int, s: int, bf16: bool):
    """Bounds of the training kernels over ``n`` rays of ``s`` points: each
    kernel alone (the chain writes the dz buffer and the weight gradient
    reads it back), and the backward as a whole, the function the two
    replace: stash in, weight gradients out, no dz in device memory."""
    from crnerf_tpu_torch.ops import fused_render as fr

    lay = fr.grad_layout(kw.dims)
    esz = 2 if bf16 else 4
    pts = n * s
    f_fwd, f_chain, f_wgrad = mlp_work(params, s)
    return dict(
        fwd_stash=bound(pts * f_fwd, pts * lay.sc * esz, bf16),
        chain=bound(pts * f_chain,
                    pts * (lay.o_hf + kw.dims["HP"] + lay.dc) * esz, bf16),
        wgrad=bound(pts * f_wgrad,
                    pts * (lay.sc + lay.dc) * esz + lay.wt * 4, bf16),
        bwd_whole=bound(pts * (f_chain + f_wgrad),
                        pts * lay.sc * esz + (lay.wt + lay.bt) * 4, bf16),
    )


# K2's wgmma weight gradient against the mma.sync one on the same stash and
# dz buffer (and against itself over two halves of the points, the second
# adding onto the first), over the largest gradient: both sum the same
# exact bf16 products in fp32, in other splits and another order inside
# the tensor cores, ~1e5-2e5 terms a split. Each side is ~2.4e-4 from an
# fp64 sum at 16,384 x 128 (GRAD_TOL's note); twice that, rounded up.
WGRAD_VS_MMA = 5e-4


def wgrad_checks(kw, st, dz, gw, n: int, s: int, device, step_shape: bool):
    """K2's wgmma weight gradient (``gw``, on the whole stash and dz
    buffer) against the mma.sync kernel on the same inputs, over two halves
    of the points with ``accumulate``, and at the step's launches also on
    the rows of a K3 slab and of a K4-bwd slab against both the mma.sync
    kernel and the plain version (fp64 over slices) -> (ok, readings)."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr

    def rel(got, want):
        return ((got.double() - want.double()).abs().max()
                / want.double().abs().max()).item()

    out = dict(vs_mma=rel(gw, fr.bwd_wgrad(kw, st, dz, variant="mma")))
    half = st.shape[0] // 2
    first = fr.bwd_wgrad(kw, st[:half], dz[:half])
    out["accumulate"] = rel(fr.bwd_wgrad(kw, st[half:], dz[half:],
                                         out=first), gw)
    ok = out["vs_mma"] <= WGRAD_VS_MMA and out["accumulate"] <= WGRAD_VS_MMA
    if step_shape:
        mkw = fm.prepare_mlp_weights(kw.params, 15, 4, kw.compute_dtype)
        for name, pts in (("K3", fr.slab_rays_for(kw, n, s, device) * s),
                          ("K4-bwd", fm.slab_points_for(mkw, n * s,
                                                        device))):
            got = fr.bwd_wgrad(kw, st[:pts], dz[:pts])
            plain = torch.zeros_like(got, dtype=torch.float64)
            for p0 in range(0, pts, N_RAYS * s):
                p1 = min(pts, p0 + N_RAYS * s)
                plain += fr.bwd_wgrad_plain(kw, st[p0:p1], dz[p0:p1])
            mma = fr.bwd_wgrad(kw, st[:pts], dz[:pts], variant="mma")
            out[name] = (pts, rel(got, plain), rel(got, mma))
            ok = (ok and out[name][1] <= fr.GRAD_TOL[kw.compute_dtype]
                  and out[name][2] <= WGRAD_VS_MMA)
    return ok, out


def train_kernels_case(device, params, gen, n: int, s: int, dt,
                       exact: bool):
    """K1-stash and the two K2 kernels on n rays x s samples against their
    plain versions on the same inputs, stash and random non-zero
    cotangents; the forward and the chain are the variants the shape takes
    (at bf16 and the served widths the wgmma pair). The plain versions run
    over 1024-ray slices, and the slices' gradients are summed in fp64.
    Where the pair is the wgmma one the mma.sync pair runs on the same
    inputs: its stash against the wgmma stash, its chain on the same stash
    against the plain version, each of the two timed in turns with its
    wgmma counterpart (medians of 6 readings), and the whole stash
    backward of each pair, each from its own forward, against the other's
    (held to RECOMPUTE_VS_PLAIN at the step's own launches). -> record."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr
    from crnerf_tpu_torch.tools._common import turns_ms

    c = 64
    bf16 = dt == torch.bfloat16
    dt_name = str(dt)[6:]
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    lay = fr.grad_layout(kw.dims)
    fwd_v = fr.render_variant(kw.dims)
    chain_v = fr.chain_variant(kw.dims, s)
    wgrad_v = fr.wgrad_variant(kw.dims)
    both = fwd_v == "wgmma"       # the mma.sync pair beside the wgmma one
    step_shape = n == TRAIN_GRIDS * 1024
    slices = ray_slices(n)
    o, d, z, noise = ray_inputs(n, s, gen, device)
    g_ray = torch.zeros(n, fr._round_up(c + 1, fr.LANE), device=device)
    g_ray[:, :c + 1] = torch.randn(n, c + 1, generator=gen,
                                   device=device) * 0.1
    g_w = torch.randn(n, s, generator=gen, device=device) * 0.1
    dir_blk = fr.dir_block(kw, d, exact)

    def points(sl):
        return slice(sl.start * s, sl.stop * s)

    def fwd(variant, stash=True):
        return fr.render_fwd(kw, o, d, z, noise, exact, stash=stash,
                             variant=variant)

    def chain(st, variant):
        return fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w,
                            variant=variant)

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

    def stash_diff(a, b):
        """(entries that differ, entries, largest difference, largest
        entry of b) of two slices of stash rows."""
        diff = (a.float() - b.float()).abs()
        return ((diff > 0).sum().item(), diff.numel(), diff.max().item(),
                b.float().abs().max().item())

    def share(parts):
        """Slices' stash_diff -> (share of entries that differ, largest
        difference over the largest entry)."""
        differ, count, big, scale = zip(*parts)
        return sum(differ) / sum(count), max(big) / max(scale)

    def fwd_err(blk, w, sl, blk_p, w_p):
        return max((w[sl] - w_p).abs().max().item(),
                   (blk[sl, :c + 1] - blk_p[:, :c + 1]).abs().max().item())

    def stash_ok(frac, big):
        if bf16:
            return frac <= STASH_TOL_BF16[0] and big <= STASH_TOL_BF16[1]
        return big <= STASH_TOL_FP32

    def grads(gw, gb):
        return fr.flatten_params(fr.unpack_grads(kw, gw, gb))

    def worst(want, got):
        return max(((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(want, got))

    mma = {}
    with full_fp32():
        # the stash form against its own kernel's no-stash launch
        blk0, w0, _ = fwd(fwd_v, stash=False)
        blk1, w1, st = fwd(fwd_v)
        dz_k, gb_k = chain(st, chain_v)
        gw_k = fr.bwd_wgrad(kw, st, dz_k)
        dz_2, gb_2 = chain(st, chain_v)
        gw_2 = fr.bwd_wgrad(kw, st, dz_2)
        repeat_bits = (torch.equal(dz_k, dz_2) and torch.equal(gb_k, gb_2)
                       and torch.equal(gw_k, gw_2))
        del dz_2
        if both:
            # the mma.sync stash forward on the same inputs, held to its
            # own no-stash launch
            blk_m0, w_m0, _ = fwd("mma", stash=False)
            blk_m, w_m, st_m = fwd("mma")
            mma["bits"] = torch.equal(blk_m0, blk_m) and torch.equal(w_m0,
                                                                     w_m)
            del blk_m0, w_m0
        err_fwd = err_m = 0.0
        plain_st = []
        for sl, (blk_p, w_p, st_p) in zip(slices, fwd_plain()):
            err_fwd = max(err_fwd, fwd_err(blk1, w1, sl, blk_p, w_p))
            if both:
                err_m = max(err_m, fwd_err(blk_m, w_m, sl, blk_p, w_p))
            plain_st.append(stash_diff(st[points(sl)], st_p))
        st_frac, st_max = share(plain_st)
        gb_p = torch.zeros(lay.bt, dtype=torch.float64, device=device)
        gw_p = torch.zeros(lay.wt, dtype=torch.float64, device=device)
        for sl, (dz_p, gb_s) in zip(slices, chain_plain(st)):
            gb_p += gb_s
            gw_p += fr.bwd_wgrad_plain(kw, st[points(sl)], dz_p)
        # each kernel alone against its plain version on the same inputs
        gw_on_kernel_dz = wgrad_plain(st, dz_k)
        wg_ok, wg = True, None
        if wgrad_v == "wgmma":
            wg_ok, wg = wgrad_checks(kw, st, dz_k, gw_k, n, s, device,
                                     step_shape)
        if both:
            # the mma.sync pair: its stash against the wgmma one's, its
            # chain on the wgmma stash against the plain version
            mma["err_fwd"] = err_m
            mma["stash_vs_wgmma"] = share(
                stash_diff(st[points(sl)], st_m[points(sl)]) for sl in slices)
            dz_mw, gb_mw = chain(st, "mma")
            mma["abs_chain"] = (gb_mw - gb_p).abs().max().item()
            mma["err_chain"] = mma["abs_chain"] / gb_p.abs().max().item()
            mma["err_grad"] = worst(grads(gw_p, gb_p),
                                    grads(fr.bwd_wgrad(kw, st, dz_mw),
                                          gb_mw))
            del dz_mw
            # the whole stash backward of the mma.sync pair, from its own
            # forward, against the wgmma pair's
            dz_mm, gb_mm = chain(st_m, "mma")
            gw_mm = fr.bwd_wgrad(kw, st_m, dz_mm)
            del dz_mm, st_m
            mma["pair_vs_pair"] = worst(grads(gw_mm, gb_mm),
                                        grads(gw_k, gb_k))
        torch.cuda.synchronize()
    same_bits = torch.equal(blk0, blk1) and torch.equal(w0, w1)
    st_ok = stash_ok(st_frac, st_max)
    got = grads(gw_k, gb_k)
    rel = worst(grads(gw_p, gb_p), got)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    abs_chain = (gb_k - gb_p).abs().max().item()
    abs_wgrad = (gw_k - gw_on_kernel_dz).abs().max().item()
    err_chain = abs_chain / gb_p.abs().max().item()
    err_wgrad = abs_wgrad / gw_on_kernel_dz.abs().max().item()
    passed = (same_bits and repeat_bits and st_ok and finite and wg_ok
              and rel <= fr.GRAD_TOL[dt] and err_wgrad <= fr.GRAD_TOL[dt]
              and err_fwd <= max(fr.KERNEL_TOL[dt]))
    if both:
        passed = (passed and mma["bits"] and stash_ok(*mma["stash_vs_wgmma"])
                  and mma["err_grad"] <= fr.GRAD_TOL[dt]
                  and mma["err_fwd"] <= max(fr.KERNEL_TOL[dt])
                  and (not step_shape or mma["pair_vs_pair"]
                       <= RECOMPUTE_VS_PLAIN[dt_name]))
    t_nostash = time_ms(lambda: fwd(fwd_v, stash=False))
    library, wgrad_turns = {}, None
    if both and step_shape:
        # the weight gradient in turns with the mma.sync kernel, then with
        # cuBLAS, one torch.mm a tile of the kernel's own tile table
        tile, tile_n, _ = fr._WGRAD_TILES[wgrad_v]
        table = fr._tile_table(lay, tile, str(device), tile_n).tolist()
        ms = {}
        ms["wgrad"], mma["wgrad_ms"] = turns_ms(
            lambda: fr.bwd_wgrad(kw, st, dz_k),
            lambda: fr.bwd_wgrad(kw, st, dz_k, variant="mma"), device,
            reps=3)
        wgrad_turns, library["wgrad"] = turns_ms(
            lambda: fr.bwd_wgrad(kw, st, dz_k),
            lambda: cublas_tiles(table, st, dz_k), device, reps=3)
    else:
        ms = dict(wgrad=time_ms(lambda: fr.bwd_wgrad(kw, st, dz_k)))
    if both:
        ms["fwd_stash"], mma_fwd = turns_ms(lambda: fwd("wgmma"),
                                            lambda: fwd("mma"), device,
                                            reps=3)
        ms["chain"], mma_chain = turns_ms(lambda: chain(st, "wgmma"),
                                          lambda: chain(st, "mma"), device,
                                          reps=3)
        mma["ms"] = dict(fwd_stash=mma_fwd, chain=mma_chain)
    else:
        ms["fwd_stash"] = time_ms(lambda: fwd(fwd_v))
        ms["chain"] = time_ms(lambda: chain(st, chain_v))
    reps = 3 if n == N_RAYS else 1
    plain = dict(fwd_stash=time_ms(lambda: drain(fwd_plain()), reps),
                 chain=time_ms(lambda: drain(chain_plain(st)), reps),
                 wgrad=time_ms(lambda: wgrad_plain(st, dz_k), reps))
    pts = n * s
    bounds = train_kernel_bounds(params, kw, n, s, bf16)
    work = dict(zip(("fwd_stash", "chain", "wgrad"), mlp_work(params, s)))

    def rate(key, t):
        return (f"{t:.3f} ms ({pts * work[key] / t / 1e9:.0f} TFLOP/s, "
                f"{100 * bounds[key][0] / t:.0f}% of the bound)")

    each = " ".join(
        f"{k} {ms[k]:.3f}/{plain[k]:.3f}/{bounds[k][0]:.3f} "
        f"({pts * work[k] / ms[k] / 1e9:.0f} TFLOP/s)" for k in work)
    print(f"[train-kernel] {n} rays x S={s} {dt_name:8s} forward {fwd_v}, "
          f"chain {chain_v}: no-stash bits equal {same_bits}, repeat bits "
          f"equal {repeat_bits}; fwd max|d|={err_fwd:.3e}; stash: "
          f"{st_frac:.2e} of entries differ, max {st_max:.3e} of the "
          f"largest; grads max rel {rel:.3e} (tol {fr.GRAD_TOL[dt]}), chain "
          f"alone {err_chain:.3e}, wgrad alone {err_wgrad:.3e}; ms "
          f"kernel/plain/bound: forward no stash {t_nostash:.3f}, {each}; "
          f"the backward as a whole {ms['chain'] + ms['wgrad']:.3f} ms "
          f"against a bound of {bounds['bwd_whole'][0]:.3f} ms "
          f"({bounds['bwd_whole'][1]}, no dz buffer)"
          + (f"; the weight gradient ({wgrad_v}) in turns with mma.sync: "
             f"{rate('wgrad', ms['wgrad'])} against "
             f"{rate('wgrad', mma['wgrad_ms'])}; with cuBLAS, one torch.mm "
             f"a tile of its table (bf16 in, fp32 out): "
             f"{rate('wgrad', wgrad_turns)} against "
             f"{rate('wgrad', library['wgrad'])}" if library else "")
          + f" {'ok' if passed else 'FAIL'}")
    if wg:
        slabs = "".join(
            f"; on a {k} slab's {wg[k][0]} points: {wg[k][1]:.3e} of the "
            f"plain version (tol {fr.GRAD_TOL[dt]}), {wg[k][2]:.3e} of "
            f"mma.sync" for k in ("K3", "K4-bwd") if k in wg)
        print(f"[train-kernel] {n} rays x S={s} {dt_name:8s} the wgmma "
              f"weight gradient: {wg['vs_mma']:.3e} of the mma.sync kernel "
              f"on the same inputs, {wg['accumulate']:.3e} of itself over "
              f"two halves of the points, the second accumulating (bound "
              f"{WGRAD_VS_MMA}){slabs}; {err_wgrad:.3e} of the plain "
              f"version (tol {fr.GRAD_TOL[dt]}); the same bits twice "
              f"{repeat_bits} {'ok' if wg_ok else 'FAIL'}")
    if both:
        frac_m, max_m = mma["stash_vs_wgmma"]
        print(f"[train-kernel] {n} rays x S={s} {dt_name:8s} mma.sync pair "
              f"on the same inputs: its no-stash bits equal {mma['bits']}, "
              f"fwd max|d|={mma['err_fwd']:.3e}; its stash against the "
              f"wgmma one: {frac_m:.2e} of entries differ, max {max_m:.3e} "
              f"(bound {STASH_TOL_BF16}); its chain on the wgmma stash: "
              f"grads max rel {mma['err_grad']:.3e}, chain alone "
              f"{mma['err_chain']:.3e} (tol {fr.GRAD_TOL[dt]}); the stash "
              f"backward of each pair from its own forward, one against the "
              f"other: {mma['pair_vs_pair']:.3e} (bound "
              f"{RECOMPUTE_VS_PLAIN[dt_name]}"
              f"{'' if step_shape else ', not held at this shape'}); in "
              f"turns: stash forward wgmma {rate('fwd_stash', ms['fwd_stash'])}"
              f" against mma.sync {rate('fwd_stash', mma['ms']['fwd_stash'])}"
              f", chain wgmma {rate('chain', ms['chain'])} against mma.sync "
              f"{rate('chain', mma['ms']['chain'])}")
    return dict(N=n, S=s, dtype=dt_name, ok=passed, err_fwd=err_fwd,
                err_grad=rel, abs_chain=abs_chain, abs_wgrad=abs_wgrad,
                ms=ms, plain_ms=plain, bound=bounds, library_ms=library,
                fwd_variant=fwd_v, chain_variant=chain_v,
                wgrad_variant=wgrad_v, wgrad=wg, mma=mma or None)


def cublas_tiles(table, st, dz):
    """The weight gradient as cuBLAS computes it: one torch.mm a tile of
    the kernel's tile table (``table``, its rows as lists: dW = A^T dZ
    over all points), bf16 in, fp32 out. A yardstick only: the port does
    not call it."""
    import torch

    return [torch.mm(st[:, a:a + k].T, dz[:, b:b + n],
                     out_dtype=torch.float32)
            for a, k, b, n, _, _ in table]


@timed_phase
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
# Phase 4b's cases in the order they draw from its generator (seed + 4),
# and the draw an earlier version of this phase made after them: its cases
# ran again at bf16, so the second rays-in case at 16,384 x 128 drew after
# seventeen others. That draw read 8.691e-2 against RECOMPUTE_VS_PLAIN on
# both variants; it is kept (``knife_edge_draw``) with the check below.
KNIFE_EDGE_AFTER = 17


def recompute_inputs(n: int, s: int, gen, device, xyz_in: bool, c: int = 64):
    """Phase 4b's draws for one case: rays, jittered points (xyz-in), the
    cotangents of the ray block and of the weights."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr

    o, d, z, noise = ray_inputs(n, s, gen, device)
    xyz = jittered_points(o, d, z, gen) if xyz_in else None
    g_ray = torch.zeros(n, fr._round_up(c + 1, fr.LANE), device=device)
    g_ray[:, :c + 1] = torch.randn(n, c + 1, generator=gen,
                                   device=device) * 0.1
    g_w = torch.randn(n, s, generator=gen, device=device) * 0.1
    return o, d, z, noise, xyz, g_ray, g_w


def recompute_cases():
    """Phase 4b's cases (n, s, dtype, exact, xyz_in), in drawing order."""
    import torch

    cases = [(N_RAYS, s, dt, exact, xyz_in) for xyz_in in (False, True)
             for s in (64, 128)
             for dt, exact in ((torch.bfloat16, False),
                               (torch.float32, True))]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, xyz_in)
              for xyz_in in (False, True) for s in (64, 128)]
    return cases


def knife_edge_draw(device, seed: int):
    """A generator in the state the kept draw was made from: phase 4b's
    cases, then its bf16 cases again, drawn up to KNIFE_EDGE_AFTER."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed + 4)
    cases = recompute_cases()
    cases += [case for case in cases if case[2] == torch.bfloat16]
    for n, s, _, _, xyz_in in cases[:KNIFE_EDGE_AFTER]:
        recompute_inputs(n, s, gen, device, xyz_in)
    return gen


def relu_flips(kw, st_k, st_p, noise, tol_h: float, tol_pre: float):
    """The ReLUs open in one forward and shut in the other, between two
    stashes of the same points (the kernel's, and the plain version's as
    its slices of N_RAYS rays, ``ray_slices``): the
    trunk's and the dir layer's (a stash entry > 0 on one side only) and
    the compositing's on softplus(z_sigma) + noise (z_sigma from each
    stash's h_{L-1}, as the chain computes it). -> dict: ``rows``, the
    points with a flip at a ray's last sample, whose delta is DELTA_INF
    (there one flip moves the point's term ~100x an ordinary one); per
    kind the flips there and in all; ``unexplained``, those flips at the
    last samples whose open side lies farther from zero than the two
    forwards' stated difference (``tol_h`` of the largest activation for a
    stash entry, ``tol_pre`` for the pre-activation); the largest such
    margin; and up to eight examples."""
    import torch

    from crnerf_tpu_torch.models.nerf_mlp import softplus

    n, s = noise.shape
    wp, hp, n_layers = kw.dims["WP"], kw.dims["HP"], kw.dims["L"]
    o_dd = (n_layers + 1) * wp
    cols = list(range(0, n_layers * wp)) + list(range(o_dd, o_dd + hp))
    ws = kw.padded["ws"][:, 0].to(kw.compute_dtype).float()
    bs = float(kw.padded["bs"][0])
    last = torch.zeros(n * s, dtype=torch.bool, device=noise.device)
    last[s - 1::s] = True
    scale = max(st_k.float().abs().max().item(), 1e-30)
    out = dict(trunk=0, trunk_last=0, sigma=0, sigma_last=0, unexplained=0,
               margin=0.0, examples=[])
    rows = []
    step = N_RAYS * s
    for p0, part in zip(range(0, n * s, step), st_p):
        sl = slice(p0, min(p0 + step, n * s))
        a, b = st_k[sl].float(), part.float()
        hk, hp_ = a[:, cols], b[:, cols]
        flip_h = (hk > 0) != (hp_ > 0)
        open_h = torch.maximum(hk, hp_)
        top = slice((n_layers - 1) * wp, n_layers * wp)
        nz = noise.reshape(-1)[sl]
        pre_k = softplus(a[:, top] @ ws + bs) + nz
        pre_p = softplus(b[:, top] @ ws + bs) + nz
        flip_s = (pre_k > 0) != (pre_p > 0)
        at_last = last[sl]
        out["trunk"] += int(flip_h.sum())
        out["trunk_last"] += int(flip_h[at_last].sum())
        out["sigma"] += int(flip_s.sum())
        out["sigma_last"] += int(flip_s[at_last].sum())
        row_flip = (flip_h.any(1) | flip_s) & at_last
        idx = row_flip.nonzero()[:, 0]
        for i in idx.tolist():
            m_h = float(open_h[i][flip_h[i]].max()) / scale \
                if bool(flip_h[i].any()) else 0.0
            m_s = float((pre_k[i] - pre_p[i]).abs()) if bool(flip_s[i]) \
                else 0.0
            bad = m_h > tol_h or m_s > tol_pre
            out["unexplained"] += int(bad)
            out["margin"] = max(out["margin"], m_h / tol_h, m_s / tol_pre)
            if len(out["examples"]) < 8:
                p = p0 + i
                out["examples"].append(dict(
                    ray=p // s, sample=p % s, trunk_flips=int(flip_h[i].sum()),
                    open_margin=m_h, pre_kernel=float(pre_k[i]),
                    pre_plain=float(pre_p[i])))
        rows.append(idx + p0)
    out["rows"] = torch.cat(rows)
    return out


def recompute_bound(params, n: int, s: int, bf16: bool, xyz_in: bool):
    """Bound of the recompute backward as a function: the forward's inputs
    and the cotangents in, the gradients out; the forward again, the chain
    and the weight gradient in operations."""
    f_fwd, f_chain, f_wgrad = mlp_work(params, s)
    n_params = sum(t.numel() for t in (*params.trunk_w, *params.trunk_b,
                                       *params[2:]))
    per_ray = (3 * s if xyz_in else 8) + 2 * s + 27 + 128 + s
    return bound(n * s * (f_fwd + f_chain + f_wgrad),
                 (n * per_ray + n_params) * 4, bf16)


def recompute_case(device, params, gen, n: int, s: int, dt, exact: bool,
                   xyz_in: bool, label: str = ""):
    """The recompute backward on n rays x s samples, rays-in or xyz-in
    (jittered points), on each variant the dtype takes (mma.sync; at bf16
    also wgmma), all on the same inputs and cotangents: each at its own
    slab size against the plain version from those inputs (1024-ray
    slices, gradients summed in fp64), against the plain backward on the
    stash the same variant's stash forward writes for these inputs (the
    rows the slabs recompute), run twice, and against the stash backward
    of the same variant's pair; with one slab its scratch rows against
    that pair's, bit for bit. The wgmma variant is also held to the
    mma.sync one and timed in turns with it.

    From the inputs the bound holds on a draw where no ReLU at a ray's
    last sample is open in the kernel's forward and shut in the plain
    one's (``relu_flips``). Where one is, each such flip must lie within
    the two forwards' stated difference of zero (the stash's
    ``STASH_TOL_*``, the per-point sigma's ``fused_mlp.KERNEL_TOL``), and
    the bound holds with those points' rows given the kernel's masks (the
    plain backward on the plain stash with those rows taken from the
    kernel's). -> records, mma.sync first."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr
    from crnerf_tpu_torch.tools._common import turns_ms

    torch.cuda.empty_cache()     # the last case's blocks, for 2 M points
    dt_name = str(dt)[6:]
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    lay = fr.grad_layout(kw.dims)
    slices = ray_slices(n)
    o, d, z, noise, xyz, g_ray, g_w = recompute_inputs(n, s, gen, device,
                                                       xyz_in)
    origins = None if xyz_in else o
    dir_blk = fr.dir_block(kw, d, exact)
    tol_h = (STASH_TOL_BF16[1] if dt == torch.bfloat16 else STASH_TOL_FP32)
    tol_pre = fm.KERNEL_TOL[dt][1]

    def kernel(v, slab_rays=None):
        return fr.bwd_recompute(kw, origins, d, z, noise, g_ray, g_w, exact,
                                xyz, slab_rays, v)

    def plain_stash():      # the plain forward's stash, a slice's rows each
        return [fr.render_fwd_plain(
            params, None if xyz_in else o[sl], d[sl], z[sl], noise[sl], 15,
            4, dt, exact, stash=True,
            xyz=None if xyz is None else xyz[sl])[2] for sl in slices]

    def plain_on(st, swap=None):
        """The plain backward on a stash (or its slices); ``swap``: (a
        stash, points) whose rows replace those points' rows."""
        gw = torch.zeros(lay.wt, dtype=torch.float64, device=device)
        gb = torch.zeros(lay.bt, dtype=torch.float64, device=device)
        for i, sl in enumerate(slices):
            lo, hi = sl.start * s, sl.stop * s
            rows = st[i] if isinstance(st, list) else st[lo:hi]
            if swap is not None:
                mine = swap[1][(swap[1] >= lo) & (swap[1] < hi)]
                if mine.numel():
                    rows = rows.clone()
                    rows[mine - lo] = swap[0][mine]
            dz_p, gb_s = fr.bwd_chain_plain(kw, z[sl], noise[sl],
                                            dir_blk[sl], rows, g_ray[sl],
                                            g_w[sl])
            gw += fr.bwd_wgrad_plain(kw, rows, dz_p)
            gb += gb_s
        return gw, gb

    def grads(gw, gb):
        return fr.flatten_params(fr.unpack_grads(kw, gw, gb))

    # the plain version from the inputs: its own forward's stash, then the
    # plain backward on it, slice by slice
    with full_fp32():
        st_p = plain_stash()
        gw_p, gb_p = plain_on(st_p)
    want = grads(gw_p, gb_p)
    scale = [a.abs().max().clamp_min(1e-30) for a in want]

    def worst(a_list, b_list):
        return max(((a - b).abs().max() / m).item()
                   for a, b, m in zip(a_list, b_list, scale))

    plain_ms = time_ms(lambda: plain_on(plain_stash()),
                       reps=3 if n == N_RAYS else 1)
    b_ms, b_by = recompute_bound(params, n, s, dt == torch.bfloat16, xyz_in)
    work = n * s * sum(mlp_work(params, s))
    bound = RECOMPUTE_VS_PLAIN[dt_name]
    records, got_mma = [], None
    for variant in (("mma", "wgmma") if dt == torch.bfloat16 else ("mma",)):
        key = ("fused_render_bwd_recompute_xyz" if xyz_in
               else "fused_render_bwd_recompute")
        key += "" if variant == "wgmma" else "_mma"
        before = dict(fr.LAUNCH_COUNTS)
        slab = fr.slab_rays_for(kw, n, s, device, variant=variant)
        with full_fp32():
            gw_k, gb_k, scratch = kernel(variant)
            gw_2, gb_2, _ = kernel(variant)
            repeat_bits = torch.equal(gw_k, gw_2) and torch.equal(gb_k, gb_2)
            del gw_2, gb_2
            # the stash route on the same inputs, on the pair of this
            # variant, whose stash form the slabs recompute
            _, _, st = fr.render_fwd(kw, origins, d, z, noise, exact,
                                     stash=True, xyz=xyz, variant=variant)
            dz_s, gb_s = fr.bwd_chain(kw, z, noise, dir_blk, st, g_ray, g_w,
                                      variant=variant)
            gw_s = fr.bwd_wgrad(kw, st, dz_s)
            # with every ray in one slab the scratch is the stash route's
            rows_equal = None
            if slab >= n:
                rows_equal = (torch.equal(scratch[0], st)
                              and torch.equal(scratch[1], dz_s))
            del scratch, dz_s
            gw_o, gb_o = plain_on(st)
            flips = relu_flips(kw, st, st_p, noise, tol_h, tol_pre)
            rel_same = None
            if flips["rows"].numel():   # those rows with the kernel's masks
                gw_h, gb_h = plain_on(st_p, (st, flips["rows"]))
            del st
            torch.cuda.synchronize()
        counted = (fr.LAUNCH_COUNTS[key] == before[key] + 2)
        got = grads(gw_k, gb_k)
        rel, vs_k2 = worst(want, got), worst(grads(gw_s, gb_s), got)
        rel_stash = worst(grads(gw_o, gb_o), got)
        if flips["rows"].numel():
            rel_same = worst(grads(gw_h, gb_h), got)
            inputs_ok = flips["unexplained"] == 0 and rel_same <= bound
        else:
            inputs_ok = rel <= bound
        vs_mma = None if got_mma is None else worst(got_mma, got)
        abs_err = max((gw_k - gw_p).abs().max().item(),
                      (gb_k - gb_p).abs().max().item())
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        passed = (repeat_bits and finite and counted
                  and rows_equal is not False and inputs_ok
                  and rel_stash <= fr.GRAD_TOL[dt]
                  and vs_k2 <= RECOMPUTE_VS_STASH[dt_name]
                  and (vs_mma is None or vs_mma <= bound))
        mma_ms = None
        if variant == "wgmma":
            ms, mma_ms = turns_ms(lambda: kernel("wgmma"),
                                  lambda: kernel("mma"), device, reps=3)
        else:
            ms = time_ms(lambda: kernel("mma"))
            got_mma = got
        turns = ("" if mma_ms is None else
                 f" in turns with mma.sync {mma_ms:.3f} ms "
                 f"({work / mma_ms / 1e9:.0f} TFLOP/s),")
        against_mma = ("" if vs_mma is None else
                       f" against the mma.sync variant on the same inputs "
                       f"{vs_mma:.3e} (bound {bound}),")
        knife = (f" ReLU flips kernel vs plain forward: {flips['trunk']} "
                 f"trunk/dir entries ({flips['trunk_last']} at a last "
                 f"sample), {flips['sigma']} sigma ({flips['sigma_last']} at "
                 f"a last sample), {flips['rows'].numel()} last-sample "
                 f"points, {flips['unexplained']} beyond the forwards' stated "
                 f"difference (largest margin {flips['margin']:.3f} of it)")
        if rel_same is not None:
            knife += (f", with those points' masks the kernel's: "
                      f"{rel_same:.3e} (tol {bound}); examples "
                      f"{flips['examples'][:3]}")
        print(f"[recompute] {label}{variant} "
              f"{'xyz-in ' if xyz_in else 'rays-in'} "
              f"{n} rays x S={s} {dt_name:8s} slabs of {slab} rays: grads "
              f"max rel {rel:.3e} against the plain version from the inputs "
              f"(tol {bound} where no last-sample ReLU flips),{knife}; "
              f"{rel_stash:.3e} against "
              f"the plain backward on the forward kernel's stash (tol "
              f"{fr.GRAD_TOL[dt]}), against the stash backward "
              f"{vs_k2:.3e} (bound {RECOMPUTE_VS_STASH[dt_name]}),"
              f"{against_mma} repeat bits equal {repeat_bits}, scratch rows "
              f"equal the stash route's {rows_equal}; kernel {ms:.3f} ms "
              f"({work / ms / 1e9:.0f} TFLOP/s),{turns} plain "
              f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
              f"{'ok' if passed else 'FAIL'}")
        records.append(dict(N=n, S=s, dtype=dt_name, xyz_in=xyz_in,
                            variant=variant, ok=passed, err_grad=rel,
                            err_same_masks=rel_same,
                            flips=flips["rows"].numel(),
                            err_on_stash=rel_stash, vs_stash=vs_k2,
                            vs_mma=vs_mma, abs_err=abs_err, ms=ms,
                            mma_ms=mma_ms, plain_ms=plain_ms,
                            bound=(b_ms, b_by), slab=slab, label=label))
    return records


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


@timed_phase
def phase_recompute(device, seed: int):
    """The recompute backward against its plain version, both input forms:
    1024 rays at S=64 and S=128, bf16 with the recurrence and fp32 with the
    exact encode, then the no-stash steps' own launches (16,384 rays, S=64
    and S=128, bf16, recurrence); the mma.sync variant at every shape, the
    wgmma one at bf16 on the same inputs; then the kept draw
    (``knife_edge_draw``) at 16,384 x 128 rays-in. Returns the records."""
    import torch

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    records = [r for case in recompute_cases()
               for r in recompute_case(device, params, gen, *case)]
    records += recompute_case(device, params, knife_edge_draw(device, seed),
                              TRAIN_GRIDS * 1024, 128, torch.bfloat16, False,
                              False, label="kept draw: ")
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
    return bound(m * mlp_work(params, m / n_dirs)[0],
                 (3 * m + 3 * n_dirs + m * (c + 1)) * 4, bf16)


def mlp_forward_case(device, params, gen, n: int, s: int, dt, exact: bool,
                     dir_rep: int, variant: str = "mma", p_base: int = 0):
    """The fused-MLP forward kernel's ``variant`` on the points of n rays x
    s samples from point ``p_base`` on (the directions: all n rays', one
    per ray or one per point) against mlp_fwd_plain on the same inputs
    (slice by slice) -> record. The wgmma variant is also held to the
    mma.sync one on the same inputs (KERNEL_TOL) and the two are timed in
    turns."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.tools._common import turns_ms

    c = 64
    xyz, d = mlp_inputs(n, s, dir_rep, gen, device)
    xyz = xyz[p_base:].contiguous()
    m = xyz.shape[0]
    mkw = fm.prepare_mlp_weights(params, 15, 4, dt)

    def plain():
        if p_base == 0:
            for pts, dirs in point_slices(m, dir_rep):
                yield pts, fm.mlp_fwd_plain(mkw, xyz[pts], d[dirs], exact,
                                            dir_rep)
            return
        for i in range(0, m, N_RAYS * 128):
            pts = slice(i, min(i + N_RAYS * 128, m))
            yield pts, fm.mlp_fwd_plain(mkw, xyz[pts], d, exact, dir_rep,
                                        p_base=p_base + i)

    def kernel(v=variant):
        return fm.mlp_fwd(mkw, xyz, d, exact, dir_rep, p_base, v)

    err_f = err_s = 0.0
    err_mma = None
    with full_fp32():
        feat, sigma = kernel()
        scale = max(1.0, sigma.max().item())
        for pts, (f_p, s_p) in plain():
            err_f = max(err_f, (feat[pts] - f_p).abs().max().item())
            err_s = max(err_s, (sigma[pts] - s_p).abs().max().item() / scale)
        if variant == "wgmma":
            f_m, s_m = kernel("mma")
            err_mma = ((feat - f_m).abs().max().item(),
                       (sigma - s_m).abs().max().item() / scale)
            del f_m, s_m
    tol = fm.KERNEL_TOL[dt]
    passed = (bool(torch.isfinite(feat).all() and torch.isfinite(sigma).all())
              and bool((sigma >= 0).all()) and err_f <= tol[0]
              and err_s <= tol[1]
              and (err_mma is None
                   or (err_mma[0] <= tol[0] and err_mma[1] <= tol[1])))
    mma_ms = None
    if variant == "wgmma":
        ms, mma_ms = turns_ms(kernel, lambda: kernel("mma"), device, reps=3)
    else:
        ms = time_ms(kernel)
    plain_ms = time_ms(lambda: drain(plain()), reps=3 if n == N_RAYS else 1)
    b_ms, b_by = mlp_fwd_bound(params, m, d.shape[0], c,
                               dt == torch.bfloat16)
    dt_name = str(dt)[6:]
    work = m * mlp_work(params, dir_rep)[0]
    vs_mma = ("" if err_mma is None else
              " vs mma.sync max|dfeat|={:.3e} max|dsigma|={:.3e};".format(
                  *err_mma))
    turns = ("" if mma_ms is None else
             f" in turns with mma.sync {mma_ms:.3f} ms "
             f"({work / mma_ms / 1e9:.0f} TFLOP/s, "
             f"{100 * b_ms / mma_ms:.0f}% of the bound),")
    print(f"[mlp-kernel] forward {variant} {n} x {s} = {n * s} points"
          f"{f' from {p_base}' if p_base else ''}, dir_rep {dir_rep} "
          f"{dt_name:8s} exact={exact!s:5s} max|dfeat|={err_f:.3e} "
          f"max|dsigma|={err_s:.3e} (of max(1, {scale:.2f})) tol={tol};"
          f"{vs_mma} kernel {ms:.3f} ms ({work / ms / 1e9:.0f} "
          f"TFLOP/s, {100 * b_ms / ms:.0f}% of the bound, "
          f"{m * (c + 1) * 4 / ms / 1e6:.1f} GB/s of stores),{turns} plain "
          f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
          f"{'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, dir_rep=dir_rep, variant=variant,
                p_base=p_base, err=max(err_f, err_s * scale),
                err_mma=err_mma, ms=ms, mma_ms=mma_ms, plain_ms=plain_ms,
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
# bf16. At fp32 the sums themselves are held to their error model
# (``slab_sum_z``, SLAB_SUM_SIGMAS), which replaced a bound of 1e-5 that
# the readings' spread crossed: 4.7e-6 to 1.6e-5 over 51 draws at 1024 x
# 128 (``tools/draw_spread slabs``).
MLP_SLABS_VS_ONE = {"bfloat16": 5e-4}


def mlp_backward_case(device, params, gen, n: int, s: int, dt, exact: bool,
                      variant: str = "mma", dir_rep: int = 0,
                      label: str = ""):
    """The fused-MLP backward's ``variant`` on n rays x s samples (a
    direction a ray, or with ``dir_rep`` 1 a direction a point) and random
    non-zero per-point cotangents: against the plain chain and weight
    gradient on its own recomputed stash (one shared forward: GRAD_TOL),
    against the plain backward from the inputs (GRAD_TOL_FROM_INPUTS; the
    plain versions run over slices, gradients summed in fp64), twice for
    the same bits, and at its own slab size against one slab (bf16
    MLP_SLABS_VS_ONE; fp32 the error model of ``slab_sum_z``). The wgmma
    variant is also held to the mma.sync one on the same inputs
    (GRAD_TOL_FROM_INPUTS: another forward), its one-slab stash rows to
    the wgmma stash forward's, whose features and sigma are the wgmma
    no-stash forward's (bit for bit both), and the two are timed in turns.
    -> record."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr
    from crnerf_tpu_torch.tools._common import turns_ms

    torch.cuda.empty_cache()     # the last case's blocks, for 2 M points
    c = 64
    dt_name = str(dt)[6:]
    rep = dir_rep or s
    mkw = fm.prepare_mlp_weights(params, 15, 4, dt)
    lay = fm.mlp_grad_layout(mkw.kw.dims)
    xyz, d, g_feat, g_sig = mlp_bwd_inputs(n, s, gen, device, c, rep)
    m = xyz.shape[0]
    slices = point_slices(m, rep)
    key = "fused_mlp_bwd" if variant == "wgmma" else "fused_mlp_bwd_mma"

    def kernel(slab_points=None, v=variant):
        return fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, exact, rep,
                          slab_points, variant=v)

    def zeros():
        return (torch.zeros(lay.wt, dtype=torch.float64, device=device),
                torch.zeros(lay.bt, dtype=torch.float64, device=device))

    def plain():
        gw, gb = zeros()
        for pts, dirs in slices:
            gw_s, gb_s, _ = fm.mlp_bwd_slabs_plain(
                mkw, xyz[pts], d[dirs], g_feat[pts], g_sig[pts], exact, rep,
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

    before = fm.LAUNCH_COUNTS[key]
    slab = fm.slab_points_for(mkw, m, device, variant=variant)
    rows_equal = z_slabs = None
    with full_fp32():
        gw_k, gb_k, _ = kernel()
        gw_2, gb_2, _ = kernel()
        repeat_bits = torch.equal(gw_k, gw_2) and torch.equal(gb_k, gb_2)
        del gw_2, gb_2
        gw_1, gb_1, (st, dz) = kernel(slab_points=m)   # every point's rows
        if variant == "wgmma":
            # the slab's stash rows are the stash forward's, whose outputs
            # are the no-stash forward's: the stores change nothing
            f0, s0 = fm.mlp_fwd(mkw, xyz, d, exact, rep, variant="wgmma")
            f1, s1, st_f = fm.mlp_fwd(mkw, xyz, d, exact, rep,
                                      variant="wgmma", stash=True)
            rows_equal = (torch.equal(st_f, st) and torch.equal(f0, f1)
                          and torch.equal(s0, s1))
            del f0, s0, f1, s1, st_f
        if dt == torch.float32:
            z_slabs = slab_sum_z(mkw, st, dz, gw_k, gb_k, gw_1, gb_1, m,
                                 slab, m, device)
        gw_o, gb_o = plain_on(st)
        del st, dz
        gw_p, gb_p = plain()
        got_mma = kernel(v="mma")[:2] if variant == "wgmma" else None
        torch.cuda.synchronize()
    counted = fm.LAUNCH_COUNTS[key] == before + 3

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
    vs_mma = None if got_mma is None else worst(grads(*got_mma), got)
    abs_err = max((gw_k - gw_p).abs().max().item(),
                  (gb_k - gb_p).abs().max().item())
    largest = max(gw_p.abs().max().item(), gb_p.abs().max().item())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    slabs_ok = (max(z_slabs) <= SLAB_SUM_SIGMAS if z_slabs is not None
                else vs_one <= MLP_SLABS_VS_ONE[dt_name])
    passed = (repeat_bits and finite and counted and slabs_ok
              and rows_equal is not False
              and rel <= fm.GRAD_TOL_FROM_INPUTS[dt]
              and rel_stash <= fm.GRAD_TOL[dt]
              and (vs_mma is None or vs_mma <= fm.GRAD_TOL_FROM_INPUTS[dt]))
    n_params = sum(t.numel() for t in fr.flatten_params(params))
    work = m * sum(mlp_work(params, rep))
    mma_ms = None
    if variant == "wgmma":
        ms, mma_ms = turns_ms(kernel, lambda: kernel(v="mma"), device,
                              reps=3)
    else:
        ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=3 if n == N_RAYS else 1)
    # the points, the directions and the per-point cotangents in, the
    # gradients out; the forward again, the chain and the weight gradient
    n_dirs = d.shape[0]
    b_ms, b_by = bound(work, (3 * m + 3 * n_dirs + m * (c + 1) + n_params)
                       * 4, dt == torch.bfloat16)
    slabs_line = (f"{vs_one:.3e} against one slab, the sums "
                  f"{z_slabs[0]:.2f} / {z_slabs[1]:.2f} standard deviations "
                  f"of their error model (weights / bias vector; bound "
                  f"{SLAB_SUM_SIGMAS})" if z_slabs is not None else
                  f"{vs_one:.3e} against one slab (bound "
                  f"{MLP_SLABS_VS_ONE[dt_name]})")
    extra = ""
    if variant == "wgmma":
        extra = (f" against the mma.sync backward on the same inputs "
                 f"{vs_mma:.3e} (bound {fm.GRAD_TOL_FROM_INPUTS[dt]}), its "
                 f"one-slab stash rows the wgmma forward's bits "
                 f"{rows_equal};")
    turns = ("" if mma_ms is None else
             f" in turns with mma.sync {mma_ms:.3f} ms "
             f"({work / mma_ms / 1e9:.0f} TFLOP/s, "
             f"{100 * b_ms / mma_ms:.0f}% of the bound),")
    print(f"[mlp-kernel] {label}backward {variant} {n} x {s} = {m} points, "
          f"dir_rep {rep} {dt_name:8s} exact={exact!s:5s} slabs of {slab} "
          f"points: grads max rel {rel_stash:.3e} against the plain backward "
          f"on the kernel's own stash (tol {fm.GRAD_TOL[dt]}), {rel:.3e} "
          f"against the plain version from the inputs (tol "
          f"{fm.GRAD_TOL_FROM_INPUTS[dt]}; max abs {abs_err:.3e}, the "
          f"largest gradient {largest:.3e}), {slabs_line},{extra} repeat "
          f"bits equal {repeat_bits}; kernel {ms:.3f} ms "
          f"({work / ms / 1e9:.0f} TFLOP/s, {100 * b_ms / ms:.0f}% of the "
          f"bound),{turns} plain {plain_ms:.3f} ms bound {b_ms:.3f} ms "
          f"({b_by}) {'ok' if passed else 'FAIL'}")
    return dict(N=n, S=s, dtype=dt_name, variant=variant, dir_rep=rep,
                ok=passed, err_grad=rel, err_on_stash=rel_stash,
                vs_one=vs_one, z_slabs=z_slabs, vs_mma=vs_mma, err=abs_err,
                ms=ms, mma_ms=mma_ms, plain_ms=plain_ms, bound=(b_ms, b_by),
                slab=slab, label=label)


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


def mlp_fwd_cases():
    """Phase 4d's forward cases (n, s, dtype, exact, dir_rep[, variant[,
    p_base]]), in drawing order."""
    import torch

    both = ((torch.bfloat16, False), (torch.float32, True))
    # the mma.sync variant: both dtypes, then route C's launches
    cases = [(N_RAYS, 128, dt, exact, rep)
             for dt, exact in both for rep in (128, 1)]
    cases += [(999, 77, torch.bfloat16, False, 77)]      # ragged
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, s)
              for s in (64, 128)]
    # the wgmma variant (bf16): both encodes, a direction per ray and per
    # point, a ragged run, points from p_base > 0 (inside a ray and a
    # tile), then the serve launches
    cases += [(N_RAYS, 128, torch.bfloat16, exact, rep, "wgmma")
              for exact in (False, True) for rep in (128, 1)]
    cases += [(999, 77, torch.bfloat16, False, rep, "wgmma")
              for rep in (77, 1)]
    cases += [(N_RAYS, 128, torch.bfloat16, False, rep, "wgmma", 1000)
              for rep in (128, 1)]
    cases += [(SERVE_TILE, s, torch.bfloat16, False, s, "wgmma")
              for s in (256, 512)]
    # ... and at route C's launches, its training forward since it takes
    # the backward's variant
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False, s, "wgmma")
              for s in (64, 128)]
    return cases


def mlp_bwd_cases():
    """Phase 4d's backward cases (n, s, dtype, exact), in drawing order."""
    import torch

    both = ((torch.bfloat16, False), (torch.float32, True))
    cases = [(N_RAYS, s, dt, exact) for s in (64, 128) for dt, exact in both]
    cases += [(TRAIN_GRIDS * 1024, s, torch.bfloat16, False)
              for s in (64, 128)]
    return cases


def mlp_bwd_wgmma_cases():
    """Phase 4d's wgmma backward cases (n, s, dtype, exact, variant,
    dir_rep), in drawing order."""
    import torch

    bf = torch.bfloat16
    cases = [(N_RAYS, 128, bf, exact, "wgmma", rep)
             for exact in (False, True) for rep in (0, 1)]
    cases += [(999, 77, bf, False, "wgmma", 0)]
    cases += [(TRAIN_GRIDS * 1024, s, bf, False, "wgmma", 0)
              for s in (64, 128)]
    return cases


def mlp_bwd_inputs(n: int, s: int, gen, device, c: int = 64,
                   dir_rep: int = 0):
    """Phase 4d's draws for one backward case: the points of n rays x s
    samples, a direction a ray (or with ``dir_rep`` 1 a point), the
    per-point cotangents."""
    import torch

    xyz, d = mlp_inputs(n, s, dir_rep or s, gen, device)
    m = xyz.shape[0]
    g_feat = torch.randn(m, c, generator=gen, device=device) * 0.1
    g_sig = torch.randn(m, generator=gen, device=device) * 0.1
    return xyz, d, g_feat, g_sig


# The fp32 backward at its own slab size against one slab: every gradient
# is a sum over the points in fp32, and the slab size changes how it is
# grouped. The weight gradients: chains of m_per points a split
# (``_wgrad_plan`` of the slab: 4 splits, so chains of 25,344 and 7,424
# points at the default slab of 1024 x 128, 32,768 in one slab), the splits
# in order, the slabs in order; the bias sums and the sigma weight
# gradient (the mma.sync chain): 64-row tile sums, a CTA's tiles in order
# (12 to 16 a CTA on 132 CTAs), the CTAs in order, the slabs in order.
# Error model, first order: each addition's result S carries a relative
# rounding error uniform in [-u, u], u = 2^-24, so a grouping's error has
# variance (u^2 / 3) sum S^2 over its additions, and E S^2 of a partial sum
# of j terms of mean mu and variance v (the element's, from the sums of t
# and t^2 over the points) is j v + j^2 mu^2; two groupings differ by
# independent errors, so their variances add. The bound: each element
# within SLAB_SUM_SIGMAS standard deviations of that model. The largest of
# ~6e5 independent Gaussian errors passes 6 with probability ~1e-3.
SLAB_SUM_SIGMAS = 6.0


def slab_sum_z(mkw, st, dz, gw_a, gb_a, gw_b, gb_b, m: int, slab_a: int,
               slab_b: int, device):
    """The fp32 gradients of two slab sizes against the error model above,
    on the stash and dz rows of every point (one slab's scratch) -> the
    largest |difference| over the model's standard deviation, over the
    weight gradients and over the bias vector (the bias sums, then the
    sigma weight gradient)."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm
    from crnerf_tpu_torch.ops import fused_render as fr

    kw = mkw.kw
    lay = fm.mlp_grad_layout(kw.dims)
    wp, n_layers = kw.dims["WP"], kw.dims["L"]
    a, d = st.double(), dz.double()
    # sum t and sum t^2 over the points of every element
    g = torch.empty(lay.wt, dtype=torch.float64, device=device)
    q = torch.empty_like(g)
    for _, a_col, k, b_col, n, off in lay.jobs:
        aa, dd = a[:, a_col:a_col + k], d[:, b_col:b_col + n]
        g[off:off + k * n] = (aa.T @ dd).reshape(-1)
        q[off:off + k * n] = ((aa * aa).T @ (dd * dd)).reshape(-1)
    h, dzs = a[:, (n_layers - 1) * wp:n_layers * wp], d[:, lay.d_sig:
                                                       lay.d_sig + 1]
    gb = torch.cat([d.sum(0), (h * dzs).sum(0)])
    qb = torch.cat([(d * d).sum(0), ((h * h) * (dzs * dzs)).sum(0)])

    def levels_var(levels, mu, v):
        """(u^2 / 3) sum E S^2 over nested chains: per level (chains,
        length, points a unit)."""
        out = torch.zeros_like(mu)
        for chains, length, unit in levels:
            j = torch.arange(1, length + 1, dtype=torch.float64) * unit
            out += chains * (float(j.sum()) * v
                             + float((j * j).sum()) * mu * mu)
        return out * (2.0 ** -24) ** 2 / 3

    def var(slab, weights):
        sums, sq = (g, q) if weights else (gb, qb)
        mu = sums / m
        v = (sq / m - mu * mu).clamp_min(0)
        slabs = [min(slab, m - p0) for p0 in range(0, m, slab)]
        levels = [(1, len(slabs), slab)]
        for n_s in slabs:
            if weights:
                _, splits, m_per, _ = fr._wgrad_plan(kw, n_s, device, lay)
                levels += [(n_s // m_per, m_per, 1),
                           (1, -(-n_s // m_per), m_per)]
                if n_s % m_per:
                    levels.append((1, n_s % m_per, 1))
            else:
                tiles = -(-n_s // 64)
                grid = min(tiles, fr._chain_grid(kw, n_s, device)[0])
                levels += [(tiles, 64, 1), (grid, -(-tiles // grid), 64),
                           (1, grid, 64 * -(-tiles // grid))]
        return levels_var(levels, mu, v)

    def worst(diff, sd):
        live = sd > 0
        return float((diff[live] / sd[live]).max()) if bool(live.any()) \
            else 0.0

    z_w = worst((gw_a.double() - gw_b.double()).abs(),
                (var(slab_a, True) + var(slab_b, True)).sqrt())
    z_b = worst((gb_a.double() - gb_b.double()).abs(),
                (var(slab_a, False) + var(slab_b, False)).sqrt())
    return z_w, z_b


# The backward's fp32 case at 1024 x 128 that read 1.014e-5 slabs against
# one slab: drawn when the forward's wgmma cases still drew from phase
# 4d's generator (seed + 6), after the first SLAB_EDGE_FWD forward cases
# (all there were then), the composite check and SLAB_EDGE_AFTER backward
# cases. ``slab_edge_draw`` replays those draws.
SLAB_EDGE_FWD, SLAB_EDGE_AFTER = 17, 3


def slab_edge_draw(device, seed: int):
    """A generator in the state the kept fp32 slab draw was made from."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed + 6)
    for case in mlp_fwd_cases()[:SLAB_EDGE_FWD]:
        mlp_inputs(case[0], case[1], case[4], gen, device)
    o, d, z, _ = ray_inputs(N_RAYS, 128, gen, device)   # composite check
    jittered_points(o, d, z, gen)
    for n, s, _, _ in mlp_bwd_cases()[:SLAB_EDGE_AFTER]:
        mlp_bwd_inputs(n, s, gen, device)
    return gen


@timed_phase
def phase_mlp_kernels(device, seed: int):
    """The fused-MLP pair against its plain versions. Returns (forward
    records, backward records)."""
    import torch

    from crnerf_tpu_torch.ops import fused_mlp as fm

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    # the wgmma cases draw from a generator of their own, so that the
    # mma.sync cases and the backward's draw what they drew before them
    gen_w = torch.Generator(device=device).manual_seed(seed + 10)
    before = dict(fm.LAUNCH_COUNTS)
    fwd = [mlp_forward_case(device, params,
                            gen_w if "wgmma" in case else gen, *case)
           for case in mlp_fwd_cases()]
    if any(fm.LAUNCH_COUNTS[k] <= before[k]
           for k in ("fused_mlp_fwd", "fused_mlp_fwd_mma")):
        raise PhaseError("a fused MLP forward counter did not rise")
    if not all(r["ok"] for r in fwd):
        raise PhaseError("the fused MLP forward disagrees with its plain "
                         "version")
    slower = [(r["S"], r["ms"], r["mma_ms"]) for r in fwd
              if r["variant"] == "wgmma" and r["N"] == SERVE_TILE
              and r["ms"] >= r["mma_ms"]]
    if slower:
        print(f"[mlp-kernel] the wgmma forward is not faster than mma.sync "
              f"at the serve launches (S, ms, mma.sync ms): {slower}")
    mlp_composite_check(device, params, gen)
    bwd = [mlp_backward_case(device, params, gen, *case)
           for case in mlp_bwd_cases()]
    # the wgmma variant (bf16), from the wgmma cases' generator: both
    # encodes and both direction forms, a ragged run, route C's launches
    bwd += [mlp_backward_case(device, params, gen_w, *case)
            for case in mlp_bwd_wgmma_cases()]
    # the fp32 draw that read 1.014e-5 slabs against one slab
    bwd.append(mlp_backward_case(device, params,
                                 slab_edge_draw(device, seed), N_RAYS, 128,
                                 torch.float32, True, label="kept draw: "))
    if not all(r["ok"] for r in bwd):
        raise PhaseError("the fused MLP backward disagrees with its plain "
                         "version")
    mlp_scratch_check(device, params, gen)
    return fwd, bwd


@timed_phase
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


@timed_phase
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
            blk, w1, _ = fr.render_fwd(kw, o, d, z, noise, True, False,
                                       variant="mma")
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


def _variant_taken(cv, fn, name: str):
    """-> (fn's result, the variant its launch counted under: "wgmma" for
    ``name``, "mma" for ``name`` + "_mma")."""
    import torch

    before = dict(cv.LAUNCH_COUNTS)
    got = fn()
    torch.cuda.synchronize()
    moved = {k for k, v in cv.LAUNCH_COUNTS.items() if v != before[k]}
    taken = ("wgmma" if moved == {name} else "mma"
             if moved == {name + "_mma"} else f"counters {sorted(moved)}")
    return got, taken


def _variant_ok(cv, c: int, co: int, taken: str) -> bool:
    """The variant the shape must take: conv_variant's, and the wgmma one
    at a main shape (C and Co multiples of 64)."""
    want = cv.conv_variant(c, co)
    return taken == want and bool(c % 64 or co % 64 or taken == "wgmma")


def conv3_case(device, gen, n, h, w, c, co):
    """The 3x3 forward and weight-gradient kernels at one shape against
    their plain versions, the gradient twice; the variant each took (from
    the launch counters); kernel and cuDNN timed in turns; -> (fwd record,
    dw record)."""
    import torch

    from crnerf_tpu_torch.ops import conv as cv
    from crnerf_tpu_torch.tools._common import turns_ms
    from crnerf_tpu_torch.tools.spike_conv3x3 import library_dw, library_fwd

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()

    xpad, kernel, dy = normal(n, h + 2, w + 2, c), normal(3, 3, c, co), \
        normal(n, h, w, co)
    m, tag = n * h * w, f"{n} x {h} x {w}, {c} -> {co}"
    flops = 2.0 * 9 * m * c * co
    in_bytes = 2 * xpad.numel()
    cases = {  # kernel, plain version, cuDNN, bytes both sides read, output
        # elements (the kernel writes them at 4 bytes, cuDNN at 2)
        "fwd": (lambda: cv.conv3x3_valid_fwd(xpad, kernel),
                lambda: cv.conv_valid_plain(xpad, kernel),
                library_fwd(xpad, kernel),
                in_bytes + 2 * kernel.numel(), m * co),
        "dw": (lambda: cv.conv3x3_dw(xpad, dy),
               lambda: cv.conv3x3_dw_plain(xpad, dy),
               library_dw(xpad, dy, kernel.shape),
               in_bytes + 2 * dy.numel(), 9 * c * co),
    }
    recs = []
    for kind, (kern, plain, lib, reads, outs) in cases.items():
        got, taken = _variant_taken(
            cv, kern, "conv3x3_fwd" if kind == "fwd" else "conv3x3_dw")
        with full_fp32():
            want = plain()
        abs_err, rel = _errs(got, want)
        same_bits = torch.equal(got, kern()) if kind == "dw" else True
        ok = (rel <= cv.KERNEL_TOL_F32 and same_bits
              and _variant_ok(cv, c, co, taken)
              and bool(torch.isfinite(got).all()))
        del got, want
        # 20 calls a reading, in turns with cuDNN: its ~0.1 ms calls are
        # near the host's launch rate and moved 1.6x between calls
        ms, library_ms = turns_ms(kern, lib, device, 20)
        with full_fp32():
            plain_ms = time_ms(plain, reps=3)
        b_ms, b_by = bound(flops, reads + 4 * outs)
        lib_b_ms, lib_b_by = bound(flops, reads + 2 * outs)
        bits = ("" if kind == "fwd" else ", twice: the same bits"
                if same_bits else ", twice: OTHER BITS")
        print(f"[conv] 3x3 {kind} {tag} ({taken}): max|err| {abs_err:.3e} = "
              f"{rel:.3e} of the largest (bound {cv.KERNEL_TOL_F32:.0e})"
              f"{bits}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * b_ms / ms:.0f}% of its bound {b_ms:.4f} ms, {b_by}), "
              f"cuDNN {library_ms:.4f} ms ({100 * lib_b_ms / library_ms:.0f}%"
              f" of its bound {lib_b_ms:.4f} ms, {lib_b_by}, bf16 out), "
              f"plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        recs.append(dict(kind=kind, shape=(n, h, w, c, co), err=abs_err,
                         rel=rel, variant=taken,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound=(b_ms, b_by), ok=ok))
    return recs


def packed_case(device, shape, f):
    """The packed conv at one level against its plain version and, after
    _d2s, against the 3x3 kernel on the reflect-padded original; the
    variant it took; kernel and cuDNN timed in turns."""
    import torch

    from crnerf_tpu_torch.ops import conv as cv
    from crnerf_tpu_torch.tools._common import turns_ms
    from crnerf_tpu_torch.tools.spike_conv3x3 import library_fwd
    from crnerf_tpu_torch.tools.spike_packed_conv import (
        level_inputs,
        packed_operands,
    )

    b, h, w, c = shape
    x, k3 = level_inputs(shape, f, device)
    xp_pad, k2 = packed_operands(x, k3)
    got, taken = _variant_taken(cv, lambda: cv.packed_conv(xp_pad, k2),
                                "packed_conv")
    with full_fp32():
        want = cv.conv_valid_plain(xp_pad, k2, torch.bfloat16)
    abs_err, rel = _errs(got, want)
    # the tie to S1: the packed output is the 3x3 sums rounded to bf16
    tie = _errs(cv._d2s(got), cv.conv3x3_valid_fwd(
        cv.reflect_pad(x, 1).contiguous(), k3))[1]
    tie_tol = 2.0 ** -8 + cv.KERNEL_TOL_F32
    ok = (rel <= cv.KERNEL_TOL_BF16 and tie <= tie_tol
          and _variant_ok(cv, 4 * c, 4 * f, taken)
          and bool(torch.isfinite(got.float()).all()))
    del got, want
    ms, library_ms = turns_ms(lambda: cv.packed_conv(xp_pad, k2),
                              library_fwd(xp_pad, k2), device, 20)
    with full_fp32():
        plain_ms = time_ms(
            lambda: cv.conv_valid_plain(xp_pad, k2, torch.bfloat16), reps=3)
    i, j = h // 2, w // 2
    flops = 2.0 * 4 * b * i * j * (4 * c) * (4 * f)
    nbytes = 2 * (xp_pad.numel() + k2.numel() + b * i * j * 4 * f)
    b_ms, b_by = bound(flops, nbytes)
    print(f"[conv] packed {b} x {h} x {w}, {c} -> {f} (4C = {4 * c}, "
          f"{taken}): max|err| {abs_err:.3e} = {rel:.3e} of the largest "
          f"(bound {cv.KERNEL_TOL_BF16:.2e}); _d2s of it against the 3x3 "
          f"kernel {tie:.3e} (bound {tie_tol:.2e}); kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.0f}% of the "
          f"bound {b_ms:.4f} ms, {b_by}), cuDNN {library_ms:.4f} ms "
          f"({100 * b_ms / library_ms:.0f}%, the same bound: bf16 out on "
          f"both), plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    return dict(shape=(b, h, w, c, f), err=abs_err, rel=rel, variant=taken,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound=(b_ms, b_by), ok=ok)


def sincos_cases(device):
    """The accurate variant against float64 at the spike's five scales,
    the fast one's error printed; the kernel and torch.sin + torch.cos
    timed in turns as a caller sees them (host-paced: medians of 6
    readings of 20 calls), and each one's device time (a CUDA graph of 20
    calls replayed) beside the bound; -> records."""
    import numpy as np
    import torch

    from crnerf_tpu_torch.ops import sincos as sc
    from crnerf_tpu_torch.tools._common import graph_ms, turns_ms
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
        ms, library_ms = turns_ms(lambda: sc.sincos(x),
                                  lambda: (torch.sin(x), torch.cos(x)),
                                  device)
        plain_ms = time_ms(lambda: sc.sincos_plain(x), reps=20)
        dev_ms = graph_ms(lambda: sc.sincos(x), device)
        lib_dev_ms = graph_ms(lambda: (torch.sin(x), torch.cos(x)), device)
        b_ms, b_by = bound(0.0, 3 * 4 * x.numel())  # x read, s and c written
        ok = e64 <= sc.F64_TOL
        print(f"[sincos] |x| <= {scale:g} rad: against float64 {e64:.3e} "
              f"(bound {sc.F64_TOL:.3e}), the fast intrinsics {fast64:.3e}; "
              f"against torch.sin / cos {err:.3e}; a call, in turns: kernel "
              f"{ms:.4f} ms, torch.sin + torch.cos {library_ms:.4f} ms "
              f"({'no slower' if ms <= library_ms else 'SLOWER'}); device "
              f"time: kernel {dev_ms:.5f} ms, torch.sin + torch.cos "
              f"{lib_dev_ms:.5f} ms; plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}) {'ok' if ok else 'FAIL'}")
        recs.append(dict(scale=scale, err=err, e64=e64, fast64=fast64, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms,
                         bound=(b_ms, b_by), ok=ok))
    return recs


# the spike tools as a user runs them: the conv3x3 spike at its own shape
# and at the train step's batch, the packed spike, the sincos spike
SPIKE_RUNS = (("spike_conv3x3", []),
              ("spike_conv3x3", ["--n", str(TRAIN_GRIDS)]),
              ("spike_packed_conv", []), ("spike_kernel_sincos", []))


@timed_phase
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
                         "version, the gradient changed its bits, or a "
                         "shape took another variant than its own")
    torch.cuda.synchronize()
    zero_counts()
    for tool, argv in SPIKE_RUNS:
        mod = importlib.import_module(f"crnerf_tpu_torch.tools.{tool}")
        if mod.main(argv) != 0:
            raise PhaseError(f"{tool} {' '.join(argv)} failed")
    torch.cuda.synchronize()
    launches = read_counts()
    # the tools run main shapes only: the wgmma variants, no "_mma" launch
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
# the interleave tool at the spike's widths (the ping-pong S2), then at a
# width only the mma.sync S2 takes
SPIKE_RUNS_4F = (("spike_interleave", []),
                 ("spike_interleave", ["--width", "128", "--rays", "1024"]),
                 ("spike_sublane_stores", []))


def pipe_case(device, params, gen, n: int, s: int, turns: bool = True):
    """S2 at n rays x s samples, bf16, recurrence, every P, against K1 of
    S2's own variant on the same inputs (the same bits; else
    KERNEL_TOL[bf16]) and, on N_RAYS rays, against pipe_render_plain; at
    the served widths the ping-pong kernel, timed in turns with the wgmma
    K1 (medians of 6 readings) -> records."""
    import torch

    from crnerf_tpu_torch.ops import fused_render as fr
    from crnerf_tpu_torch.ops import pipe_render as pr
    from crnerf_tpu_torch.tools._common import turns_ms

    dt = torch.bfloat16
    o, d, z, noise = ray_inputs(n, s, gen, device)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    c = kw.dims["C"]
    variant = pr.pipe_variant(kw.dims)

    def k1():
        return fr.render_fwd(kw, o, d, z, noise, False, False,
                             variant=variant)

    blk1, w1, _ = k1()

    def errs(blk, w, blk_r, w_r):
        return ((w - w_r).abs().max().item(),
                (blk[:, :c] - blk_r[:, :c]).abs().max().item(),
                (blk[:, c] - blk_r[:, c]).abs().max().item())

    tol = fr.KERNEL_TOL[dt]
    f_fwd, _, _ = mlp_work(params, s)
    b_ms, b_by = bound(n * s * f_fwd, n * (8 + 2 * s + 27 + 128 + s) * 4)
    plain_ms = time_ms(lambda: drain(
        pr.pipe_render_plain(params, o[sl], d[sl], z[sl], noise[sl], 15, 4,
                             dt, False) for sl in ray_slices(n)),
        reps=3 if n == N_RAYS else 1)
    recs = []
    occ = (pr.pipe_render_occupancy(kw, device) if variant == "mma"
           else 1)
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

        def s2():
            return pr.pipe_render_apply(kw, o, d, z, noise, False, p)

        if turns:
            ms, k1_ms = turns_ms(s2, k1, device, reps=3)
        else:
            ms, k1_ms = time_ms(s2), time_ms(k1)
        vs_plain = ("" if err_plain is None else
                    " vs plain max|dw|={:.3e} max|dfmap|={:.3e} "
                    "max|ddepth|={:.3e} (tol {}),".format(*err_plain, tol))
        print(f"[pipe] S2 ({variant}) P={p} {n} rays x S={s} bf16, "
              f"{kw.dims['WP']} wide: vs K1 ({variant}) "
              f"{'the same bits' if same else 'OTHER BITS, max err %s' % (err_k1,)},"
              f"{vs_plain} kernel {ms:.3f} ms "
              f"({n * s * f_fwd / ms / 1e9:.0f} TFLOP/s, "
              f"{100 * b_ms / ms:.0f}% of the bound), K1 {k1_ms:.3f} ms"
              f"{' in turns' if turns else ''}, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}), {occ} CTA(s) an SM "
              f"{'ok' if ok else 'FAIL'}")
        recs.append(dict(N=n, S=s, P=p, variant=variant, same_bits=same,
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


@timed_phase
def phase_spikes_4f(device, seed: int):
    """Phase 4f. -> (S2 records, S5 records, launches of the two tools'
    run)."""
    import importlib

    import torch

    params = full_width_params(seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    pipe = [r for n, s in PIPE_SHAPES
            for r in pipe_case(device, params, gen, n, s)]
    # the mma.sync S2 at a width the ping-pong kernel does not take
    pipe += pipe_case(device, full_width_params(seed, device, 6, 128, 32),
                      gen, N_RAYS, 256, turns=False)
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
    # the interleave tool also launches K1 of each variant as its yardstick
    new = ("pipe_render_fwd", "pipe_render_fwd_mma", "sublane_stores")
    if not (all(launches[k] > 0 for k in new)
            and not any(v for k, v in launches.items()
                        if k not in new + ("fused_render_fwd",
                                           "fused_render_fwd_mma"))):
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


# Phase 9: the CLI's train, resume and eval on a phototourism cache. Three
# train images of 512x384 (cut from 6) and two test images of 384x512 (a
# second resolution for eval), appearance 224x160: 0.59 M rays, 36 steps
# an epoch at 16 grids of 1024 rays, past CLI_PREEMPT_AFTER and
# RANGER_PREEMPT_AFTER.
CLI_TRAIN, CLI_TRAIN_WH, CLI_TEST_WH = 3, (512, 384), (384, 512)
CLI_EPOCHS = 1             # phases 9 and 11 (cut from 2)
CLI_BATCH = 1024            # rays a grid (Config.batch_size)
CLI_PREEMPT_AFTER = 20      # SIGTERM once metrics.jsonl shows this step
# A training step gives the same bits from run to run on the card (the
# reflect pad's and the bilinear resize's backwards fold in a fixed order,
# ``models/common.py``), so the resumed run must end on the straight run's
# bits: every parameter, buffer, Adam moment, cache row and validity flag.


@contextlib.contextmanager
def user_flags():
    """PyTorch's own defaults for the flags earlier phases set (TF32 in
    cuDNN allowed, not in matmuls; cuDNN free to choose), as a user's
    process and the CLI's subprocesses have them; restored after."""
    import torch

    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = True, False
    b.cudnn.deterministic, b.cudnn.benchmark = False, False
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


def cli_scene(root: str, empty_root: str):
    """The phase's phototourism caches, written by the port's
    save_scene_cache: the scene under ``root``, and under ``empty_root`` a
    small one with no test image (an empty ``test_test`` split)."""
    import dataclasses

    from crnerf_tpu_torch.data.phototourism import save_scene_cache
    from crnerf_tpu_torch.data.scene import Scene
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene

    app = (224, 160)
    train = make_synthetic_scene(n_train=CLI_TRAIN, n_test=0,
                                 img_wh=CLI_TRAIN_WH,
                                 appearance_wh=app, seed=SEED).images
    test = [dataclasses.replace(im, id=len(train) + i,
                                name=f"test_{i:03d}.png")
            for i, im in enumerate(make_synthetic_scene(
                n_train=0, n_test=2, img_wh=CLI_TEST_WH, appearance_wh=app,
                seed=SEED + 1).images)]
    scene = Scene("cli", train + test, appearance_wh=app)
    save_scene_cache(scene, root_dir=root, img_downscale=2)
    save_scene_cache(make_synthetic_scene(n_train=1, n_test=0,
                                          appearance_wh=app, seed=SEED),
                     root_dir=empty_root, img_downscale=2)
    return scene


def cli_args(root: str, save_dir: str, exp: str, num_devices: int = 1):
    """The flagship config as a user passes it to ``train`` / ``eval``, on
    ``num_devices`` ranks (phases 9 and 10 ask for one, also where more
    cards are visible; 0 under a launcher means its ranks)."""
    return ["--dataset_name", "phototourism", "--root_dir", root,
            "--scene_name", "cli", "--compute_dtype", "bfloat16",
            "--grids_per_step", str(TRAIN_GRIDS), "--save_dir", save_dir,
            "--exp_name", exp, "--num_devices", str(num_devices)]


def metric_rows(save_dir: str, exp: str):
    path = os.path.join(save_dir, "logs", exp, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def ckpt_tensors(save_dir: str, exp: str, step: int):
    """A full checkpoint's parameters, buffers, Adam moments and steps,
    cache and validity mask, by name, on the host."""
    import torch

    path = os.path.join(save_dir, "ckpts", exp, f"{step}.pt")
    if not os.path.exists(path):
        raise PhaseError(f"no full checkpoint {path}")
    ck = torch.load(path, map_location="cpu", weights_only=False)
    out = {f"system.{k}": v for k, v in ck["system"].items()}
    for i, st in ck["optimizer"]["state"].items():
        for k, v in st.items():
            out[f"adam.{i}.{k}"] = torch.as_tensor(v)
    out["embedding_cache"] = ck["embedding_cache"]
    out["embedding_valid"] = ck["embedding_valid"]
    return out, ck


def ckpt_distance(a, b):
    """The largest absolute difference over every tensor of two
    checkpoints, and the tensor where it is."""
    if a.keys() != b.keys():
        raise PhaseError("the two checkpoints hold other tensors")
    return max((float((a[k].double() - b[k].double()).abs().max())
                if a[k].numel() else 0.0, k) for k in a)


def cli_straight(args, save_dir: str, exp: str, steps: int, n_val: int,
                 epochs: int = CLI_EPOCHS):
    """The train CLI in this process for ``epochs`` epochs, launch counters
    zeroed just before and read just after. -> (launches, stdout, metrics
    rows, peak GiB, seconds)."""
    import io

    import torch

    from crnerf_tpu_torch.apps import train as train_app

    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_app.main(args + ["--num_epochs", str(epochs),
                                       "--log_every", "5"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    text = out.getvalue()
    print("\n".join(f"[cli] {exp}: {line}" for line in text.splitlines()))
    if state.step != steps:
        raise PhaseError(f"{exp}: the run ended at step {state.step}, "
                         f"expected {steps}")
    # two passes a step on the stash route's wgmma kernels, and K1 in the
    # validations (one an epoch in fit, one after it): two passes a tile
    want = {k: 0 for k in launches}
    for k in ROUTES["stash"][1]:
        want[k] = 2 * steps
    want["fused_render_fwd"] = n_val
    if launches != want:
        raise PhaseError(f"{exp}: launch counters {launches}, expected "
                         f"{want}")
    rows = metric_rows(save_dir, exp)
    if not any("train/loss" in r for r in rows):
        raise PhaseError(f"{exp}: metrics.jsonl has no train rows")
    for name in (f"{steps}.pt", "weights.npz"):
        if not os.path.exists(os.path.join(save_dir, "ckpts", exp, name)):
            raise PhaseError(f"{exp}: no {name} after the run")
    return launches, text, rows, peak, secs


def epoch_rates(rps) -> str:
    """Each epoch's steps/s and train rays/s (a step trains TRAIN_GRIDS
    grids of CLI_BATCH rays, over all ranks), epoch 0 with the first
    launches."""
    return "; ".join(
        f"epoch {i}: {x / (CLI_BATCH * TRAIN_GRIDS):.2f} steps/s, {x:.0f} "
        f"train rays/s" for i, x in enumerate(rps)) + (
        " (epoch 0 with the process's first launches)")


def final_val(text: str, who: str):
    import re

    m = re.search(r"final val: psnr=(\S+) ssim=(\S+)", text)
    if not m:
        raise PhaseError(f"{who}: no final val line:\n{text[-4000:]}")
    val = float(m.group(1)), float(m.group(2))
    if not all(map(lambda x: x == x and abs(x) != float("inf"), val)):
        raise PhaseError(f"{who}: final val not finite: {val}")
    return val


def spawn(argv, log_path: str, env, prog=("-m", "crnerf_tpu_torch")):
    """``python -m crnerf_tpu_torch`` (or ``python`` with ``prog``) with
    ``argv``, output to ``log_path``; ``finish`` or ``finish_ranks`` waits
    for it."""
    f = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, *prog, *argv], cwd=REPO,
                            stdout=f, stderr=subprocess.STDOUT, env=env)
    return proc, f, log_path


def finish(job, timeout: float = 600):
    """-> (exit code, output) of a ``spawn``ed run."""
    proc, f, log_path = job
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        f.close()
    with open(log_path) as g:
        return rc, g.read()


def finish_ranks(jobs, timeout: float = 600, when=None):
    """``finish`` for the ``spawn``ed ranks of one group -> [(exit code,
    output)]. Once a rank exits non-zero, or after ``timeout`` s, the others
    are killed, so that none waits in a collective. ``when``: (a test, an
    action), the action taken once, the first time the test holds."""
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            rcs = [proc.poll() for proc, _, _ in jobs]
            if all(rc == 0 for rc in rcs) or any(rc for rc in rcs):
                break
            if when is not None and when[0]():
                when[1]()
                when = None
            time.sleep(0.1)
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
    return [finish(job, 60) for job in jobs]


def preempt_and_resume(tag: str, train_argv, exp: str, save: str,
                       after: int, ipe: int, env, log, with_stop=None,
                       with_resume=None):
    """Spawn ``train_argv(exp)``, SIGTERM it once its metrics.jsonl shows
    step ``after``, then spawn it again with ``--auto_resume``. The jobs
    of ``with_stop`` ({tag: (argv, env)}) start beside the run to stop,
    those of ``with_resume`` beside the resume. Fails unless the stop
    checkpointed in epoch 0 at ``after`` or later and the resume exits 0.
    -> {tag: (exit code, output)} of every job, "preempt" and "resume"
    included."""
    import re
    import signal

    jobs, out = {}, {}
    try:
        for t, (argv, e) in (with_stop or {}).items():
            jobs[t] = spawn(argv, log(t), e)
        pre = jobs["preempt"] = spawn(train_argv(exp), log("preempt"), env)
        deadline = time.time() + 300
        while not any(r["step"] >= after for r in metric_rows(save, exp)):
            if pre[0].poll() is not None or time.time() > deadline:
                raise PhaseError(
                    f"{tag} the run to preempt ended or stalled before step "
                    f"{after}:\n{finish(pre, 60)[1][-4000:]}")
            time.sleep(0.2)
        pre[0].send_signal(signal.SIGTERM)
        out["preempt"] = finish(jobs.pop("preempt"), 300)
        jobs["resume"] = spawn(train_argv(exp) + ["--auto_resume"],
                               log("resume"), env)
        for t, (argv, e) in (with_resume or {}).items():
            jobs[t] = spawn(argv, log(t), e)
        for t in list(jobs):
            out[t] = finish(jobs.pop(t))
    finally:
        for proc, f, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    rc, text = out["preempt"]
    m = re.search(r"preempted: checkpointed at step (\d+)", text)
    if rc != 0 or not m:
        raise PhaseError(f"{tag} SIGTERM: exit {rc}, output:\n"
                         f"{text[-4000:]}")
    at = int(m.group(1))
    if not after <= at < ipe:
        raise PhaseError(f"{tag} preempted at step {at}, not in epoch 0 "
                         f"after {after}")
    print(f"{tag} SIGTERM once step {after} was logged: exit 0, "
          f"'preempted: checkpointed at step {at}'")
    if out["resume"][0] != 0:
        raise PhaseError(f"{tag} resume: exit {out['resume'][0]}:\n"
                         f"{out['resume'][1][-4000:]}")
    return out


def resumed_bits(tag: str, save: str, straight_exp: str, resumed_exp: str,
                 steps: int, val, rval):
    """The resumed run's last checkpoint against the straight run's: every
    tensor the same bits, the same step, the same final validation ->
    the straight run's tensors by name."""
    import torch

    straight = ckpt_tensors(save, straight_exp, steps)[0]
    resumed, ck = ckpt_tensors(save, resumed_exp, steps)
    dist, where = ckpt_distance(resumed, straight)
    same = all(torch.equal(resumed[k], straight[k]) for k in straight)
    print(f"{tag} the resumed run's last checkpoint against the straight "
          f"run's, {len(straight)} tensors: "
          f"{'the same bits' if same else 'OTHER BITS'} (largest "
          f"difference {dist:.3e}, {where}); final val {rval} against "
          f"{val}")
    if not (same and ck["step"] == steps and rval == val):
        raise PhaseError(f"{tag} the resumed run does not end on the "
                         f"straight run's bits")
    return straight


@timed_phase
def phase_cli(device, workdir: str, card: str):
    """Phase 9: train straight in this process; a preempted run and its
    resume in subprocesses, to the straight run's bits; evaluate in a
    subprocess; refuse without a card. -> (the straight run's launch
    counts, the scene, its epochs' steps/s and its peak GiB)."""
    import re

    import numpy as np
    import torch

    from crnerf_tpu_torch.apps import add_device_arg
    from crnerf_tpu_torch.apps.serve import load_system
    from crnerf_tpu_torch.config import build_parser, config_from_args
    from crnerf_tpu_torch.render.inference import Renderer

    root = os.path.join(workdir, "scene")
    empty_root = os.path.join(workdir, "empty")
    save = os.path.join(workdir, "runs")
    t0 = time.perf_counter()
    scene = cli_scene(root, empty_root)
    n_rays = sum(w * h for w, h in (im.wh for im in scene.train_images))
    ipe = n_rays // CLI_BATCH // TRAIN_GRIDS
    steps = CLI_EPOCHS * ipe
    vw, vh = scene.train_images[0].wh
    # val_chunk tiles, two passes, in a validation an epoch and the final
    n_val = (CLI_EPOCHS + 1) * 2 * -(-vw * vh // 2048)
    print(f"[cli] cache: {len(scene.train_images)} train images "
          f"{CLI_TRAIN_WH}, {len(scene.test_images)} test {CLI_TEST_WH}, "
          f"{n_rays} rays, {ipe} steps an epoch "
          f"({time.perf_counter() - t0:.1f} s)")

    with user_flags():
        launches, text, rows, peak, secs = cli_straight(
            cli_args(root, save, "straight"), save, "straight", steps,
            n_val)
    val = final_val(text, "straight")
    rps = [r["train/rays_per_sec"] for r in rows if "train/rays_per_sec" in r]
    vals = [(round(r["val/psnr"], 3), round(r["val/ssim"], 4))
            for r in rows if "val/psnr" in r]
    print(f"[cli] straight: {steps} steps in {secs:.1f} s with the "
          f"validations and checkpoints; {epoch_rates(rps)}; peak memory "
          f"{peak:.2f} GiB; validation psnr/ssim {vals}, final {val} "
          f"({card})")
    print(f"[cli] straight: launches {launches}: every stash forward, "
          f"chain and weight gradient on wgmma, none on mma.sync")
    stats = dict(steps_per_s_epoch0=rps[0] / (CLI_BATCH * TRAIN_GRIDS),
                 peak=peak)

    # the subprocesses below need the card's memory: a training run of
    # ~27 GiB beside the evals; give back what this process's allocator
    # keeps
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() / 2 ** 30
    print(f"[cli] this process keeps {kept:.2f} GiB of the card for the "
          f"subprocesses")
    env = dict(os.environ, PYTHONPATH=REPO)
    nocard = dict(env, CUDA_VISIBLE_DEVICES="")

    def train_argv(exp):
        return ["train", *cli_args(root, save, exp), "--num_epochs",
                str(CLI_EPOCHS), "--log_every", "5"]

    ckpt_dir = os.path.join(save, "ckpts", "straight")
    eval_argv = ["eval", *cli_args(root, save, "straight"), "--ckpt_path",
                 ckpt_dir]

    def log(tag):
        return os.path.join(workdir, tag.replace(" ", "_") + ".log")

    # meanwhile: the val split, an empty split, and the apps with no card
    # to be seen (each with the default device and --device cuda)
    # and the straight run's test_test split (the val split's PNG goes to
    # a directory of its own, not over it)
    beside = {"eval val": (eval_argv + ["--split", "val", "--save_dir",
                                        os.path.join(workdir, "eval_val")],
                           env),
              "eval empty": (eval_argv + ["--split", "test_test",
                                          "--root_dir", empty_root], env),
              "eval": (eval_argv + ["--split", "test_test"], env)}
    for cmd in ("prepare", "train", "eval"):
        for dev in ([], ["--device", "cuda"]):
            beside[f"{cmd} {' '.join(dev) or '(default device)'}"] = (
                [cmd, "--root_dir", root, *dev], nocard)
    out = preempt_and_resume("[cli]", train_argv, "resumed", save,
                             CLI_PREEMPT_AFTER, ipe, env, log,
                             with_resume=beside)
    rval = final_val(out["resume"][1], "resumed")
    resumed_bits("[cli]", save, "straight", "resumed", steps, val, rval)

    for tag, want in (("eval val", "rendered 1 images"),
                      ("eval empty", "rendered 0 images")):
        if out[tag][0] != 0 or want not in out[tag][1]:
            raise PhaseError(f"{tag}: exit {out[tag][0]}:\n{out[tag][1]}")
    print("[cli] eval val: 1 PNG; an empty test_test split: 0 frames, "
          "exit 0")
    refusals = [t for t in out if "device" in t]
    for tag in refusals:
        if out[tag][0] == 0 or "no CUDA device" not in out[tag][1]:
            raise PhaseError(f"{tag} without a card: exit {out[tag][0]}\n"
                             f"{out[tag][1]}")
    print(f"[cli] without a card: {', '.join(refusals)}: exit codes "
          f"{sorted({out[t][0] for t in refusals})}, 'no CUDA device'")

    # the straight run's evaluation: its PNGs against an in-process render
    # of the same weights.npz
    rc, text = out["eval"]
    m = re.search(r"median (\S+) / p95 (\S+) s/frame", text)
    if rc != 0 or not m:
        raise PhaseError(f"eval: exit {rc}:\n{text[-4000:]}")
    parser = build_parser()
    add_device_arg(parser)
    cfg = config_from_args(parser.parse_args(eval_argv[1:]))
    out_dir = os.path.join(save, "results", "phototourism", "cli")
    with user_flags():
        renderer = Renderer(cfg, load_system(cfg, ckpt_dir, device))

        def frame(im):
            w, h = im.wh
            return renderer.fetch(renderer.render_frame_cam_async(
                im.c2w, im.K, im.near, im.far, (h, w),
                im.appearance[None].astype(np.float32),
                outputs="rgb_u8"))["rgb_u8"]

        for i, im in enumerate(scene.test_images):
            with open(os.path.join(out_dir, f"{i:03d}.png"), "rb") as f:
                got = decode_png_rgb8(f.read())
            want = frame(im)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise PhaseError(f"eval PNG {i} ({im.wh}) differs from the "
                                 "in-process render")
        t1 = time.perf_counter()
        for im in scene.test_images:
            frame(im)
        warm = (time.perf_counter() - t1) / len(scene.test_images)
    print(f"[cli] eval test_test: {len(scene.test_images)} PNGs of "
          f"{CLI_TEST_WH}, the in-process render's bits; the app's median "
          f"{m.group(1)} / p95 {m.group(2)} s a frame (2 frames, the first "
          f"with the process's first launches, beside the resumed run); "
          f"warm in process "
          f"{warm:.3f} s a frame, fetch included ({card})")
    return launches, scene, stats


# Phase 10: the apps that need an image codec, on phase 9's checkpoint and
# scene at the flagship config. Camera paths at the demo's 320x240 and 256 +
# 256 samples, bf16; 12 frames a path (cut from 24; the presets have 240);
# a Blender scene of 4 train and 2 test RGBA frames of 800x800, trained at
# 400x400 for one epoch (640,000 rays, 39 steps of 16 grids of 1024 rays).
APP_WH = (320, 240)
APP_DTYPE = "bfloat16"
APP_FRAMES = 12
APP_SERVE_FRAMES = 8
APP_PATH_SCENE = "cli_brandenburg_gate"
BLENDER_SRC_WH, BLENDER_WH = (800, 800), (400, 400)
BLENDER_TRAIN, BLENDER_TEST = 4, 2
BLENDER_PANEL_EVERY = 10
BLENDER_PROFILE = (10, 15)


def gif_blocks(data: bytes):
    """The GIF89a's loop count and the (w, h) of each image descriptor,
    read block by block (stdlib only)."""
    if data[:6] != b"GIF89a":
        raise PhaseError("not a GIF89a")
    pos, loop, sizes = 13, None, []
    if data[10] & 0x80:                       # a global colour table
        pos += 3 << ((data[10] & 7) + 1)

    def skip_subblocks(p):
        while data[p]:
            p += 1 + data[p]
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:                 # an extension
            if data[pos + 1] == 0xFF and data[pos + 3:pos + 14] == \
                    b"NETSCAPE2.0":
                loop = int.from_bytes(data[pos + 16:pos + 18], "little")
            pos = skip_subblocks(pos + 2)
        elif data[pos] == 0x2C:               # an image descriptor
            w, h = (int.from_bytes(data[pos + i:pos + i + 2], "little")
                    for i in (5, 7))
            sizes.append((w, h))
            flags, pos = data[pos + 9], pos + 10
            if flags & 0x80:                  # a local colour table
                pos += 3 << ((flags & 7) + 1)
            pos = skip_subblocks(pos + 1)     # after the LZW code size
        else:
            raise PhaseError(f"GIF: unknown block {data[pos]:#x} at {pos}")
    return loop, sizes


def check_video(out_dir: str, base: str, n: int, wh, tag: str):
    """n PNGs NNN.png of wh and ``base``.gif of n frames of wh, looping;
    -> the PNG frames."""
    from crnerf_tpu_torch.utils.png import read_png

    frames = [read_png(os.path.join(out_dir, f"{i:03d}.png"))
              for i in range(n)]
    if any(f.shape != (wh[1], wh[0], 3) for f in frames):
        raise PhaseError(f"{tag}: PNG shapes {[f.shape for f in frames]}")
    if os.path.exists(os.path.join(out_dir, f"{n:03d}.png")):
        raise PhaseError(f"{tag}: more than {n} PNGs")
    with open(os.path.join(out_dir, base + ".gif"), "rb") as f:
        loop, sizes = gif_blocks(f.read())
    if loop != 0 or sizes != [tuple(wh)] * n:
        raise PhaseError(f"{tag}: GIF loop {loop}, image descriptors "
                         f"{sizes[:3]}... ({len(sizes)})")
    return frames


def expect_launches(tag: str, launches, want):
    """Every kernel's count as ``want`` says, 0 where it says nothing."""
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise PhaseError(f"{tag}: launch counters "
                         f"{ {k: v for k, v in launches.items() if v} }, "
                         f"expected { {k: v for k, v in want.items() if v} }")


def app_launches(tag: str, launches, want_k1: int):
    """The frames of a path: a coarse and a fine launch of the wgmma K1 a
    tile, nothing else."""
    expect_launches(tag, launches, {"fused_render_fwd": want_k1})


def run_app(main, argv, tag: str):
    """An app's ``main`` in this process, as ``python -m crnerf_tpu_torch``
    calls it, the launch counters zeroed just before and read just after.
    -> (its return value, its output, launches, seconds)."""
    import io

    import torch

    out = io.StringIO()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    text = out.getvalue()
    print("\n".join(f"[apps] {tag}: {line}" for line in text.splitlines()))
    return ret, text, launches, secs


def segments(text: str, tag: str):
    import re

    m = re.search(r"median (\S+) / p95 (\S+) s/frame", text)
    if not m:
        raise PhaseError(f"{tag}: no median / p95 line:\n{text[-2000:]}")
    return float(m.group(1)), float(m.group(2))


def blender_scene(root: str, card: str):
    """4 train and 2 test RGBA frames of 800x800, PNGs whose rows are
    filtered with None, Sub, Up, Average and Paeth in turn, written with
    zlib; each decoded back (the bits written), its decode time printed."""
    import numpy as np

    from crnerf_tpu_torch.tools.codec_times import (
        filtered_png_bytes,
        frame_rgba,
    )
    from crnerf_tpu_torch.utils.png import read_png

    w, h = BLENDER_SRC_WH
    times = []
    for split, n in (("train", BLENDER_TRAIN), ("test", BLENDER_TEST)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for t in range(n):
            name = f"{split}/r_{t}"
            img = frame_rgba(h, w, 100 * (split == "test") + t)
            path = os.path.join(root, name + ".png")
            with open(path, "wb") as f:
                f.write(filtered_png_bytes(img, np.arange(h) % 5))
            t0 = time.perf_counter()
            got = read_png(path, "RGBA")
            times.append(time.perf_counter() - t0)
            if not np.array_equal(got, img):
                raise PhaseError(f"read_png({name}) is not the frame written")
            pose = np.eye(4)
            pose[:3, 3] = (0.4 * t - 0.6, 0.1 * t, 4.0)
            frames.append({"file_path": name,
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    print(f"[apps] blender: {BLENDER_TRAIN} train and {BLENDER_TEST} test "
          f"RGBA PNGs of {w}x{h}, rows filtered 0-4, decoded to the bits "
          f"written: read_png {np.median(times):.4f} s a file (median; max "
          f"{max(times):.4f}) on this host ({os.cpu_count()} CPUs; {card})")


@timed_phase
def phase_apps(device, workdir: str, card: str, scene):
    """Phase 10: eval's camera path, the video app, metrics, serve's
    render_path and a Blender scene trained, evaluated and scored, on phase
    9's checkpoint and scene. -> the wgmma kernels' launches over its
    counted runs (each zeroed just before and read just after)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from crnerf_tpu_torch.apps import eval as eval_app
    from crnerf_tpu_torch.apps import eval_metric, video
    from crnerf_tpu_torch.apps import train as train_app
    from crnerf_tpu_torch.apps.serve import (
        RenderService,
        load_style,
        load_system,
    )
    from crnerf_tpu_torch.config import Config, build_parser, config_from_args
    from crnerf_tpu_torch.render import camera_path
    from crnerf_tpu_torch.render.inference import Renderer
    from crnerf_tpu_torch.tools.codec_times import (
        filtered_png_bytes,
        frame_rgba,
    )
    from crnerf_tpu_torch.train.metrics import mse, psnr, ssim
    from crnerf_tpu_torch.utils.png import read_png

    root = os.path.join(workdir, "scene")
    save = os.path.join(workdir, "runs")
    ckpt = os.path.join(save, "ckpts", "straight")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    w, h = APP_WH
    tiles = -(-w * h // Config.chunk)    # 8192-ray tiles of a frame

    def check_frame(cfg, got, c2w, near, far, style, tag):
        renderer = Renderer(cfg, load_system(cfg, ckpt, device))
        want = renderer.fetch(renderer.render_frame_cam_async(
            c2w, camera_path.fov_intrinsics(APP_WH), near, far, (h, w),
            style, outputs="rgb_u8"))["rgb_u8"]
        if not np.array_equal(got, want):
            raise PhaseError(f"{tag}: the frame is not the in-process "
                             "Renderer's")

    # (a) eval's camera path
    path_argv = [*cli_args(root, save, "straight"), "--split", "test",
                 "--scene_name", APP_PATH_SCENE, "--img_wh", str(w), str(h),
                 "--N_samples", "256", "--N_importance", "256",
                 "--num_frames", str(APP_FRAMES), "--ckpt_path", ckpt]
    with user_flags():
        out_dir, text, launches, secs = run_app(eval_app.main, path_argv,
                                                "eval test")
    p50, p95 = segments(text, "eval test")
    app_launches("eval test", launches, 2 * tiles * APP_FRAMES)
    add(launches)
    frames = check_video(out_dir, APP_PATH_SCENE, APP_FRAMES, APP_WH,
                         "eval test")
    cfg = config_from_args(build_parser().parse_args(path_argv))
    spec = dataclasses.replace(camera_path.PATH_PRESETS["brandenburg_gate"],
                               n_frames=APP_FRAMES)
    style, anchor = eval_app.path_anchors(scene, spec)
    k = APP_FRAMES // 2
    with user_flags():
        check_frame(cfg, frames[k], spec.poses(anchor.c2w)[k], anchor.near,
                    anchor.far, style.appearance[None].astype(np.float32),
                    "eval test")
    print(f"[apps] eval test: {APP_FRAMES} PNGs and a GIF of {APP_FRAMES} "
          f"frames of {w}x{h} (256+256, {APP_DTYPE}) in {secs:.1f} s; frame "
          f"{k} the in-process Renderer's bits; per frame p50 {p50:.3f} / p95 "
          f"{p95:.3f} s (segments between PNG completions, the first "
          f"frame's launches included; {card}); {launches['fused_render_fwd']}"
          f" wgmma K1 launches, none on mma.sync")

    # (b) the video app, two seeded style PNGs
    style_dir = os.path.join(workdir, "styles")
    os.makedirs(style_dir)
    for i in range(2):
        img = frame_rgba(300 + 37 * i, 400 + 21 * i, 50 + i)[..., :3].copy()
        with open(os.path.join(style_dir, f"style{i}.png"), "wb") as f:
            f.write(filtered_png_bytes(img, np.arange(img.shape[0]) % 5))
    vargv = ["--ckpt_path", ckpt, "--scene_name", APP_PATH_SCENE,
             "--style_dir", style_dir, "--save_dir", save, "--img_wh",
             str(w), str(h), "--n_frames", str(APP_FRAMES),
             "--compute_dtype", APP_DTYPE, "--num_devices", "1"]
    with user_flags():
        outs, text, launches, secs = run_app(video.main, vargv, "video")
    app_launches("video", launches, 2 * 2 * tiles * APP_FRAMES)
    add(launches)
    vcfg = Config(N_samples=256, N_importance=256, compute_dtype=APP_DTYPE,
                  use_mask=False, encode_random=False)
    anchor_c2w = camera_path.DEMO_ANCHORS["brandenburg_gate"]
    for i, o in enumerate(outs):
        frames = check_video(o, f"style{i}", APP_FRAMES, APP_WH, "video")
        with user_flags():
            check_frame(vcfg, frames[k], spec.poses(anchor_c2w)[k], 0.0, 5.0,
                        load_style(os.path.join(style_dir, f"style{i}.png"),
                                   vcfg.appearance_wh), "video")
    vp50 = [segments(line, "video") for line in text.splitlines()
            if "frames ->" in line]
    print(f"[apps] video: 2 styles x {APP_FRAMES} PNGs and a GIF each in "
          f"{secs:.1f} s; frame {k} of each the in-process Renderer's bits; "
          f"per frame p50 / p95 {vp50} s ({card}); "
          f"{launches['fused_render_fwd']} wgmma K1 launches")

    # (c) metrics on phase 9's test_test renders, against train/metrics.py
    margv = ["--root_dir", root, "--dataset_name", "phototourism",
             "--scene_name", "cli", "--save_dir", save, "--img_downscale",
             "2"]
    mean, text, _, _ = run_app(eval_metric.main, margv, "metrics")
    rows = []
    render_dir = os.path.join(save, "results", "phototourism", "cli")
    for i, im in enumerate(scene.test_images):
        iw, ih = im.wh
        pred, gt = (torch.as_tensor(np.ascontiguousarray(a[:, iw // 2:]),
                                    device=device) for a in (
            read_png(os.path.join(render_dir, f"{i:03d}.png")).astype(
                np.float32) / 255.0, im.rgbs.reshape(ih, iw, 3)))
        rows.append({"psnr": float(psnr(pred, gt)),
                     "ssim": float(ssim(pred, gt)),
                     "mse": float(mse(pred, gt))})
    want = {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
    if mean != want:
        raise PhaseError(f"metrics {mean} is not train/metrics.py's {want}")
    missing = os.path.join(workdir, "missing")
    shutil.copytree(render_dir, os.path.join(missing, "results",
                                             "phototourism", "cli"))
    os.remove(os.path.join(missing, "results", "phototourism", "cli",
                           "001.png"))
    env = dict(os.environ, PYTHONPATH=REPO)
    job = spawn(["metrics", *margv[:-4], "--save_dir", missing,
                 "--img_downscale", "2"],
                os.path.join(workdir, "metrics_missing.log"), env)
    print(f"[apps] metrics: {mean}, train/metrics.py's on the same arrays "
          f"(right halves of {len(rows)} renders)")

    # (d) serve's render_path, a PNG style registered by encode_style
    scfg = serve_config(APP_DTYPE, use_mask=False)
    with user_flags():
        svc = RenderService(scfg, load_system(scfg, ckpt, device))
        r = svc.handle({"op": "encode_style", "id": "s",
                        "image_path": os.path.join(style_dir,
                                                   "style0.png")})
        if not r["ok"]:
            raise PhaseError(f"encode_style: {r}")
        sdir = os.path.join(workdir, "served_path")
        torch.cuda.synchronize()
        zero_counts()
        r = svc.handle({"op": "render_path", "scene": APP_PATH_SCENE,
                        "n_frames": APP_SERVE_FRAMES, "wh": [w, h],
                        "style_id": "s", "out_dir": sdir})
        launches = read_counts()
    if not (r["ok"] and r["frames"] == APP_SERVE_FRAMES
            and r["gif"] == os.path.join(sdir, "brandenburg_gate.gif")):
        raise PhaseError(f"render_path: {r}")
    app_launches("render_path", launches, 2 * tiles * APP_SERVE_FRAMES)
    add(launches)
    check_video(sdir, "brandenburg_gate", APP_SERVE_FRAMES, APP_WH,
                "render_path")
    stats = svc.handle({"op": "stats"})
    print(f"[apps] render_path: {APP_SERVE_FRAMES} frames in "
          f"{r['ms_total']} ms, render p50 {stats['p50_ms']:.1f} ms "
          f"({card}); {launches['fused_render_fwd']} wgmma K1 launches")
    del svc
    rc, text = finish(job)
    if rc == 0 or "expected" not in text:
        raise PhaseError(f"metrics with a render missing: exit {rc}:\n"
                         f"{text[-2000:]}")
    print(f"[apps] metrics with a render missing: exit {rc}, 'expected "
          f"{len(scene.test_images)} renders'")

    # (e) a Blender scene: train with the perturbations, panels and a
    # profiler window, then evaluate and score
    broot = os.path.join(workdir, "lego")
    blender_scene(broot, card)
    bsave = os.path.join(workdir, "blender_runs")
    bw, bh = BLENDER_WH
    bargs = ["--dataset_name", "blender", "--root_dir", broot, "--img_wh",
             str(bw), str(bh), "--compute_dtype", APP_DTYPE,
             "--batch_size", str(CLI_BATCH), "--grids_per_step",
             str(TRAIN_GRIDS), "--save_dir", bsave,
             "--exp_name", "blender", "--scene_name", "lego",
             "--num_devices", "1"]
    steps = BLENDER_TRAIN * bw * bh // CLI_BATCH // TRAIN_GRIDS
    panels = steps // BLENDER_PANEL_EVERY
    once = bargs + ["--data_perturb", "color", "occ", "--num_epochs", "1",
                    "--log_every", "5"]
    targv = once + ["--img_panel_every", str(BLENDER_PANEL_EVERY),
                    "--profile", "--profile_steps", *map(str, BLENDER_PROFILE)]
    with user_flags():
        torch.cuda.reset_peak_memory_stats()
        state, text, launches, secs = run_app(train_app.main, targv,
                                              "blender train")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if state.step != steps:
        raise PhaseError(f"blender: ended at step {state.step}, expected "
                         f"{steps}")
    val = final_val(text, "blender")
    # the stash pair twice a step (and the panels' no-grad forwards); K1 in
    # the two validations (fit's last epoch, the app's final one)
    want = {key: 2 * steps for key in ROUTES["stash"][1]}
    want["fused_render_fwd_stash"] += 2 * panels
    want["fused_render_fwd"] = 2 * 2 * -(-bw * bh // Config.val_chunk)
    expect_launches("blender train", launches, want)
    add(launches)
    rows = metric_rows(bsave, "blender")
    rps = [row["train/rays_per_sec"] for row in rows
           if "train/rays_per_sec" in row]
    images = os.listdir(os.path.join(bsave, "logs", "blender", "images"))
    for s in range(BLENDER_PANEL_EVERY, steps + 1, BLENDER_PANEL_EVERY):
        for name in ("gt", "pred", "pred_random", "mask"):
            if f"train_{name}_{s:08d}.png" not in images:
                raise PhaseError(f"blender: no {name} panel at step {s}")
    trace = os.path.join(bsave, "traces", "blender",
                         "steps_{}_{}.trace.json".format(*BLENDER_PROFILE))
    if not os.path.getsize(trace):
        raise PhaseError("blender: the profiler's trace is empty")
    print(f"[apps] blender train: {steps} steps of {TRAIN_GRIDS} x "
          f"{CLI_BATCH} rays at {bw}x{bh}, color + occ, in {secs:.1f} s with "
          f"the scene's load, 2 validations and the checkpoint; epoch 0: "
          f"{rps[0] / (CLI_BATCH * TRAIN_GRIDS):.2f} steps/s, {rps[0]:.0f} "
          f"train rays/s; peak memory {peak:.2f} GiB; final val {val}; "
          f"{panels} panel sets; trace {os.path.getsize(trace) / 2 ** 20:.1f}"
          f" MiB ({card})")
    print(f"[apps] blender train: launches "
          f"{ {key: v for key, v in launches.items() if v} }: the stash "
          f"pair on wgmma, 2 a step (+2 a panel set for the stash forward), "
          f"none on mma.sync")
    # the same run without panels and profiler: the same bits (a step's
    # bits do not change from run to run on the card, phase 9), and its
    # epoch's rate beside the first's
    with user_flags():
        _, text, launches, secs = run_app(
            train_app.main, once + ["--exp_name", "plain",
                                    "--img_panel_every", "0"],
            "blender plain")
    expect_launches("blender plain", launches,
                    dict(want, fused_render_fwd_stash=2 * steps))
    add(launches)
    a, ck = ckpt_tensors(bsave, "blender", steps)
    b = ckpt_tensors(bsave, "plain", steps)[0]
    dist, where = ckpt_distance(a, b)
    if not all(torch.equal(a[key], b[key]) for key in a):
        raise PhaseError(f"blender: the run with panels and the profiler "
                         f"ends {dist:.3e} from the plain run ({where})")
    prps = [row["train/rays_per_sec"] for row in metric_rows(bsave, "plain")
            if "train/rays_per_sec" in row]
    print(f"[apps] blender plain: the same run without panels and the "
          f"profiler, {secs:.1f} s: the same bits over {len(a)} tensors of "
          f"the last checkpoint; epoch 0: "
          f"{prps[0] / (CLI_BATCH * TRAIN_GRIDS):.2f} steps/s, "
          f"{prps[0]:.0f} train rays/s against "
          f"{rps[0] / (CLI_BATCH * TRAIN_GRIDS):.2f} with them ({card})")
    bckpt = os.path.join(bsave, "ckpts", "blender")
    rc, text = finish(spawn(["eval", *bargs, "--split", "test_test",
                             "--ckpt_path", bckpt],
                            os.path.join(workdir, "blender_eval.log"), env))
    if rc != 0 or f"rendered {BLENDER_TEST} images" not in text:
        raise PhaseError(f"blender eval: exit {rc}:\n{text[-4000:]}")
    rc, text = finish(spawn(["metrics", "--root_dir", broot,
                             "--dataset_name", "blender", "--scene_name",
                             "lego", "--save_dir", bsave, "--img_wh",
                             str(bw), str(bh)],
                            os.path.join(workdir, "blender_metrics.log"),
                            env))
    import re

    m = re.search(r"lego n=2 psnr=(\S+) ssim=(\S+) mse=(\S+)", text)
    if rc != 0 or not m or not all(np.isfinite(float(x))
                                   for x in m.groups()):
        raise PhaseError(f"blender metrics: exit {rc}:\n{text[-4000:]}")
    print(f"[apps] blender eval test_test and metrics in subprocesses: "
          f"{m.group(0)}")
    return total


# Phase 11: data parallelism on the card, on phase 9's phototourism cache at
# the flagship config (8x256, 64 + 64, bf16, the stash route). (a) one rank
# over NCCL against no group, 12 steps (``--testit``: a step an epoch); (b)
# two ranks of 8 grids on the one card over gloo (NCCL refuses two ranks on
# one device), with CUDA tensors: one step against one process of 16 grids
# on the same global batch and draws, the train app for CLI_EPOCHS epochs
# timed, SIGTERM to rank 1 alone and the resume, and eval on two ranks; (c)
# where two cards are visible, the same over NCCL, and ``--num_devices 2``.
DP_RANKS = 2
DP_GRIDS = TRAIN_GRIDS // DP_RANKS
DP_A_STEPS = 12
# Adam's first moment after one step is 0.1 g: per leaf, the largest
# difference between a rank's and the 16-grid process's as a share of the
# single process's largest entry. Read at 6.6e-3 on an H100 (CGNet's
# leaves; PERF.md), so the bound leaves 4.5x. A sum over the ranks instead
# of the mean, or one rank's gradient alone, reads ~0.5-1. The cause is
# CGNet's own fp32 arithmetic, not the bf16 upstream: on the 16-grid
# step's own input and mask cotangent, in one process, 16 images at once
# against 8 + 8 gives the same 6.612e-3 (level3_0.F_loc; cuDNN's
# convolution backward by batch size; 5e-6 on the CPU), and the one pass is
# itself 5.0e-3 off float64. That is no fault of the port: CGNet's fp32
# gradient jumps where a PReLU input crosses zero, and the JAX package's
# own fp32 gradient is off float64 by as much (``cgnet_split_gap`` below,
# gated by CGNET_SHARE_BOUND; ROADMAP §3, settled).
DP_MU_SHARE = 3e-2
# The JAX package's fp32 CGNet gradient against float64 at 224x160, the
# median over four draws of the worst leaf's largest difference over the
# leaf's largest (tests/test_torch_cgnet_f64.py, JAX_FP32_F64_SHARE: draws
# from 6.0e-3 to 3.8e-2; the port's median there 4.1e-3). Phase 11 holds
# the card's split gap and its one pass against float64 to twice it
# (CGNET_SHARE_SLACK there), which stays below the 3.7e-2 of the JAX
# step's own fp32 gradient at 64x48 (tests/test_torch_train_step.py).
JAX_FP32_F64_SHARE = 1.628e-2
CGNET_SHARE_BOUND = 2.0 * JAX_FP32_F64_SHARE


def dp_release():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def dp_env(**kw):
    """Environment variables set for the block, restored after."""
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_state_tensors(state):
    """Every number a step reads, on the host, by name: parameters,
    buffers, Adam's state, the cache, its validity, the generator."""
    import torch

    out = {f"system.{k}": v.detach().cpu().clone()
           for k, v in state.system.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"adam.{i}.{k}"] = torch.as_tensor(v).cpu().clone()
    out["embedding_cache"] = state.embedding_cache.cpu().clone()
    out["embedding_valid"] = state.embedding_valid.cpu().clone()
    if state.generator is not None:
        out["generator"] = state.generator.get_state().clone()
    return out


def dp_same(a, b, what: str):
    import torch

    if a.keys() != b.keys():
        raise PhaseError(f"{what}: other tensors")
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    if diff:
        dist_, where = ckpt_distance({k: a[k] for k in diff},
                                     {k: b[k] for k in diff})
        raise PhaseError(f"{what}: {len(diff)} of {len(a)} tensors differ "
                         f"(largest {dist_:.3e}, {where})")


def dp_cli_argv(root: str, save: str, exp: str, steps_log: int = 5):
    return [*cli_args(root, save, exp, 0), "--grids_per_step", str(DP_GRIDS),
            "--num_epochs", str(CLI_EPOCHS), "--log_every", str(steps_log)]


def seeded_draws(cfg, grids: int, seed: int):
    """Seeded draws for ``grids`` grids of ``cfg``: the renderer's
    uniforms, noise and resampling exponentials (the cache is empty, so the
    rows chosen do not matter)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n, s, i = cfg.batch_size, cfg.N_samples, cfg.N_importance
    return {
        "z_u": torch.rand((grids, n, s), generator=g),
        "noise_coarse": cfg.noise_std * torch.randn((grids, n, s),
                                                    generator=g),
        "noise_fine": cfg.noise_std * torch.randn((grids, n, s + i),
                                                  generator=g),
        "pdf_e": torch.empty((grids, n, i + 1)).exponential_(generator=g),
        "sel_idx": torch.zeros((grids,), dtype=torch.int64),
    }


def dp_step_inputs(trainer, seed: int):
    """Step 0's global batch of TRAIN_GRIDS grids and seeded draws for
    it."""
    import torch

    batch = trainer.pipeline.make_global_batch(0, 0, TRAIN_GRIDS)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k != "image_idx"}
    return batch, seeded_draws(trainer.cfg, TRAIN_GRIDS, seed)


def spawn_ranks(job_path: str, n: int, worker: str, devices: bool,
                log_prefix: str, tag: str, timeout: float = 600,
                when=None):
    """``n`` ranks of ``chip_smoke.<worker>(job_path)``, each started as
    ``torchrun`` starts one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) on a store that this process hosts as torchrun's agent
    does (``mesh.host_store``), all on cuda:0 or (``devices``) rank r on
    cuda:r, output to ``log_prefix``<r>.log; waits for them as
    ``finish_ranks`` does (``when``'s action is given the jobs) and fails
    unless every rank exits 0. -> [output]."""
    from crnerf_tpu_torch.parallel import mesh

    store = mesh.host_store()   # held here until the ranks have exited
    jobs = [spawn([job_path], f"{log_prefix}{r}.log",
                  dict(os.environ, PYTHONPATH=REPO, **mesh.rank_env(
                      store, r, n, r if devices else 0)),
                  prog=("-c", f"import sys, chip_smoke; "
                              f"chip_smoke.{worker}(sys.argv[1])"))
            for r in range(n)]
    if when is not None:
        test, act = when
        when = (test, lambda: act(jobs))
    outs = finish_ranks(jobs, timeout, when)
    bad = [r for r, (rc, _) in enumerate(outs) if rc != 0]
    if bad:
        raise PhaseError(f"({tag}) exit codes {[rc for rc, _ in outs]}:\n"
                         + "\n".join(f"rank {r}:\n{outs[r][1][-3000:]}"
                                     for r in bad))
    return [text for _, text in outs]


def dp_one_step(trainer, batch, draws, device):
    """One step of ``trainer`` on ``batch`` and ``draws`` -> the state's
    tensors and Adam's first moment (0.1 g) by parameter."""
    import torch

    dev = {k: v.to(device) for k, v in batch.items()}
    dd = {k: v.to(device) for k, v in draws.items()}
    state, _ = trainer.step_fn(trainer.state, dev, dd)
    torch.cuda.synchronize(device)
    out = dp_state_tensors(state)
    mu = [state.optimizer.state[p]["exp_avg"].cpu().clone()
          for p in state.system.parameters()]
    return out, mu


def dp_rank_worker(job_path: str):
    """One rank of phase 11 (b) or (c), started as ``torchrun`` starts one
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), over the
    job's backend. In turn: its share of the one-step comparison; the train
    app's per-rank ``run`` for CLI_EPOCHS epochs, timed, the launch
    counters zeroed just before and read just after; the run that the
    parent stops by SIGTERM to rank 1, and its ``--auto_resume``; the eval
    app's ``run``. Writes what it measured beside ``job_path``."""
    import torch

    from crnerf_tpu_torch.apps import eval as eval_app
    from crnerf_tpu_torch.apps import load_scene_from_config
    from crnerf_tpu_torch.apps import train as train_app
    from crnerf_tpu_torch.config import build_parser, config_from_args
    from crnerf_tpu_torch.parallel import mesh
    from crnerf_tpu_torch.train.loop import Trainer

    with open(job_path) as f:
        job = json.load(f)
    device, group = mesh.init_distributed("cuda", job["backend"])
    r = mesh.rank(group)
    cfg = {k: config_from_args(build_parser().parse_args(job[k]))
           for k in ("timed", "stop", "resume", "eval")}
    out, secs = {}, {}
    with user_flags():
        t0 = time.perf_counter()
        inputs = torch.load(job["step_inputs"], weights_only=False)
        tr = Trainer(cfg["timed"], load_scene_from_config(cfg["timed"]),
                     device=device, group=group)
        g = cfg["timed"].grids_per_step
        sl = slice(r * g, (r + 1) * g)
        tensors, mu = dp_one_step(
            tr, {k: v[sl] for k, v in inputs["batch"].items()},
            {k: v[sl] for k, v in inputs["draws"].items()}, device)
        torch.save({"tensors": tensors, "mu": mu}, job_path + f".step{r}")
        del tr, tensors, mu
        dp_release()
        secs["one step"] = time.perf_counter() - t0

        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        mesh.barrier(group)
        zero_counts()
        t0 = time.perf_counter()
        out["step"] = train_app.run(cfg["timed"], device, group).step
        torch.cuda.synchronize(device)
        secs["timed"] = time.perf_counter() - t0
        out["launches"] = read_counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        dp_release()

        t0 = time.perf_counter()
        out["stopped_at"] = train_app.run(cfg["stop"], device, group).step
        ck_dir = os.path.join(cfg["stop"].save_dir, "ckpts",
                              cfg["stop"].exp_name)
        out["ckpts_at_stop"] = sorted(x for x in os.listdir(ck_dir)
                                      if x.endswith(".pt"))
        dp_release()
        out["resumed_to"] = train_app.run(cfg["resume"], device, group).step
        dp_release()
        secs["stop and resume"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_app.run(cfg["eval"], device, group)
        secs["eval"] = time.perf_counter() - t0
    out["secs"] = secs
    with open(job_path + f".rank{r}", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def cgnet_capture(system):
    """A copy of the system's CGNet as it is now, and a hook on CGNet that
    keeps its inputs and their masks' cotangents in the next step, chunk by
    chunk -> (copy, kept, hook)."""
    import copy

    net = copy.deepcopy(system.implicit_mask)
    kept = {"x": [], "cot": []}

    def capture(_, inputs, out):
        kept["x"].append(inputs[0].detach().clone())
        out.register_hook(lambda g: kept["cot"].append(g.detach().clone()))

    return net, kept, system.implicit_mask.register_forward_hook(capture)


def cgnet_split_gap(net, kept, parts: int):
    """CGNet's parameter gradients (``net``, training mode: statistics per
    image) on the ``kept`` inputs and cotangents: all images in one pass
    against the sum of ``parts`` passes over slices of them, and the one
    pass at fp32 against float64 -> {"split": (largest difference over the
    leaf's largest, leaf), "f64": (the same, leaf)}."""
    import torch

    x, cot = torch.cat(kept["x"], 0), torch.cat(kept["cot"], 0)

    def grads(m, x, cot):
        m.train()
        m.zero_grad(set_to_none=True)
        (m(x) * cot).sum().backward()
        for norm in m.norms():
            norm.pending = None
        return {k: p.grad.detach().double().clone()
                for k, p in m.named_parameters()}

    def worst(a, b):
        return max((float((a[k] - b[k]).abs().max())
                    / max(float(b[k].abs().max()), 1e-30), k) for k in b)

    whole = grads(net, x, cot)
    n = x.shape[0] // parts
    sliced = [grads(net, x[i * n:(i + 1) * n], cot[i * n:(i + 1) * n])
              for i in range(parts)]
    summed = {k: sum(s[k] for s in sliced) for k in whole}
    f64 = grads(net.double(), x.double(), cot.double())
    return {"split": worst(summed, whole), "f64": worst(whole, f64)}


def dp_deltas_bound(single_mu, rank_tensors, single_tensors, lr: float,
                    names):
    """tests/test_torch_train_step.py's bound on one step's parameters:
    every element's update within 2 lr of the other's, and where the
    gradient exceeds 1e-5 within 2% of lr. -> (worst over all elements in
    lr, worst over the large-gradient elements in lr)."""
    worst_all = worst_big = 0.0
    for name, mu in zip(names, single_mu):
        a = rank_tensors[f"system.{name}"].double()
        b = single_tensors[f"system.{name}"].double()
        d = (a - b).abs() / lr
        worst_all = max(worst_all, float(d.max()))
        big = (mu.double() / 0.1).abs() > 1e-5
        if big.any():
            worst_big = max(worst_big, float(d[big].max()))
    return worst_all, worst_big


def dp_mu_shares(rank_mu, single_mu, names):
    """Per leaf, max |a - b| over max |b| of Adam's first moments (``b``
    the single process's) -> [(share, leaf)], largest first."""
    out = []
    for name, a, b in zip(names, rank_mu, single_mu):
        a, b = a.double(), b.double()
        top = float(b.abs().max())
        d = float((a - b).abs().max())
        out.append((d / top if top else (0.0 if d == 0 else float("inf")),
                    name))
    return sorted(out, reverse=True)


@timed_phase
def phase_dp(device, workdir: str, card: str):
    """Phase 11 on phase 9's cache (``workdir``/scene) and checkpoint. ->
    the launch counts of (b)'s timed two-rank run, both ranks' together."""
    import torch

    from crnerf_tpu_torch.config import build_parser, config_from_args
    from crnerf_tpu_torch.data.phototourism import load_phototourism
    from crnerf_tpu_torch.parallel import mesh
    from crnerf_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "scene")
    save = os.path.join(workdir, "runs")
    dp_dir = os.path.join(workdir, "dp")
    os.makedirs(dp_dir, exist_ok=True)
    scene = load_phototourism(root, img_downscale=2,
                              appearance_wh=(224, 160))
    parse = build_parser()
    parse.add_argument("--device")

    def cfg_of(argv):
        return config_from_args(parse.parse_args(argv))

    # (a) one rank over NCCL, 12 steps
    a_cfg = cfg_of(cli_args(root, dp_dir, "a")).replace(
        testit=True, num_epochs=DP_A_STEPS, val_every_epochs=0,
        ckpt_every_epochs=DP_A_STEPS)
    with user_flags():
        tr = Trainer(a_cfg.replace(exp_name="a_alone"), scene, device=device)
        tr.fit()
        alone = dp_state_tensors(tr.state)
        del tr
        dp_release()
        store = mesh.host_store()
        with dp_env(**mesh.rank_env(store, 0, 1, device.index)):
            dev1, group = mesh.init_distributed(device, "nccl")
            try:
                tr = Trainer(a_cfg.replace(exp_name="a_group"), scene,
                             device=dev1, group=group)
                tr.fit()
                grouped = dp_state_tensors(tr.state)
                a_steps = tr.state.step
                del tr
            finally:
                torch.distributed.destroy_process_group()
        dp_release()
    if a_steps != DP_A_STEPS:
        raise PhaseError(f"(a): {a_steps} steps, expected {DP_A_STEPS}")
    dp_same(grouped, alone, "(a) one rank over nccl")
    print(f"[dp] (a) one rank over nccl (on a TCP store this process "
          f"hosts), the "
          f"Trainer for {DP_A_STEPS} steps: the same bits as without a "
          f"group over {len(alone)} tensors (parameters, buffers, Adam, the "
          f"cache, its validity, the generator); both runs in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # the one-step comparison's single process: 16 grids on cuda:0
    t0 = time.perf_counter()
    with user_flags():
        tr = Trainer(cfg_of(dp_cli_argv(root, save, "dp2")).replace(
            grids_per_step=TRAIN_GRIDS), scene, device=device)
        batch, draws = dp_step_inputs(tr, SEED + 11)
        net, kept, hook = cgnet_capture(tr.system)
        single = dp_one_step(tr, batch, draws, device)
        hook.remove()
        names = [n for n, _ in tr.system.named_parameters()]
        lr = tr.state.optimizer.param_groups[0]["lr"]   # step 0's
        del tr
        gap = cgnet_split_gap(net, kept, DP_RANKS)
        del net, kept
        dp_release()
    print(f"[dp] CGNet's gradient on the {TRAIN_GRIDS}-grid step's own "
          f"input and mask cotangent, in one process: all images at once "
          f"against the sum of {DP_RANKS} slices of {DP_GRIDS}, "
          f"{gap['split'][0]:.3e} of the leaf's largest ({gap['split'][1]}); "
          f"the one-pass fp32 gradient against float64 on the same "
          f"cotangent {gap['f64'][0]:.3e} ({gap['f64'][1]}); bound "
          f"{CGNET_SHARE_BOUND:.3e} (twice the JAX package's own fp32 "
          f"distance from float64, {JAX_FP32_F64_SHARE:.3e}). DP_MU_SHARE "
          f"reads the two ranks' first moments against the 16-grid "
          f"process's, each rank's cotangent from its own forward ({card})")
    for what, (share, leaf) in (("the split sum", gap["split"]),
                                ("the one pass against float64",
                                 gap["f64"])):
        if not share <= CGNET_SHARE_BOUND:
            raise PhaseError(f"CGNet's fp32 gradient: {what} is "
                             f"{share:.3e} off in {leaf}, above "
                             f"{CGNET_SHARE_BOUND:.3e}")
    step_inputs = os.path.join(dp_dir, "step_inputs.pt")
    torch.save({"batch": batch, "draws": draws}, step_inputs)
    print(f"[dp] one step of one process of {TRAIN_GRIDS} grids in "
          f"{time.perf_counter() - t0:.1f} s")
    ctx = dict(device=device, card=card, root=root, save=save, dp_dir=dp_dir, scene=scene,
               cfg_of=cfg_of, single=single, names=names, lr=lr,
               step_inputs=step_inputs)

    # (b) two ranks on one card over gloo
    launches, b_ck = dp_two_ranks(ctx, "b", "gloo", devices=False)

    # (c) two ranks over NCCL, where two cards are visible
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[dp] (c) did not run: {n_cards} CUDA device(s) visible; "
              f"two ranks over NCCL need two cards (NCCL refuses two ranks "
              f"on one device)")
    else:
        _, c_ck = dp_two_ranks(ctx, "c", "nccl", devices=True)
        dp_same(c_ck, b_ck, "(c) nccl's two ranks on two cards against "
                "gloo's on one")
        n_steps = ckpt_steps(save, "dp2_b")
        c_argv = ["train", *dp_cli_argv(root, save, "dp2_spawn"),
                  "--num_devices", "2", "--device", "cuda"]
        t0 = time.perf_counter()
        rc, text = finish(spawn(c_argv, os.path.join(dp_dir, "c_spawn.log"),
                                dict(os.environ, PYTHONPATH=REPO)), 900)
        if rc != 0:
            raise PhaseError(f"(c) --num_devices 2: exit {rc}:\n"
                             f"{text[-4000:]}")
        dp_same(ckpt_tensors(save, "dp2_spawn", n_steps)[0], c_ck,
                "(c) --num_devices 2 against the torchrun-style ranks")
        print(f"[dp] (c) train --num_devices 2 (the app's own launch, nccl) "
              f"in {time.perf_counter() - t0:.1f} s: final val "
              f"{final_val(text, '(c) --num_devices 2')}, the last "
              f"checkpoint the bits of the torchrun-style ranks' and of "
              f"gloo's on one card ({card})")
    return launches


def ckpt_steps(save: str, exp: str) -> int:
    """The newest checkpoint's step of an experiment."""
    d = os.path.join(save, "ckpts", exp)
    return max(int(x[:-3]) for x in os.listdir(d) if x.endswith(".pt"))


def dp_two_ranks(ctx, tag: str, backend: str, devices: bool):
    """Phase 11 (b) or (c): two ranks over ``backend``, both on cuda:0 or
    (``devices``) on cuda:0 and cuda:1, each started as torchrun starts one
    to run ``dp_rank_worker``: the one-step comparison, the timed train app,
    a second run that SIGTERM to rank 1 alone stops once step
    CLI_PREEMPT_AFTER is logged and its ``--auto_resume``, and ``eval`` of
    phase 9's checkpoint. -> (both ranks' launch counts of the timed run,
    its last checkpoint's tensors)."""
    import re
    import signal

    import numpy as np
    import torch

    from crnerf_tpu_torch.apps.serve import load_system
    from crnerf_tpu_torch.render.inference import Renderer

    device, card, root, save, dp_dir, scene, cfg_of = (
        ctx[k] for k in ("device", "card", "root", "save", "dp_dir", "scene",
                         "cfg_of"))
    t_ranks = time.perf_counter()
    where = "two cards" if devices else "one card"
    exp, stopped = f"dp2_{tag}", f"dp2_{tag}_resumed"
    stop_argv = dp_cli_argv(root, save, stopped)
    ckpt = os.path.join(save, "ckpts", "straight")
    ev_save = os.path.join(dp_dir, f"eval_{tag}")
    ev_argv = [*cli_args(root, ev_save, "straight", 0), "--split",
               "test_test", "--ckpt_path", ckpt]
    job_path = os.path.join(dp_dir, f"job_{tag}.json")
    with open(job_path, "w") as f:
        json.dump({"backend": backend, "step_inputs": ctx["step_inputs"],
                   "timed": dp_cli_argv(root, save, exp), "stop": stop_argv,
                   "resume": stop_argv + ["--auto_resume"],
                   "eval": ev_argv}, f)

    def stop_logged():   # the agreed stop: SIGTERM to rank 1 alone
        return any(x["step"] >= CLI_PREEMPT_AFTER and "train/loss" in x
                   for x in metric_rows(save, stopped))

    log0 = spawn_ranks(job_path, DP_RANKS, "dp_rank_worker", devices,
                       os.path.join(dp_dir, f"ranks_{tag}"), tag, 900,
                       (stop_logged, lambda jobs: jobs[1][0].send_signal(
                           signal.SIGTERM)))[0]
    t_ranks = time.perf_counter() - t_ranks
    res = []
    for r in range(DP_RANKS):
        with open(job_path + f".rank{r}") as f:
            res.append(json.load(f))

    steps = [torch.load(job_path + f".step{r}", weights_only=False)
             for r in range(DP_RANKS)]
    dp_same(steps[1]["tensors"], steps[0]["tensors"],
            f"({tag}) one step: rank 1 against rank 0")
    single, single_mu = ctx["single"]
    worst_all, worst_big = dp_deltas_bound(
        single_mu, steps[0]["tensors"], single, ctx["lr"], ctx["names"])
    shares = dp_mu_shares(steps[0]["mu"], single_mu, ctx["names"])
    print(f"[dp] ({tag}) one step of {DP_RANKS} ranks x {DP_GRIDS} grids over "
          f"{backend} on {where} against one process of {TRAIN_GRIDS} on the "
          f"same batch and draws: the ranks' states the same bits over "
          f"{len(single)} tensors; Adam's first moment (0.1 g) within "
          f"{shares[0][0]:.3e} of the leaf's largest (bound {DP_MU_SHARE}; "
          f"next {', '.join(f'{s:.3e} {n}' for s, n in shares[:4])}); "
          f"parameter updates within {worst_all:.4f} lr of the single "
          f"process's (bound 2), {worst_big:.4f} lr where the gradient "
          f"exceeds 1e-5 (bound 0.02)")
    if not (shares[0][0] <= DP_MU_SHARE and worst_all <= 2.0
            and worst_big <= 0.02):
        raise PhaseError(f"({tag}) one step: the two ranks' gradient or "
                         "parameters are not within the one-step bound of "
                         "the single process's")

    n_steps = CLI_EPOCHS * (sum(w * h for w, h in (
        im.wh for im in scene.train_images)) // CLI_BATCH // TRAIN_GRIDS)
    vw, vh = scene.train_images[0].wh
    per_rank = -(-vw * vh // DP_RANKS)   # a validation's rays a rank
    n_val = (CLI_EPOCHS + 1) * 2 * -(-per_rank // 2048)  # as phase 9's
    for r, x in enumerate(res):
        if x["step"] != n_steps:
            raise PhaseError(f"({tag}) rank {r} ended at step {x['step']}, "
                             f"expected {n_steps}")
        want = {k: 0 for k in x["launches"]}
        for k in ROUTES["stash"][1]:
            want[k] = 2 * n_steps
        want["fused_render_fwd"] = n_val
        if x["launches"] != want:
            raise PhaseError(f"({tag}) rank {r}: launch counters "
                             f"{x['launches']}, expected {want}")
    rows = metric_rows(save, exp)
    rps = [x["train/rays_per_sec"] for x in rows
           if "train/rays_per_sec" in x]
    val = final_val(log0, f"({tag}) two ranks")
    print(f"[dp] ({tag}) the train app on {DP_RANKS} ranks x {DP_GRIDS} grids "
          f"over {backend} on {where}, {n_steps} steps in "
          f"{res[0]['secs']['timed']:.1f} s with the validations and "
          f"checkpoints; over both ranks {epoch_rates(rps)}; peak memory per "
          f"rank {[round(x['peak_gib'], 2) for x in res]} GiB; final val "
          f"{val} ({card})")
    print(f"[dp] ({tag}) launches per rank {res[0]['launches']}: every stash "
          f"forward, chain and weight gradient on wgmma, none on mma.sync; "
          f"K1 in the sharded validations")

    m = re.search(r"preempted: checkpointed at step (\d+)", log0)
    if not m:
        raise PhaseError(f"({tag}) SIGTERM to rank 1: no preempted line:\n"
                         f"{log0[-4000:]}")
    at = int(m.group(1))
    ats = [x["stopped_at"] for x in res]
    if (ats != [at] * DP_RANKS or res[0]["ckpts_at_stop"] != [f"{at}.pt"]
            or not CLI_PREEMPT_AFTER <= at < n_steps):
        raise PhaseError(f"({tag}) stopped at {ats} (rank 0 printed {at}) "
                         f"with checkpoints {res[0]['ckpts_at_stop']}")
    print(f"[dp] ({tag}) SIGTERM to rank 1 alone once step "
          f"{CLI_PREEMPT_AFTER} was logged: both ranks stop at step {at}, "
          f"'preempted: checkpointed at step {at}', one checkpoint")

    vals = re.findall(r"final val: psnr=(\S+) ssim=(\S+)", log0)
    rval = tuple(map(float, vals[-1])) if len(vals) == 2 else None
    a_ck = ckpt_tensors(save, stopped, n_steps)[0]
    b_ck = ckpt_tensors(save, exp, n_steps)[0]
    dp_same(a_ck, b_ck, f"({tag}) the resumed run's last checkpoint against "
            "the unstopped two-rank run's")
    if [x["resumed_to"] for x in res] != [n_steps] * DP_RANKS or rval != val:
        raise PhaseError(f"({tag}) resumed to "
                         f"{[x['resumed_to'] for x in res]}, final val "
                         f"{rval} against {val}")
    print(f"[dp] ({tag}) --auto_resume on both ranks to step {n_steps}: the "
          f"last checkpoint the unstopped two-rank run's bits over "
          f"{len(a_ck)} tensors, final val {rval}")

    m = re.search(r"rendered (\d+) images .* median (\S+) / p95 (\S+)", log0)
    if not m or int(m.group(1)) != len(scene.test_images):
        raise PhaseError(f"({tag}) eval on two ranks:\n{log0[-4000:]}")
    cfg = cfg_of(ev_argv)
    out_dir = os.path.join(ev_save, "results", "phototourism", "cli")
    with user_flags():
        renderer = Renderer(cfg, load_system(cfg, ckpt, device), device)
        for i, im in enumerate(scene.test_images):
            w, h = im.wh
            want = renderer.fetch(renderer.render_frame_cam_async(
                im.c2w, im.K, im.near, im.far, (h, w),
                im.appearance[None].astype(np.float32),
                outputs="rgb_u8"))["rgb_u8"]
            with open(os.path.join(out_dir, f"{i:03d}.png"), "rb") as f:
                got = decode_png_rgb8(f.read())
            if got.shape != want.shape or not np.array_equal(got, want):
                raise PhaseError(f"({tag}) eval on two ranks: PNG {i} is "
                                 "not the single-process render's bits")
    print(f"[dp] ({tag}) eval --split test_test on two ranks: "
          f"{len(scene.test_images)} PNGs, the single-process render's bits "
          f"(phase 9's eval); median {m.group(2)} / p95 {m.group(3)} s a "
          f"frame, the ranks' first launches included ({card})")
    print(f"[dp] ({tag}) the two rank processes in {t_ranks:.1f} s, rank 0's "
          f"parts {({k: round(v, 1) for k, v in res[0]['secs'].items()})} "
          f"(the rest: start-up)")
    launches = {k: sum(x["launches"][k] for x in res)
                for k in res[0]["launches"]}
    return launches, b_ck


# Phase 12: the reference's own training command (``SURVEY.md``,
# ``commands/train.sh``: --encode_a --encode_c --encode_random --use_mask)
# on phase 9's cache at the flagship config, one epoch (36 steps) a run.
ENC_C_FLAGS = ["--encode_a", "--encode_c", "--encode_random", "--use_mask"]
ENC_C_EPOCHS = 1
RANGER_PREEMPT_AFTER = 20   # past the Lookahead syncs at steps 6, 12, 18
LEGACY_TOL = 1e-5           # Encoder3 / Decoder3, card against the CPU
NDC_RAYS = 4096
NDC_RTOL = 1e-6


@timed_phase
def phase_encode_c(device, workdir: str, card: str, cli_stats):
    """Phase 12: the reference's training command in this process, Ranger
    straight, stopped and resumed in subprocesses, the content heads'
    gradients on two routes, radam, the legacy zoo, and CGNet's group norm
    (``group_norm_check``). Works on the scene cache that phase 9 left in
    ``workdir`` (and writes one there if it is absent). -> the launch
    counts of the in-process run and of the group-norm check's counted
    step and served frame."""
    import gc
    import math

    import torch

    root = os.path.join(workdir, "scene")
    save = os.path.join(workdir, "runs_c")
    scene = (cli_scene(root, os.path.join(workdir, "empty"))
             if not os.path.isdir(root) else None)
    from crnerf_tpu_torch.data.phototourism import load_phototourism

    scene = scene or load_phototourism(root, img_downscale=2,
                                       appearance_wh=(224, 160))
    n_rays = sum(w * h for w, h in (im.wh for im in scene.train_images))
    ipe = n_rays // CLI_BATCH // TRAIN_GRIDS
    steps = ENC_C_EPOCHS * ipe
    vw, vh = scene.train_images[0].wh
    n_val = (ENC_C_EPOCHS + 1) * 2 * -(-vw * vh // 2048)

    def args(exp, *extra):
        return cli_args(root, save, exp) + ENC_C_FLAGS + list(extra)

    # (a) the reference's command, Adam on a cosine schedule
    with user_flags():
        launches, text, rows, peak, secs = cli_straight(
            args("encode_c"), save, "encode_c", steps, n_val,
            epochs=ENC_C_EPOCHS)
    val = final_val(text, "encode_c")
    train_rows = [r for r in rows if "train/loss" in r]
    bad = [r["step"] for r in train_rows
           if not math.isfinite(r.get("loss/content_constraint", math.nan))]
    if not train_rows or bad:
        raise PhaseError(f"encode_c: metrics rows without a finite "
                         f"loss/content_constraint at steps {bad}")
    terms = [r["loss/content_constraint"] for r in train_rows]
    rps = [r["train/rays_per_sec"] for r in rows if "train/rays_per_sec" in r]
    sps = rps[-1] / (CLI_BATCH * TRAIN_GRIDS)
    print(f"[encode_c] {steps} steps of the reference's command "
          f"({' '.join(ENC_C_FLAGS)}) in {secs:.1f} s with the validations "
          f"and checkpoints; epoch 0: {sps:.2f} steps/s against phase 9's "
          f"{cli_stats['steps_per_s_epoch0']:.2f} (its epoch 0); peak memory "
          f"{peak:.2f} GiB against {cli_stats['peak']:.2f}; "
          f"loss/content_constraint {terms[0]:.4e} -> {terms[-1]:.4e} over "
          f"{len(terms)} rows; final val {val} ({card})")
    print(f"[encode_c] launches {launches}: every stash forward, chain and "
          f"weight gradient on wgmma, none on mma.sync, K1 in the "
          f"validations")

    # (b) Ranger straight and stopped at once, then the resume
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=REPO)

    def train_argv(exp):
        return ["train", *args(exp, "--optimizer", "ranger"), "--num_epochs",
                str(ENC_C_EPOCHS), "--log_every", "5"]

    def log(tag):
        return os.path.join(workdir, f"encode_c_{tag}.log")

    out = preempt_and_resume(
        "[encode_c] Ranger:", train_argv, "ranger_resumed", save,
        RANGER_PREEMPT_AFTER, ipe, env, log,
        with_stop={"straight": (train_argv("ranger"), env)})
    if out["straight"][0] != 0:
        raise PhaseError(f"Ranger straight: exit {out['straight'][0]}:\n"
                         f"{out['straight'][1][-4000:]}")
    sval = final_val(out["straight"][1], "Ranger straight")
    rval = final_val(out["resume"][1], "Ranger resumed")
    straight = resumed_bits("[encode_c] Ranger:", save, "ranger",
                            "ranger_resumed", steps, sval, rval)
    slow = sum(k.endswith(".slow_buffer") for k in straight)
    print(f"[encode_c] Ranger: {slow} slow weights among them")
    if not slow:
        raise PhaseError("the Ranger checkpoints hold no slow weights")

    # (c) the content heads' gradients on two routes; radam
    grads, launch = {}, {}
    for route, kw in (("stash", {}),
                      ("pallas_train=False", dict(pallas_train=False))):
        metrics, _, _, grads[route], launch[route] = small_step(
            device, SEED, *small_step_inputs(SEED, encode_c=True, **kw))
        if not math.isfinite(metrics["loss/content_constraint"]):
            raise PhaseError(f"{route}: loss/content_constraint "
                             f"{metrics['loss/content_constraint']}")
    want = {k: (2 if k in ROUTES["stash"][2] else 0)
            for k in launch["stash"]}
    if (launch["stash"] != want
            or any(launch["pallas_train=False"].values())):
        raise PhaseError(f"encode_c small steps' launches {launch}")
    if not all(float(g.abs().max()) > 0 for k, g in grads["stash"].items()
               if k.startswith("enc_cont.") and k.endswith("weight")):
        raise PhaseError("enc_cont has a zero weight gradient")
    # the module route composites under autograd and sums per point, as
    # route C does: its bound (fp32 rounding apart)
    routes_agree("stash", grads["stash"], "pallas_train=False",
                 grads["pallas_train=False"], tol=1e-3)
    # enc_cont's leaves to the same bound, each over enc_cont's largest
    # gradient: its last bias's gradient is a cancellation (the content
    # term moves both embeddings alike), ~1e-5 of the others
    enc = [k for k in grads["stash"] if k.startswith("enc_cont.")]
    scale = max(float(grads["stash"][k].abs().max()) for k in enc)
    err, where = max((float((grads["pallas_train=False"][k]
                             - grads["stash"][k]).abs().max()) / scale, k)
                     for k in enc)
    print(f"[encode_c] pallas_train=False against stash, small fp32 step: "
          f"enc_cont's {len(enc)} gradients differ by at most {err:.3e} of "
          f"its largest ({where}; bound 1e-03)")
    if not err <= 1e-3:
        raise PhaseError(f"enc_cont's gradients disagree between the "
                         f"routes in {where}")
    cfg = train_config(optimizer="radam", encode_c=True)
    state, step, staged = make_trainer(cfg, device, SEED, (112, 84),
                                       cfg.resolved_chunks())
    losses = []
    for i in range(3):
        state, mt = step(state, staged[i % len(staged)])
        losses.append(float(mt["loss"]))
    finite = all(map(math.isfinite, losses)) and all(
        bool(torch.isfinite(p).all()) for p in state.system.parameters())
    print(f"[encode_c] radam, 3 flagship steps at encode_c: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}, parameters "
          f"{'finite' if finite else 'NOT FINITE'}")
    if not finite:
        raise PhaseError("radam: a loss or a parameter is not finite")
    optimizer_times(state.system, card)
    del state, step, staged
    legacy_zoo(device, card)
    gn = group_norm_check(device, workdir, card)
    return {k: launches[k] + gn[k] for k in launches}


def legacy_zoo(device, card: str):
    """The zoo's last pieces on the card: ``Encoder3`` -> ``Decoder3`` on
    seeded weights at the appearance size against the same modules on the
    CPU (``LEGACY_TOL`` of the largest value), their backward twice for the
    same bits, and ``get_ndc_rays`` on NDC_RAYS rays against the CPU
    (``NDC_RTOL``)."""
    import copy

    import torch

    from crnerf_tpu_torch.core.rays import get_ndc_rays
    from crnerf_tpu_torch.models.appearance import Decoder3, Encoder3
    from crnerf_tpu_torch.models.common import ieee_fp32_conv

    t0 = time.perf_counter()
    torch.manual_seed(SEED + 12)
    enc, dec = Encoder3(), Decoder3()
    gen = torch.Generator().manual_seed(SEED + 12)
    x = torch.rand((1, 160, 224, 3), generator=gen)
    with torch.no_grad():
        want_f = enc(x)
        want = dec(want_f)
    enc_d, dec_d = (copy.deepcopy(m).to(device) for m in (enc, dec))
    xd = x.to(device)
    with ieee_fp32_conv():
        with torch.no_grad():
            got_f = enc_d(xd)
            got = dec_d(got_f)
        cot = torch.randn(got.shape, generator=gen).to(device)
        bits = []
        for _ in range(2):
            for m in (enc_d, dec_d):
                m.zero_grad(set_to_none=True)
            (dec_d(enc_d(xd)) * cot).sum().backward()
            bits.append([p.grad.clone() for m in (enc_d, dec_d)
                         for p in m.parameters()])
    torch.cuda.synchronize()
    errs = {name: float((g.cpu() - w).abs().max() / w.abs().max())
            for name, g, w in (("features", got_f, want_f),
                               ("output", got, want))}
    same = all(torch.equal(a, b) for a, b in zip(*bits))
    o = torch.rand((NDC_RAYS, 3), generator=gen) * 2 - 1
    d = torch.randn((NDC_RAYS, 3), generator=gen)
    d[:, 2] = -d[:, 2].abs().clamp_min(0.2)
    ndc_want = get_ndc_rays(378, 504, 407.5, 1.0, o, d)
    ndc_got = get_ndc_rays(378, 504, 407.5, 1.0, o.to(device), d.to(device))
    ndc_err = max(float((g.cpu() - w).abs().max() / w.abs().max())
                  for g, w in zip(ndc_got, ndc_want))
    print(f"[encode_c] Encoder3 -> Decoder3 at 1 x 160 x 224 x 3 on the card "
          f"(IEEE fp32) against the CPU: features {errs['features']:.3e}, "
          f"output {errs['output']:.3e} of the largest (bound "
          f"{LEGACY_TOL:.0e}); the backward twice: "
          f"{'the same bits' if same else 'OTHER BITS'} over "
          f"{len(bits[0])} gradients; get_ndc_rays on {NDC_RAYS} rays "
          f"against the CPU: {ndc_err:.3e} of the largest (bound "
          f"{NDC_RTOL:.0e}); "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    if not (max(errs.values()) <= LEGACY_TOL and same
            and ndc_err <= NDC_RTOL):
        raise PhaseError(f"the legacy pair or get_ndc_rays on the card: "
                         f"{errs}, same bits {same}, ndc {ndc_err:.3e}")


GN_TURNS = 6     # step readings a side in the group-norm step's turns


def group_norm_check(device, workdir: str, card: str):
    """Phase 12 (e): CGNet's ``norm="group"``. The small fp32 stash-route
    step card against CPU (``SMALL_STEP_TOL``, both passes on the mma.sync
    pair); one flagship bf16 step, launch counters zeroed just before and
    read just after (every stash forward, chain and weight gradient on
    wgmma, none on mma.sync), finite; CGNet's backward on that step's style
    images twice, the same bits; the step timed in turns with the
    batch-norm step (batch, group, group, batch); and the system's
    weights.npz served: one 320x240 frame at 256+256 through
    RenderService.handle, launches counted (K1 on wgmma), the bits of an
    in-process Renderer on the same weights. -> the launch counts of the
    counted step and the served frame."""
    import math
    import statistics

    import numpy as np
    import torch

    from crnerf_tpu_torch.apps.serve import RenderService, load_system, warmup
    from crnerf_tpu_torch.render.inference import Renderer
    from crnerf_tpu_torch.utils import weights as bridge

    t0 = time.perf_counter()
    _, small = small_step_check(device, SEED, norm="group")
    want = {k: (2 if k in ROUTES["stash"][2] else 0) for k in small}
    if small != want:
        raise PhaseError(f"the group-norm small step's launches {small}")

    chunks = train_config().resolved_chunks()
    runs = {norm: make_trainer(train_config(norm=norm), device, SEED,
                               (112, 84), chunks)
            for norm in ("group", "batch")}
    state, step, staged = runs["group"]
    torch.cuda.synchronize()
    zero_counts()
    state, m = step(state, staged[0])
    torch.cuda.synchronize()
    launches = read_counts()
    want = {k: (2 * chunks if k in ROUTES["stash"][1] else 0)
            for k in launches}
    if launches != want:
        raise PhaseError(f"group-norm step: launch counters {launches}, "
                         f"expected {want}")
    bad = [k for k, v in m.items()
           if not math.isfinite(float(torch.as_tensor(v)))]
    if bad or not all(bool(torch.isfinite(p).all())
                      for p in state.system.parameters()):
        raise PhaseError(f"group-norm step: metrics {bad} or a parameter "
                         "not finite")
    cgnet = state.system.implicit_mask
    if cgnet.norms():
        raise PhaseError("the group-norm CGNet holds batch norms")
    print(f"[group_norm] flagship bf16 step, norm=group: loss "
          f"{float(m['loss']):.5f}, psnr {float(m['psnr']):.2f} dB, finite; "
          f"launches { {k: v for k, v in launches.items() if v} }: every "
          f"stash forward, chain and weight gradient on wgmma, none on "
          f"mma.sync")

    # CGNet's backward twice on the step's style images, a user's flags
    whole01 = ((staged[0]["whole_img"][:, 0] + 1.0) / 2.0).contiguous()
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    cot = None
    bits = []
    with user_flags():
        for _ in range(2):
            x = whole01.clone().requires_grad_(True)
            cgnet.zero_grad(set_to_none=True)
            mask = cgnet(x)
            if cot is None:
                cot = torch.randn(mask.shape, generator=gen, device=device)
            (mask * cot).sum().backward()
            bits.append([mask.detach(), x.grad]
                        + [p.grad.clone() for p in cgnet.parameters()])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*bits))
    print(f"[group_norm] CGNet (norm=group) on {tuple(whole01.shape)}: the "
          f"mask, the input's and {len(bits[0]) - 2} parameters' gradients "
          f"twice: {'the same bits' if same else 'OTHER BITS'}")
    if not same:
        raise PhaseError("the group-norm CGNet's backward changed its bits")
    cgnet.zero_grad(set_to_none=True)

    # the step in turns with the batch-norm step (its first step a warm-up;
    # a step updates its state in place)
    timed_steps(*runs["batch"], 1)
    readings = {"batch": [], "group": []}
    for norm in ("batch", "group", "group", "batch"):
        readings[norm] += timed_steps(*runs[norm], GN_TURNS, first=1)[0]
    med = {k: statistics.median(v) for k, v in readings.items()}
    print(f"[group_norm] the flagship step in turns (batch, group, group, "
          f"batch; {2 * GN_TURNS} steps a side): median {med['group']:.2f} "
          f"ms with norm=group against {med['batch']:.2f} ms with "
          f"norm=batch ({card})")

    # the system's weights.npz, served and rendered in process
    path = os.path.join(workdir, "group_norm_weights.npz")
    bridge.save_npz(bridge.flax_from_state_dict(state.system), path)
    del runs, state, step, staged
    torch.cuda.empty_cache()
    cfg = serve_config(norm="group")
    svc = RenderService(cfg, load_system(cfg, path, device))
    wa, ha = cfg.appearance_wh
    style = np.random.default_rng(SEED + 19).uniform(
        -1, 1, (1, ha, wa, 3)).astype(np.float32)
    svc.styles["gn"] = style
    w, h = FRAME_WH
    req = {"op": "render", "wh": [w, h], "c2w": C2W, "fov": 60.0,
           "near": NEAR, "far": FAR, "style_id": "gn", "inline": True}
    warmup(svc, f"{w}x{h}")    # first launches: weight layout, allocator
    zero_counts()
    reply = svc.handle(req)
    torch.cuda.synchronize()
    served = read_counts()
    if not reply.get("ok"):
        raise PhaseError(f"group-norm serve: {reply}")
    got = decode_png_rgb8(base64.b64decode(reply["png_b64"]))
    tiles = -(-w * h // cfg.chunk)
    want = {k: (2 * tiles if k == "fused_render_fwd" else 0) for k in served}
    if served != want:
        raise PhaseError(f"group-norm serve: launch counters {served}, "
                         f"expected {want}")
    r = Renderer(cfg, load_system(cfg, path, device))
    ref = r.fetch(r.render_frame_cam_async(
        np.asarray(C2W, np.float32), _fov_k(w, h), NEAR, FAR, (h, w), style,
        outputs="rgb_u8"))["rgb_u8"]
    print(f"[group_norm] the system's weights.npz served: one {w}x{h} frame "
          f"at 256+256 in {reply['ms']:.1f} ms, launches "
          f"{ {k: v for k, v in served.items() if v} } (K1 on wgmma), "
          f"{'the bits' if np.array_equal(got, ref) else 'NOT the bits'} of "
          f"an in-process Renderer; check (e) {time.perf_counter() - t0:.1f}"
          f" s ({card})")
    if not np.array_equal(got, ref):
        raise PhaseError("the served group-norm frame is not the in-process "
                         "Renderer's")
    return {k: launches[k] + served[k] for k in launches}


def centralize_per_tensor(grads):
    """Gradient centralisation a tensor at a time, a mean and a subtraction
    each: the alternative to the port's ``centralize``, timed beside it."""
    return [g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
            if g.dim() > 1 else g for g in grads]


def optimizer_times(system, card: str, n: int = 12, warm: int = 7):
    """One optimizer update over every parameter of ``system`` (its last
    step's gradients), timed with CUDA events over ``n`` updates after
    ``warm`` (Ranger's Lookahead syncs every 6th: two in the timed ones),
    Adam, RAdam, Ranger and Ranger with ``centralize_per_tensor`` in turns
    (a, r, g, p, p, g, r, a); then the two centralisations alone, in turns
    -> ms an update by name."""
    import torch

    from crnerf_tpu_torch.train import optim

    params = [p for p in system.parameters() if p.grad is not None]
    make = {"adam": lambda: torch.optim.Adam(params, lr=1e-8, eps=1e-8),
            "radam": lambda: optim.RAdam(params, lr=1e-8),
            "ranger": lambda: optim.Ranger(params, lr=1e-8),
            "ranger, GC per tensor": lambda: optim.Ranger(params, lr=1e-8)}
    times = {k: [] for k in make}
    port_gc = optim.centralize
    for name in ("adam", "radam", "ranger", "ranger, GC per tensor") * 2:
        opt = make[name]()
        if name.endswith("per tensor"):
            optim.centralize = centralize_per_tensor
        try:
            for _ in range(warm):
                opt.step()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "ab")
            torch.cuda.synchronize()
            start.record()
            for _ in range(n):
                opt.step()
            end.record()
            torch.cuda.synchronize()
        finally:
            optim.centralize = port_gc
        times[name].append(start.elapsed_time(end) / n)
    grads = [p.grad for p in params]
    a, b = port_gc(grads), centralize_per_tensor(grads)
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    for name, fn in (("GC alone", port_gc),
                     ("GC per tensor alone", centralize_per_tensor)) * 2:
        times.setdefault(name, []).append(
            time_ms(lambda: fn(grads), reps=n))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    each = ", ".join(
        f"{k} {v:.3f} ms ({' / '.join(f'{x:.3f}' for x in times[k])})"
        for k, v in ms.items())
    print(f"[encode_c] an optimizer update over {len(params)} parameters "
          f"({sum(p.numel() for p in params)} values), CUDA events over "
          f"{n} updates, in turns: {each}; the two centralisations differ "
          f"by at most {err:.3e} ({card})")
    return ms


# Phase 13: the 2-D (data, model) mode (``parallel/tp.py``) on the card, on
# the module route (``pallas_train=False``: the mode launches no hand
# kernel) at the flagship widths (8x256 coarse and fine, 64 + 64 samples,
# C = 64, bf16, 224x160 appearance, encode_a, use_mask), seeded weights and
# draws. Two ranks (data 1 x model 2) on the one card over gloo (NCCL
# refuses two ranks on one device), each started as torchrun starts one:
# (a) the small fp32 step against the one-process step on the same card;
# (b) TP_GRIDS grids of 1024 rays: step 1 against one process, then timed
# steps; (c) where two cards are visible, (b) over NCCL, a rank a card.
TP_MODEL = 2
TP_GRIDS = 2         # the flagship's 16 grids cut to 2: on one card every
#                      split layer's output columns cross the host
TP_TIMED = 1         # cut from 3: a 2-rank step on one card takes ~15 s
# (a): tests/test_tp.py's bounds on the small fp32 step's parameters and
# statistics and on its loss. Not the one process's bits: a split layer's
# product runs at another shape, for which cuDNN and cuBLAS may sum in
# another order (26 of 195 tensors differ on an H100, all within rtol
# 1e-3 + 0; the loss the same bits; PERF.md §6)
TP_SMALL_TOL = dict(rtol=1e-3, atol=2e-5, loss=2e-5)
TP_REL = 1e-3        # (b): step 1's loss and psnr against one process
# (b): a split leaf's Adam first moment (0.1 g) after step 1, as a share of
# the leaf's largest. The model ranks' loss is the one process's bits;
# their backward rounds each rank's part of an input's gradient to bf16
# before the sum, and the bf16 gradient of a leaf whose terms cancel
# is itself rounding: StyleNet's snet.conv1 at bf16 is 2.954 of its largest
# off the fp32 step's in one process, the ranks' 0.3125 off one process's,
# the ranks' error against fp32 at most 1.078x one process's on every split
# leaf (an H100, PERF.md §6). So every split leaf's error against the
# fp32 step is held within TP_FP32_RATIO times one process's + TP_MU_SHARE,
# and a leaf whose own bf16 error is under TP_MU_SHARE within TP_MU_SHARE
# of one process's (PERF.md §2's bf16 gradient bound). A wrong reduction
# (a sum over the model ranks' copies, one rank's part alone) reads ~0.5-1.
TP_MU_SHARE = 1e-2
TP_FP32_RATIO = 1.5


def tp_configs():
    """(a)'s small fp32 config and draws, (b)'s flagship config."""
    small, small_draws = small_step_inputs(SEED, pallas_train=False)
    full = train_config(pallas_train=False, grids_per_step=TP_GRIDS)
    return small, small_draws, full


def tp_replicas(state, split):
    """``dp_state_tensors`` without the ``split`` leaves and their
    optimizer state: what every model rank of a data index holds bit for
    bit."""
    order = [p for g in state.optimizer.param_groups for p in g["params"]]
    names = {id(p): k for k, p in state.system.named_parameters()}
    drop = {f"system.{k}" for k in split} | {
        f"adam.{i}.{s}" for i, p in enumerate(order) if names[id(p)] in split
        for s in state.optimizer.state[p]}
    return {k: v for k, v in dp_state_tensors(state).items()
            if k not in drop}


def tp_rank_worker(job_path: str):
    """One rank of phase 13, started as ``torchrun`` starts one (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) over the job's
    backend: (a) the small fp32 step, where the job asks for it; (b) step 1
    at the flagship widths on the job's draws, then TP_TIMED steps timed,
    the collectives' bytes and the peak memory read around them. Writes
    what it measured beside ``job_path``."""
    import torch

    from crnerf_tpu_torch.parallel import tp

    with open(job_path) as f:
        job = json.load(f)
    m2 = tp.make_mesh_2d(1, TP_MODEL, "cuda", job["backend"])
    device, r = m2.device, torch.distributed.get_rank()
    small, small_draws, full = tp_configs()
    out = {"device": str(device)}
    if job["small"]:
        state, sched, staged = seeded_state(small, device, SEED, (24, 18))
        state = tp.shard_state_tp(state, m2)
        step = tp.shard_train_step_tp(state, sched, m2,
                                      small.grids_per_step)
        with full_fp32():
            state, m = step(state, staged[0],
                            {k: v.to(device) for k, v in small_draws.items()})
        one = tp.gather_state_tp(state)
        torch.save({k: v.detach().cpu() for k, v in
                    one.system.state_dict().items()},
                   job_path + f".small{r}")
        split = {k for k, p in state.system.named_parameters()
                 if tp.split_of(p) is not None}
        torch.save(tp_replicas(state, split), job_path + f".smallrep{r}")
        out["small"] = {"loss": float(m["loss"])}
        del state, one, step
        dp_release()

    draws = torch.load(job["draws"], weights_only=False)
    with user_flags():
        state, sched, staged = seeded_state(full, device, SEED + 13,
                                            (112, 84))
        state = tp.shard_state_tp(state, m2)
        split = {k for k, p in state.system.named_parameters()
                 if tp.split_of(p) is not None}
        step = tp.shard_train_step_tp(state, sched, m2, TP_GRIDS)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        state, m = step(state, staged[0],
                        {k: v.to(device) for k, v in draws.items()})
        one = tp.gather_state_tp(state)
        mu = {k: one.optimizer.state[p]["exp_avg"].cpu()
              for k, p in one.system.named_parameters() if k in split}
        torch.save(mu, job_path + f".mu{r}")
        metrics = {"loss": float(m["loss"]), "psnr": float(m["psnr"])}
        del one, mu
        for k in tp.COLLECTIVE_BYTES:
            tp.COLLECTIVE_BYTES[k] = 0
        times, losses, _ = timed_steps(state, step, staged, TP_TIMED, 1)
        out["full"] = {
            "step1": metrics, "ms": times, "losses": losses,
            "bytes": {k: v / TP_TIMED
                      for k, v in tp.COLLECTIVE_BYTES.items()},
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
            "split": sorted(split),
            "local_rows": {k: list(p.shape) for k, p in
                           state.system.named_parameters() if k in split}}
    torch.save(tp_replicas(state, split), job_path + f".rep{r}")
    with open(job_path + f".rank{r}", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def tp_ranks(workdir: str, tag: str, backend: str, devices: bool,
             small: bool, draws_path: str):
    """Two ranks of ``tp_rank_worker`` over ``backend``, both on cuda:0
    or (``devices``) on cuda:0 and cuda:1 -> (the job's path, their
    results)."""
    job_path = os.path.join(workdir, f"tp_{tag}.json")
    with open(job_path, "w") as f:
        json.dump({"backend": backend, "small": small,
                   "draws": draws_path}, f)
    spawn_ranks(job_path, TP_MODEL, "tp_rank_worker", devices,
                os.path.join(workdir, f"tp_{tag}"), tag)
    res = []
    for r in range(TP_MODEL):
        with open(job_path + f".rank{r}") as f:
            res.append(json.load(f))
    return job_path, res


def tp_same_replicas(job_path: str, part: str, what: str) -> int:
    """The model ranks' ``tp_replicas`` (``part``: "rep" or "smallrep")
    the same bits -> how many tensors."""
    import torch

    reps = [torch.load(job_path + f".{part}{r}", weights_only=False)
            for r in range(TP_MODEL)]
    for r in range(1, TP_MODEL):
        dp_same(reps[r], reps[0], f"{what}: rank {r}'s replicated tensors "
                "against rank 0's")
    return len(reps[0])


def tp_check_full(tag: str, job_path: str, res, ref, where: str,
                  backend: str, card: str):
    """(b)'s checks and lines for the ranks' results ``res`` against the
    one process's ``ref``."""
    import statistics

    import torch

    a, b = (x["full"] for x in res)
    n_rep = tp_same_replicas(job_path, "rep", f"({tag})")
    if a["split"] != b["split"] or not a["split"]:
        raise PhaseError(f"({tag}) the ranks split {len(a['split'])} and "
                         f"{len(b['split'])} leaves")
    rows = [k for k in a["split"] if a["local_rows"][k][0] * TP_MODEL
            != ref["shapes"][k][0]]
    if rows:
        raise PhaseError(f"({tag}) split leaves without out / {TP_MODEL} "
                         f"rows: {rows[:4]}")
    errs = {k: abs(a["step1"][k] - ref["step1"][k]) / abs(ref["step1"][k])
            for k in ("loss", "psnr")}
    mus = [torch.load(job_path + f".mu{r}", weights_only=False)
           for r in range(TP_MODEL)]
    if any(not torch.equal(mus[0][k], mus[1][k]) for k in mus[0]):
        raise PhaseError(f"({tag}) the gathered first moments differ "
                         "between the ranks")

    def share(x, y):
        return float((x - y).abs().max()) / float(y.abs().max())

    # per split leaf: (against one process, one process's bf16 against
    # fp32, the ranks' against fp32, leaf)
    rows = [(share(mus[0][k], ref["mu"][k]),
             share(ref["mu"][k], ref["mu32"][k]),
             share(mus[0][k], ref["mu32"][k]), k) for k in a["split"]]
    worst = max(rows)
    # the margins of the two bounds (<= 0 holds), largest first
    over_fp32 = max((r[2] - TP_FP32_RATIO * r[1] - TP_MU_SHARE, r[3])
                    for r in rows)
    exact = [r for r in rows if r[1] < TP_MU_SHARE]
    over_one = max(((r[0] - TP_MU_SHARE, r[3]) for r in exact),
                   default=(-TP_MU_SHARE, None))
    ms = statistics.median(a["ms"])
    print(f"[tp] ({tag}) {TP_MODEL} model ranks over {backend} on {where}, "
          f"{TP_GRIDS} grids of 1024 rays at the flagship widths, bf16, "
          f"{len(a['split'])} leaves split: step 1's loss and psnr within "
          f"{errs['loss']:.3e} / {errs['psnr']:.3e} of one process's (bound "
          f"{TP_REL}); Adam's first moment of a split leaf at most "
          f"{worst[0]:.3e} of its largest off one process's ({worst[3]}, "
          f"whose own bf16 error against fp32 is {worst[1]:.3e}; the "
          f"ranks' against fp32 {worst[2]:.3e}); the ranks' error against "
          f"fp32 at most {max(r[2] / r[1] for r in rows):.3f}x one "
          f"process's, every leaf within {TP_FP32_RATIO}x + {TP_MU_SHARE} "
          f"by {-over_fp32[0]:.3e} at least ({over_fp32[1]}); the "
          f"{len(exact)} leaves whose own bf16 error is under "
          f"{TP_MU_SHARE} within {TP_MU_SHARE} of one process's by "
          f"{-over_one[0]:.3e} at least ({over_one[1]}); the replicated "
          f"tensors the same bits on both ranks over {n_rep} tensors")
    gb = {k: v / 1e9 for k, v in a["bytes"].items()}
    print(f"[tp] ({tag}) timed steps ({TP_TIMED}): median {ms:.2f} ms a step, "
          f"{1e3 / ms:.3f} steps/s (one process of {TP_GRIDS} grids: "
          f"{ref['ms']:.2f} ms, {1e3 / ref['ms']:.3f} steps/s); peak memory "
          f"a rank {[round(x['full']['peak_gib'], 2) for x in res]} GiB "
          f"against one process's {ref['peak_gib']:.2f}; the collectives "
          f"a step a rank: {gb['gather_from_model']:.3f} GB gathered, "
          f"{gb['copy_to_model']:.3f} GB of input gradients summed "
          f"({card})")
    if not (max(errs.values()) <= TP_REL and over_fp32[0] <= 0.0
            and over_one[0] <= 0.0):
        raise PhaseError(f"({tag}) step 1 not within the bounds of one "
                         "process's")
    bad = [x for x in a["losses"] + b["losses"] if not x == x
           or abs(x) == float("inf")]
    if bad:
        raise PhaseError(f"({tag}) non-finite timed losses {bad}")


@timed_phase
def phase_tp(device, workdir: str, card: str):
    """Phase 13: (a) and (b) on two ranks of the one card over gloo, (c)
    over NCCL where two cards are visible."""
    import statistics

    import torch

    from crnerf_tpu_torch.train.step import make_train_step

    tp_dir = os.path.join(workdir, "tp")
    os.makedirs(tp_dir, exist_ok=True)
    small, small_draws, full = tp_configs()

    # the one-process references on this card: (a) the small fp32 step
    state, step, staged = make_trainer(small, device, SEED, (24, 18), 1)
    with full_fp32():
        state, m = step(state, staged[0],
                        {k: v.to(device) for k, v in small_draws.items()})
    small_ref = ({k: v.detach().cpu() for k, v in
                  state.system.state_dict().items()}, float(m["loss"]))
    del state, step, staged
    # (b) step 1 on the seeded draws, then timed steps
    draws = seeded_draws(full, TP_GRIDS, SEED + 13)
    draws_path = os.path.join(tp_dir, "draws.pt")
    torch.save(draws, draws_path)
    with user_flags():
        state, sched, staged = seeded_state(full, device, SEED + 13,
                                            (112, 84))
        step = make_train_step(state.system, state.optimizer, sched,
                               TP_GRIDS)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        state, m = step(state, staged[0],
                        {k: v.to(device) for k, v in draws.items()})
        ref = {"step1": {"loss": float(m["loss"]), "psnr": float(m["psnr"])},
               "mu": {k: state.optimizer.state[p]["exp_avg"].to(
                   "cpu", copy=True)
                      for k, p in state.system.named_parameters()},
               "shapes": {k: list(p.shape) for k, p in
                          state.system.named_parameters()}}
        times, _, _ = timed_steps(state, step, staged, TP_TIMED, 1)
        ref["ms"] = statistics.median(times)
        ref["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        del state, step, staged
        dp_release()
    # the same step at fp32: each leaf's own bf16 error
    f32 = full.replace(compute_dtype="float32")
    state, sched, staged = seeded_state(f32, device, SEED + 13, (112, 84))
    step = make_train_step(state.system, state.optimizer, sched, TP_GRIDS)
    with full_fp32():
        state, _ = step(state, staged[0],
                        {k: v.to(device) for k, v in draws.items()})
    ref["mu32"] = {k: state.optimizer.state[p]["exp_avg"].to(
                       "cpu", copy=True)
                   for k, p in state.system.named_parameters()}
    del state, step, staged
    dp_release()

    job_path, res = tp_ranks(tp_dir, "ab", "gloo", False, True, draws_path)
    # (a)
    n_rep = tp_same_replicas(job_path, "smallrep", "(a)")
    got = [torch.load(job_path + f".small{r}", weights_only=False)
           for r in range(TP_MODEL)]
    want, want_loss = small_ref
    worst, other, top = 0.0, [], (-1.0, "")
    for k, v in want.items():
        if not torch.equal(got[0][k], got[1][k]):
            raise PhaseError(f"(a) the gathered {k} differs between ranks")
        if not torch.equal(got[0][k], v):
            other.append(k)
        diff = (got[0][k].double() - v.double()).abs()
        excess = diff - TP_SMALL_TOL["rtol"] * v.double().abs()
        worst = max(worst, float(excess.max()))
        top = max(top, (float(diff.max()), k))
    loss_rel = abs(res[0]["small"]["loss"] - want_loss) / abs(want_loss)
    print(f"[tp] (a) the small fp32 step on {TP_MODEL} model ranks over gloo "
          f"on one card against one process on the same card: "
          f"parameters and statistics within rtol {TP_SMALL_TOL['rtol']} + "
          f"{max(worst, 0.0):.3e} (bound {TP_SMALL_TOL['atol']}), "
          f"{len(want) - len(other)} of {len(want)} the same bits, the "
          f"largest difference {top[0]:.3e} ({top[1]}); the loss within "
          f"{loss_rel:.3e} (bound {TP_SMALL_TOL['loss']}); the replicated "
          f"tensors the same bits on both ranks over {n_rep} tensors "
          f"({card})")
    if not (worst <= TP_SMALL_TOL["atol"]
            and loss_rel <= TP_SMALL_TOL["loss"]):
        raise PhaseError("(a) the two-rank step is not within the bounds "
                         "of the one-process step")
    # (b)
    tp_check_full("b", job_path, res, ref, "one card", "gloo", card)
    # (c)
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[tp] (c) did not run: {n_cards} CUDA device(s) visible; "
              f"NCCL needs a card a rank")
    else:
        job_c, res_c = tp_ranks(tp_dir, "c", "nccl", True, False,
                                draws_path)
        tp_check_full("c", job_c, res_c, ref, "two cards", "nccl", card)


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
    t_run = time.perf_counter()
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
        train_launches, step_ms, peak, grads, fp32_launches = phase_train(
            device, SEED, args.profile_dir or None)
        print(f"[train] median {step_ms:.2f} ms per step, "
              f"{TRAIN_GRIDS * 1024 / step_ms * 1e3:.0f} train rays/s "
              f"({card})")
        route_launches, route_small = {}, {}
        for route in ("pallas_stash=False", "pertube_cord=True",
                      "pallas_render=False"):
            (route_launches[route], r_ms, r_peak, r_grads,
             route_small[route]) = phase_train(device, SEED, None, route)
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
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            _, cli_scene_, cli_stats = phase_cli(device, workdir, card)
            apps = phase_apps(device, workdir, card, cli_scene_)
            dp_launches = phase_dp(device, workdir, card)
            enc_c_launches = phase_encode_c(device, workdir, card, cli_stats)
            phase_tp(device, workdir, card)
    except Exception as e:  # any phase failing fails the run
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(f"[run] phases 2-13 in {time.perf_counter() - t_run:.1f} s "
          f"({card})")
    # every kernel's entry at the shape its main path gives it: the serve
    # tile's fine pass (8192 rays x S=512) and the train step's fine pass
    # (16,384 rays x S=128), bf16, recurrence encode; K1's, K1-stash's and
    # K2's launches those of their main paths' runs: the serve phase's
    # frames (K1) and the flagship step's (K1-stash, K2), each with phase
    # 10's counted runs, phase 11's timed two-rank run (both ranks),
    # phase 12's in-process run and its group-norm step and frame added
    main_kernel = next(r for r in records if r["variant"] == "wgmma"
                       and r["N"] == SERVE_TILE and r["S"] == 512)
    tk = next(r for r in train_records
              if r["N"] == TRAIN_GRIDS * 1024 and r["S"] == 128)

    def at_fine_pass(recs, xyz_in, variant="mma"):
        """The record at the no-stash steps' fine pass (16,384 x 128)."""
        return next(r for r in recs if r["N"] == TRAIN_GRIDS * 1024
                    and r["S"] == 128 and r["xyz_in"] == xyz_in
                    and r["variant"] == variant)

    def entry(name, source, replaces, n_launch, err, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r.get("library_ms")}

    def train_kernel(key, variant="wgmma"):   # the stash pair's numbers
        ms = tk["ms"][key] if variant == "wgmma" else tk["mma"]["ms"][key]
        return dict(ms=ms, plain_ms=tk["plain_ms"][key],
                    bound=tk["bound"][key],
                    library_ms=tk["library_ms"].get(key))

    def train_err(key, variant):
        """The largest error of the stash forward ("fwd") or the chain's
        sums ("chain") of ``variant`` over the phase's cases."""
        field = "err_fwd" if key == "fwd" else "abs_chain"
        own = [r[field] for r in train_records
               if r[f"{key}_variant"] == variant]
        if variant == "mma":
            own += [r["mma"][field] for r in train_records if r["mma"]]
        return max(own)

    def fwd_err(xyz_in, variant="mma"):
        return max(max(r["err_weights"], r["err_fmap"], r["err_depth"])
                   for r in records
                   if r["xyz_in"] == xyz_in and r["variant"] == variant)

    def recompute_err(xyz_in, variant):
        return max(r["abs_err"] for r in recompute_records
                   if r["xyz_in"] == xyz_in and r["variant"] == variant)

    def pipe_err(variant):
        return max(r["err_plain"] for r in pipe_records
                   if r["variant"] == variant and r["err_plain"] is not None)

    def mlp_fwd_err(variant):
        return max(r["err"] for r in mlp_fwd_records
                   if r["variant"] == variant)

    k1, k2, k3 = ("crnerf_tpu/ops/fused_render.py:348",
                  "crnerf_tpu/ops/fused_render.py:648",
                  "crnerf_tpu/ops/fused_render.py:437")
    fwd_cu = "crnerf_tpu_torch/csrc/fused_render_fwd.cuh"
    wgmma_cu = "crnerf_tpu_torch/csrc/fused_render_fwd_wgmma.cuh"
    bwd_cu = "crnerf_tpu_torch/csrc/fused_render_bwd.cuh"
    bwd_wgmma_cu = "crnerf_tpu_torch/csrc/fused_render_bwd_wgmma.cuh"
    rec_cu = "crnerf_tpu_torch/csrc/fused_render_bwd_recompute.cu"
    route_a = route_launches["pallas_stash=False"]
    route_b = route_launches["pertube_cord=True"]
    route_c = route_launches["pallas_render=False"]
    # the mma.sync kernels of routes A and B: their small fp32 steps'
    small_a = route_small["pallas_stash=False"]
    small_b = route_small["pertube_cord=True"]
    k4_fwd = next(r for r in mlp_fwd_records if r["variant"] == "wgmma"
                  and r["N"] == SERVE_TILE and r["S"] == 512)
    k4_fwd_mma = next(r for r in mlp_fwd_records if r["variant"] == "mma"
                      and r["N"] == TRAIN_GRIDS * 1024 and r["S"] == 128)
    small_c = route_small["pallas_render=False"]

    def k4_bwd(variant):     # route C's fine pass, 16,384 x 128
        return next(r for r in mlp_bwd_records if r["variant"] == variant
                    and r["N"] == TRAIN_GRIDS * 1024 and r["S"] == 128)

    def k4_bwd_err(variant):
        return max(r["err"] for r in mlp_bwd_records
                   if r["variant"] == variant)
    conv_cuh = "crnerf_tpu_torch/csrc/conv_fwd.cuh"
    conv3_train = [r for r in conv3_records
                   if r["shape"] == CONV3_SHAPES[1]]
    print(json.dumps({"kernels": [
        # the wgmma forward, launched by the serve path (and by route A's
        # step); the mma.sync one by route A's small fp32 step, its numbers
        # at route A's fine pass
        entry("fused_render_fwd", wgmma_cu, k1,
              launches + apps["fused_render_fwd"]
              + dp_launches["fused_render_fwd"]
              + enc_c_launches["fused_render_fwd"],
              fwd_err(False, "wgmma"), main_kernel),
        entry("fused_render_fwd (mma.sync)", fwd_cu, k1,
              small_a["fused_render_fwd_mma"], fwd_err(False),
              at_fine_pass(records, False)),
        # the stash route's pair, wgmma, launched by the bf16 step; its
        # mma.sync counterparts by the small fp32 step of the same route
        entry("fused_render_fwd_stash", wgmma_cu, k1,
              train_launches["fused_render_fwd_stash"]
              + apps["fused_render_fwd_stash"]
              + dp_launches["fused_render_fwd_stash"]
              + enc_c_launches["fused_render_fwd_stash"],
              train_err("fwd", "wgmma"), train_kernel("fwd_stash")),
        entry("fused_render_fwd_stash (mma.sync)", fwd_cu, k1,
              fp32_launches["fused_render_fwd_stash_mma"],
              train_err("fwd", "mma"), train_kernel("fwd_stash", "mma")),
        entry("fused_render_bwd", bwd_wgmma_cu, k2,
              train_launches["fused_render_bwd"] + apps["fused_render_bwd"]
              + dp_launches["fused_render_bwd"]
              + enc_c_launches["fused_render_bwd"],
              train_err("chain", "wgmma"), train_kernel("chain")),
        entry("fused_render_bwd (mma.sync)", bwd_cu, k2,
              fp32_launches["fused_render_bwd_mma"],
              train_err("chain", "mma"), train_kernel("chain", "mma")),
        # K2's weight gradient: the wgmma kernel, launched by every bf16
        # step (the stash route's twice, routes A-C's once a slab); the
        # fp32 one by the small fp32 step of the stash route, its numbers
        # at 1024 x 128
        entry("fused_render_bwd_wgrad",
              "crnerf_tpu_torch/csrc/wgrad_wgmma.cuh", k2,
              train_launches["fused_render_bwd_wgrad"]
              + apps["fused_render_bwd_wgrad"]
              + dp_launches["fused_render_bwd_wgrad"]
              + enc_c_launches["fused_render_bwd_wgrad"],
              max(r["abs_wgrad"] for r in train_records
                  if r["wgrad_variant"] == "wgmma"),
              train_kernel("wgrad")),
        entry("fused_render_bwd_wgrad (fp32)", bwd_cu, k2,
              fp32_launches["fused_render_bwd_wgrad_fp32"],
              max(r["abs_wgrad"] for r in train_records
                  if r["wgrad_variant"] == "fp32"),
              next(dict(ms=r["ms"]["wgrad"],
                        plain_ms=r["plain_ms"]["wgrad"],
                        bound=r["bound"]["wgrad"], library_ms=None)
                   for r in train_records if r["wgrad_variant"] == "fp32"
                   and r["N"] == N_RAYS and r["S"] == 128)),
        # route B's forward; route A's and B's recompute backward (the
        # wgmma pair a slab), the mma.sync ones by their small fp32 steps
        entry("K1 xyz-in", wgmma_cu, k1, route_b["fused_render_fwd_xyz"],
              fwd_err(True, "wgmma"), at_fine_pass(records, True, "wgmma")),
        entry("K1 xyz-in (mma.sync)", fwd_cu, k1,
              small_b["fused_render_fwd_xyz_mma"], fwd_err(True),
              at_fine_pass(records, True)),
        entry("K3 rays-in", rec_cu, k3,
              route_a["fused_render_bwd_recompute"],
              recompute_err(False, "wgmma"),
              at_fine_pass(recompute_records, False, "wgmma")),
        entry("K3 rays-in (mma.sync)", rec_cu, k3,
              small_a["fused_render_bwd_recompute_mma"],
              recompute_err(False, "mma"),
              at_fine_pass(recompute_records, False)),
        entry("K3 xyz-in", rec_cu, k3,
              route_b["fused_render_bwd_recompute_xyz"],
              recompute_err(True, "wgmma"),
              at_fine_pass(recompute_records, True, "wgmma")),
        entry("K3 xyz-in (mma.sync)", rec_cu, k3,
              small_b["fused_render_bwd_recompute_xyz_mma"],
              recompute_err(True, "mma"),
              at_fine_pass(recompute_records, True)),
        entry("K5", "crnerf_tpu_torch/csrc/composite.cu",
              "crnerf_tpu/ops/composite.py:34", composite_launches,
              max(r["err"] for r in composite_records),
              composite_records[0]),
        # the wgmma forward, launched by the pallas_render=False serve
        # path (and by route C's bf16 step); the mma.sync one by route C's
        # small fp32 step, its numbers at route C's fine pass
        entry("K4 fwd", "crnerf_tpu_torch/csrc/fused_mlp_fwd_wgmma.cuh",
              "crnerf_tpu/ops/fused_mlp.py:431", mlp_serve_launches,
              mlp_fwd_err("wgmma"), k4_fwd),
        entry("K4 fwd (mma.sync)", "crnerf_tpu_torch/csrc/fused_mlp_fwd.cuh",
              "crnerf_tpu/ops/fused_mlp.py:431",
              small_c["fused_mlp_fwd_mma"], mlp_fwd_err("mma"), k4_fwd_mma),
        # the wgmma backward (the wgmma stash forward, the wgmma chain and
        # K2's weight gradient a slab), launched by route C's bf16 step;
        # the mma.sync one by its small fp32 step
        entry("K4 bwd (wgmma)",
              "crnerf_tpu_torch/csrc/fused_mlp_bwd_wgmma.cuh",
              "crnerf_tpu/ops/fused_mlp.py:494", route_c["fused_mlp_bwd"],
              k4_bwd_err("wgmma"), k4_bwd("wgmma")),
        entry("K4 bwd (mma.sync)", "crnerf_tpu_torch/csrc/fused_mlp_bwd.cu",
              "crnerf_tpu/ops/fused_mlp.py:494",
              small_c["fused_mlp_bwd_mma"], k4_bwd_err("mma"),
              k4_bwd("mma")),
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
        # launched by the spike tools of phase 4f; S2's numbers at the
        # spike's 8192 x 128 with P = 2 (the mma.sync one's at 1024 x 256, 6
        # x 128 wide), its error against its plain version (it gives K1's
        # bits); S5's at 2048 tiles, stores mode
        entry("pipe render fwd",
              "crnerf_tpu_torch/csrc/pipe_render_fwd_wgmma.cuh",
              "scripts/spike_interleave.py:47",
              launches_4f["pipe_render_fwd"], pipe_err("wgmma"),
              next(r for r in pipe_records if r["variant"] == "wgmma"
                   and (r["N"], r["S"]) == PIPE_ENTRY and r["P"] == 2)),
        entry("pipe render fwd (mma.sync)",
              "crnerf_tpu_torch/csrc/pipe_render_fwd.cu",
              "scripts/spike_interleave.py:47",
              launches_4f["pipe_render_fwd_mma"], pipe_err("mma"),
              next(r for r in pipe_records if r["variant"] == "mma"
                   and r["P"] == 2)),
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
