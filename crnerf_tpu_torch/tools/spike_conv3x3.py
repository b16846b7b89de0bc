"""The 3x3 VALID conv spike: the hand-written conv kernels against cuDNN,
in time and in error, at the appearance encoder's conv3 shape by default.
Counterpart of ``scripts/spike_conv3x3.py``.

    python -m crnerf_tpu_torch.tools.spike_conv3x3 [--n 8 --h 160 --w 224
                                                    --c 64 --co 64]
    python -m crnerf_tpu_torch.tools.spike_conv3x3 --check
    python -m crnerf_tpu_torch.tools.spike_conv3x3 --device cpu ...

Seeded bf16 inputs: the padded input (N, H+2, W+2, C), the kernel (3, 3,
C, Co) and an output cotangent (N, H, W, Co), standard normal. Without
``--check`` it prints, for the forward and for the weight gradient, the
kernel variant the shape takes (``ops.conv.conv_variant``), ms per call and
TFLOP/s of the kernel (f32 out) and of cuDNN (``F.conv2d``,
``torch.nn.grad.conv2d_weight``: bf16 in and out, channels-last), each the
median of 6 readings of 20 calls taken in turns cuDNN, kernel, kernel,
cuDNN (``_common.turns_ms``), and each side's own bound at the card's
published peaks (its output in its own dtype). ``--check`` holds
both kernels to their plain versions (``ops.conv.KERNEL_TOL_F32``) and to
cuDNN (one bf16 step, cuDNN's outputs being bf16), prints "checks OK" and
returns 0, or returns 1. cuDNN is the yardstick only: no path of the port
calls it for these. Without a card the tool stops unless given ``--device
cpu``, where the wrappers take their plain versions and PyTorch's CPU
convolution stands in for cuDNN.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from crnerf_tpu_torch.ops import conv as cv
from crnerf_tpu_torch.tools._common import (
    add_device_flag,
    device_line,
    pick_device,
    rel_err,
    turns_ms,
)

ITERS = 20   # calls a timing averages over, as the JAX script's scan
# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float):
    """-> (the least ms at the card's peaks, "bytes" or "operations")."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def inputs(n: int, h: int, w: int, c: int, co: int, device):
    """Seeded (xpad, kernel, dy), bf16, on ``device``."""
    def normal(shape, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g).to(torch.bfloat16).to(device)

    return (normal((n, h + 2, w + 2, c), 0), normal((3, 3, c, co), 1),
            normal((n, h, w, co), 2))


def library_fwd(xpad: torch.Tensor, kernel: torch.Tensor):
    """-> a function of no arguments: cuDNN's VALID conv of the NHWC input
    (channels-last NCHW view) with the kernel as a channels-last OIHW
    weight, bf16 out (N, Co, H, W) in channels-last memory."""
    x = xpad.permute(0, 3, 1, 2)
    wt = kernel.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(x, wt)


def library_dw(xpad: torch.Tensor, dy: torch.Tensor, kernel_shape):
    """-> a function of no arguments: cuDNN's weight gradient (Co, C, 3,
    3), bf16."""
    x = xpad.permute(0, 3, 1, 2)
    d = dy.permute(0, 3, 1, 2)
    kh, kw, c, co = kernel_shape
    return lambda: torch.nn.grad.conv2d_weight(x, (co, c, kh, kw), d)


def check(xpad, kernel, dy) -> bool:
    fwd = cv.conv3x3_valid_fwd(xpad, kernel)
    dw = cv.conv3x3_dw(xpad, dy)
    lib_fwd = library_fwd(xpad, kernel)().permute(0, 2, 3, 1)
    lib_dw = library_dw(xpad, dy, kernel.shape)().permute(2, 3, 1, 0)
    errs = {
        "fwd vs plain": (rel_err(fwd, cv.conv_valid_plain(xpad, kernel)),
                         cv.KERNEL_TOL_F32),
        "fwd vs cuDNN": (rel_err(fwd, lib_fwd), cv.KERNEL_TOL_BF16),
        "dw vs plain": (rel_err(dw, cv.conv3x3_dw_plain(xpad, dy)),
                        cv.KERNEL_TOL_F32),
        "dw vs cuDNN": (rel_err(dw, lib_dw), cv.KERNEL_TOL_BF16),
    }
    for name, (e, tol) in errs.items():
        print(f"{name}: max rel err {e:.3e} (bound {tol:.3e}) "
              f"{'ok' if e <= tol else 'FAIL'}")
    return all(e <= tol for e, tol in errs.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--h", type=int, default=160)
    ap.add_argument("--w", type=int, default=224)
    ap.add_argument("--c", type=int, default=64)
    ap.add_argument("--co", type=int, default=64)
    ap.add_argument("--check", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "spike_conv3x3")
    if device is None:
        return 1
    print(device_line(device))
    torch.backends.cudnn.allow_tf32 = False   # moot at bf16; stated
    xpad, kernel, dy = inputs(args.n, args.h, args.w, args.c, args.co,
                              device)
    if args.check:
        if not check(xpad, kernel, dy):
            return 1
        print("checks OK")
        return 0
    flops = 2 * 9 * args.n * args.h * args.w * args.c * args.co
    m = args.n * args.h * args.w
    variant = (cv.conv_variant(args.c, args.co) if device.type == "cuda"
               else "plain")
    # (kind, kernel, cuDNN, bytes both read, output elements)
    for kind, kern, lib, reads, outs in [
        ("fwd", lambda: cv.conv3x3_valid_fwd(xpad, kernel),
         library_fwd(xpad, kernel), 2 * (xpad.numel() + kernel.numel()),
         m * args.co),
        ("dw ", lambda: cv.conv3x3_dw(xpad, dy),
         library_dw(xpad, dy, kernel.shape),
         2 * (xpad.numel() + dy.numel()), kernel.numel()),
    ]:
        t_k, t_l = turns_ms(kern, lib, device, ITERS)
        for name, t, out_bytes in ((f"kernel {kind} ({variant})", t_k, 4),
                                   (f"cudnn  {kind}", t_l, 2)):
            b, by = bound_ms(flops, reads + out_bytes * outs)
            print(f"{name:20s}: {t:7.4f} ms ({flops / t / 1e9:6.1f} "
                  f"TFLOP/s), its bound {b:.4f} ms ({by}, output at "
                  f"{out_bytes} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
