"""The packed (space-to-depth) conv spike: the hand-written packed 2x2
conv against cuDNN's packed and 3x3 convs at the appearance encoder's two
level shapes. Counterpart of ``scripts/spike_packed_conv.py``.

    python -m crnerf_tpu_torch.tools.spike_packed_conv [--iters 50]
    python -m crnerf_tpu_torch.tools.spike_packed_conv --device cpu

For each level, seeded bf16 x (B, H, W, C) and k3 (3, 3, C, F) * 0.05 are
packed as the JAX package packs them (``ops.conv._s2d``,
``packed_reflect_pad1``, ``_pack_kernel3x3``): a (B, H/2+1, W/2+1, 4C)
input and a (2, 2, 4C, 4F) kernel. It prints the kernel's max error
relative to cuDNN's packed conv, the kernel variant the shape takes
(``ops.conv.conv_variant``), and ms per call and TFLOP/s (of the packed
form's operations) of the kernel and cuDNN's packed conv (the medians of 6
readings taken in turns cuDNN, kernel, kernel, cuDNN), cuDNN's 3x3 conv of
the reflect-padded original (the same math at 9/16 the operations) and the
3x3 kernel of ``spike_conv3x3`` on the same. The JAX script's ``--rt``
(output rows a TPU tile) has no counterpart: a CTA here walks tiles of 128
output pixels x up to 256 channels, and any H works. Without a card the
tool stops unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from crnerf_tpu_torch.ops import conv as cv
from crnerf_tpu_torch.tools._common import (
    add_device_flag,
    device_line,
    pick_device,
    rel_err,
    time_ms,
    turns_ms,
)
from crnerf_tpu_torch.tools.spike_conv3x3 import library_fwd

# (label, original (B, H, W, C), F): conv3 and conv5 of the encoder
CASES = (
    ("conv3 L1 160x224x64->64", (8, 160, 224, 64), 64),
    ("conv5 L2 80x112x128->128", (8, 80, 112, 128), 128),
)


def level_inputs(shape, f: int, device, seed: int = 0):
    """Seeded bf16 (x, k3) of one level on ``device``."""
    b, h, w, c = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=g).to(torch.bfloat16)
    k3 = (torch.randn((3, 3, c, f), generator=g) * 0.05).to(torch.bfloat16)
    return x.to(device), k3.to(device)


def packed_operands(x: torch.Tensor, k3: torch.Tensor):
    """-> (xp_pad, k2): the packed, pre-padded input and packed kernel."""
    return (cv.packed_reflect_pad1(cv._s2d(x)).contiguous(),
            cv._pack_kernel3x3(k3).contiguous())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50,
                    help="calls a timing averages over")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "spike_packed_conv")
    if device is None:
        return 1
    print(device_line(device))
    torch.backends.cudnn.allow_tf32 = False   # moot at bf16; stated
    for label, (b, h, w, c), f in CASES:
        x, k3 = level_inputs((b, h, w, c), f, device)
        xp_pad, k2 = packed_operands(x, k3)
        xpad = cv.reflect_pad(x, 1).contiguous()
        lib_packed = library_fwd(xp_pad, k2)
        out = cv.packed_conv(xp_pad, k2)
        ref = lib_packed().permute(0, 2, 3, 1)
        variant = (cv.conv_variant(4 * c, 4 * f) if device.type == "cuda"
                   else "plain")
        print(f"{label}: max rel err vs library = {rel_err(out, ref):.2e}, "
              f"variant {variant}")
        del out, ref
        gflop = b * (h // 2) * (w // 2) * 4 * (4 * c) * (4 * f) * 2 / 1e9
        t_k, t_l = turns_ms(lambda: cv.packed_conv(xp_pad, k2), lib_packed,
                            device, args.iters)
        for name, t in (("kernel packed", t_k), ("cudnn packed ", t_l)):
            print(f"  {name}: {t:7.3f} ms ({gflop / t:6.1f} TFLOP/s)")
        for name, fn, note in [
            ("cudnn 3x3    ", library_fwd(xpad, k3),
             " (same math at 9/16 the packed FLOPs)"),
            ("kernel 3x3   ", lambda: cv.conv3x3_valid_fwd(xpad, k3),
             " (f32 out)"),
        ]:
            t = time_ms(fn, device, args.iters)
            print(f"  {name}: {t:7.3f} ms ({gflop / t:6.1f} TFLOP/s){note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
