"""Accuracy of in-kernel sin/cos on the card, as a function of the
argument's magnitude: the sincos kernel (the ``sinf`` / ``cosf`` the fused
kernels' encode evaluates, and the fast intrinsics as a second variant)
against ``torch.sin`` / ``torch.cos`` and against float64. Counterpart of
``scripts/spike_kernel_sincos.py``.

    python -m crnerf_tpu_torch.tools.spike_kernel_sincos
    python -m crnerf_tpu_torch.tools.spike_kernel_sincos --device cpu

Seeded x ~ U(-1, 1), (1024, 128) float32, times each scale of
``ops.sincos.SCALES`` (5 rad to 81,920 = 5 * 2^14, the encode's anchor
scales and beyond). Per scale: the kernel's max error against the library
op, then the accurate and the fast variant against float64 (numpy at the
float32 argument); then the library against float64 at 1280 rad (the JAX
script's last line) and the kernel's and the library's ms per call: as a
caller sees it, in turns (library, kernel, kernel, library; medians of 6
readings of 20 calls), and on the card also the device's own time per
call (a CUDA graph of 20 calls replayed).
Returns 1 if the accurate variant is off float64 by more than
``ops.sincos.F64_TOL`` at any scale. Without a card the tool stops unless
given ``--device cpu`` (plain versions only: no fast variant there).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from crnerf_tpu_torch.ops import sincos as sc
from crnerf_tpu_torch.tools._common import (
    add_device_flag,
    device_line,
    graph_ms,
    pick_device,
    turns_ms,
)


def unit_inputs(device, n: int = 1024, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 128), generator=g) * 2.0 - 1.0).to(device)


def f64_err(got: torch.Tensor, x: torch.Tensor, fn) -> float:
    return float(np.abs(got.cpu().double().numpy()
                        - fn(x.cpu().double().numpy())).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "spike_kernel_sincos")
    if device is None:
        return 1
    print(device_line(device))
    x01 = unit_inputs(device)
    ok = True
    for scale in sc.SCALES:
        x = (x01 * scale).contiguous()
        s_k, c_k = sc.sincos(x)
        s_l, c_l = torch.sin(x), torch.cos(x)
        es = float((s_k - s_l).abs().max())
        ec = float((c_k - c_l).abs().max())
        acc = (f64_err(s_k, x, np.sin), f64_err(c_k, x, np.cos))
        line = (f"max|arg|={scale:9.0f} rad: sin err {es:.3e}  cos err "
                f"{ec:.3e} (vs torch); vs float64: sin {acc[0]:.3e} cos "
                f"{acc[1]:.3e}")
        if device.type == "cuda":
            s_f, c_f = sc.sincos(x, fast=True)
            line += (f"; fast intrinsics vs float64: sin "
                     f"{f64_err(s_f, x, np.sin):.3e} cos "
                     f"{f64_err(c_f, x, np.cos):.3e}")
        print(line)
        ok = ok and max(acc) <= sc.F64_TOL
    x = (x01 * 1280.0).contiguous()
    print("torch sin vs f64 numpy @1280 rad:",
          f"{f64_err(torch.sin(x), x, np.sin):.3e}")
    t_k, t_l = turns_ms(lambda: sc.sincos(x),
                        lambda: (torch.sin(x), torch.cos(x)), device)
    line = (f"per (1024, 128) call, in turns: kernel {t_k:.4f} ms, "
            f"torch.sin + torch.cos {t_l:.4f} ms")
    if device.type == "cuda":
        g_k = graph_ms(lambda: sc.sincos(x), device)
        g_l = graph_ms(lambda: (torch.sin(x), torch.cos(x)), device)
        line += (f"; device time: kernel {g_k:.4f} ms, torch.sin + "
                 f"torch.cos {g_l:.4f} ms")
    print(line)
    if not ok:
        print(f"the accurate variant is off float64 by more than "
              f"{sc.F64_TOL:.3e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
