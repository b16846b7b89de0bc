"""What building the encode block costs beside the product that reads it:
the sublane-stores kernel (``ops/sublane_stores.py``) in its three modes.
Counterpart of ``scripts/spike_sublane_stores.py``.

    python -m crnerf_tpu_torch.tools.spike_sublane_stores
    python -m crnerf_tpu_torch.tools.spike_sublane_stores --tiles 2 --device cpu

Inputs as the spike's: seeded x ~ N(0, 1), (tiles * 8, 512) float32, and
w ~ N(0, 1), (96, 256) bfloat16 (a ``torch.Generator``; the JAX script's
``jax.random`` numbers are not reproduced). Per mode: microseconds per tile
at the margin, (ms at ``--tiles`` - ms at half as many) / (tiles / 2), as
the spike times it, and ms per launch at ``--tiles``; then the kernel's max
error against its plain version on real (sin t, cos t) states in x's rows
0-5 (on the spike's N(0, 1) rows the ``stores`` recurrence overflows to
inf / NaN, in both), as a share of the plain version's largest value, and
the max difference of the kernel's bf16 blocks from the plain ones. Then
the yardstick: one cuBLAS ``torch.mm`` of the same product on the prebuilt
bf16 block, (tiles * 512, 96) by (96, 256), with bf16 output and with f32
output (``out_dtype``), each beside its bound; and the kernel's bound.
Timings average ``--iters`` calls (at least 20: fewer time the host).
Returns 1 if a mode's error exceeds its ``ops.sublane_stores.KERNEL_TOL``
or its blocks their ``BLOCK_TOL``.
Without a card the tool stops unless given ``--device cpu`` (plain
versions, times on the host clock, no cuBLAS).
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from crnerf_tpu_torch.ops import sublane_stores as ss
from crnerf_tpu_torch.tools._common import (
    add_device_flag,
    device_line,
    pick_device,
    rel_err,
    time_ms,
)

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12


def spike_inputs(tiles: int, device, seed: int = 0):
    """(x, w) as the spike draws them, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((ss.ROWS, ss.N_OUT), generator=g).bfloat16()
    x = torch.randn((tiles * 8, ss.T), generator=g)
    return x.to(device), w.to(device)


def real_states(tiles: int, device, seed: int = 1) -> torch.Tensor:
    """x with (sin t, cos t) of a seeded angle in rows 0-2 / 3-5 of every
    tile (the recurrence's own domain) and N(0, 1) in rows 6-7."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((tiles, 8, ss.T), generator=g)
    theta = (torch.rand((tiles, 3, ss.T), generator=g) * 2 - 1) * math.pi
    x[:, 0:3], x[:, 3:6] = torch.sin(theta), torch.cos(theta)
    return x.reshape(tiles * 8, ss.T).to(device)


def bound_ms(flops: float, nbytes: float) -> str:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return f"{1e3 * max(t_ops, t_bytes):.4f} ms ({by})"


def kernel_bound(tiles: int):
    """-> (FLOP, bytes) of the kernel's work: x read, w read, the f32
    output written once."""
    flops = 2.0 * tiles * ss.T * ss.ROWS * ss.N_OUT
    return flops, 4 * tiles * 8 * ss.T + 2 * ss.ROWS * ss.N_OUT \
        + 4 * tiles * ss.T * ss.N_OUT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=2048,
                    help="tiles of the timed launch (the margin is taken "
                         "against half as many)")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls a timing averages over")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "spike_sublane_stores")
    if device is None:
        return 1
    if args.tiles < 2 or args.tiles % 2:
        print("--tiles must be even and >= 2", file=sys.stderr)
        return 1
    print(device_line(device))
    x, w = spike_inputs(args.tiles, device)
    half = x[:args.tiles * 4]
    states = real_states(args.tiles, device)
    ok = True
    for mode in ss.MODES:
        ms_full = time_ms(lambda: ss.sublane_stores(x, w, mode), device,
                          args.iters)
        ms_half = time_ms(lambda: ss.sublane_stores(half, w, mode), device,
                          args.iters)
        per_tile_us = 1e3 * (ms_full - ms_half) / (args.tiles // 2)
        err = rel_err(ss.sublane_stores(states, w, mode),
                      ss.sublane_stores_plain(states, w, mode))
        blk_err = float((ss.kernel_blocks(states, mode)
                         - ss.sublane_blocks_plain(states, mode)
                         .to(torch.bfloat16).float()).abs().max())
        ok = (ok and err <= ss.KERNEL_TOL[mode]
              and blk_err <= ss.BLOCK_TOL[mode])
        print(f"{mode:8s}: {per_tile_us:7.4f} us/tile (margin), "
              f"{ms_full:.4f} ms per launch of {args.tiles} tiles; max err "
              f"vs plain on (sin, cos) states {err:.3e} of the largest "
              f"(bound {ss.KERNEL_TOL[mode]:.2e}), blocks {blk_err:.3e} "
              f"(bound {ss.BLOCK_TOL[mode]:.2e})")
    flops, nbytes = kernel_bound(args.tiles)
    print(f"kernel bound at {args.tiles} tiles: {bound_ms(flops, nbytes)}")
    if device.type == "cuda":
        blk = ss.sublane_blocks_plain(x, "base").to(torch.bfloat16)
        a = blk.transpose(1, 2).reshape(-1, ss.ROWS).contiguous()
        del blk
        m = a.shape[0]
        in_bytes = 2 * (a.numel() + w.numel())
        for name, kw, out_size in (("bf16 out", {}, 2),
                                   ("f32 out", {"out_dtype": torch.float32},
                                    4)):
            lib_ms = time_ms(lambda: torch.mm(a, w, **kw), device,
                             args.iters)
            print(f"cuBLAS torch.mm (prebuilt block, {name}): {lib_ms:.4f} "
                  f"ms per launch of {args.tiles} tiles, bound "
                  f"{bound_ms(flops, in_bytes + out_size * m * ss.N_OUT)}")
    else:
        print("cuBLAS: none on the CPU")
    if not ok:
        print("a mode's error exceeds its bound", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
