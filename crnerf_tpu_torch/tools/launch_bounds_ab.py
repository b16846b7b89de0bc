"""A/B of the bf16 fused render kernels' occupancy hint on the card.

``csrc/fused_render_fwd.cuh`` (the forward) and ``csrc/fused_render_bwd.cuh``
(the backward's chain kernel) ask ``__launch_bounds__(NTHREADS, BF16 ? 2 :
1)``: two CTAs per SM for the bf16 variant, which caps it at 128 registers
(with some spill). This builds the source as shipped and with the hint at
one CTA per SM, checks that both give the same outputs bit for bit, and
times one launch of each in alternating pairs: the forward at the serve
tile (8192 rays x S=512, 8x256, C=64, recurrence encode), the chain at the
train step's fine pass (16,384 rays x S=128).

    python -m crnerf_tpu_torch.tools.launch_bounds_ab          # forward
    python -m crnerf_tpu_torch.tools.launch_bounds_ab chain    # needs a GPU

Variants are built into ``build/exp/<variant>/``: the library's ``.cu``
beside an edited copy of the kernel's header.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import _build
from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.tools._common import time_ms

SHIPPED = "__launch_bounds__(NTHREADS, BF16 ? 2 : 1)"
VARIANTS = {"2_ctas_per_sm": SHIPPED,
            "1_cta_per_sm": "__launch_bounds__(NTHREADS, 1)"}
N_RAYS, S, PAIRS, REPS = 8192, 512, 5, 5
CHAIN_RAYS, CHAIN_S = 16384, 128
# kernel -> (library source; its kernel header is the same name with
# .cuh, exported C functions, the wrapper's library getter)
KERNELS = {
    "fwd": ("fused_render_fwd.cu", (fr._C_FN,), "_lib"),
    "chain": ("fused_render_bwd.cu",
              ("crnerf_render_bwd_chain", "crnerf_render_bwd_wgrad"),
              "_lib_bwd"),
}


def build_variant(name: str, bounds: str, source: str,
                  functions) -> ctypes.CDLL:
    header = source + "h"
    src = (_build.CSRC / header).read_text()
    if SHIPPED not in src:
        raise RuntimeError(f"{SHIPPED!r} not found in the kernel source")
    out = _build.BUILD_DIR / "exp" / name
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / source, out / f"{name}.so"
    # the copied .cu includes the header beside it, not the shipped one
    cu.write_text((_build.CSRC / source).read_text())
    (out / header).write_text(src.replace(SHIPPED, bounds))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[{name}] {line.strip()}")
    lib = ctypes.CDLL(str(so))
    for fn_name in functions:
        fn = getattr(lib, fn_name)
        fn.argtypes = list(fr._C_ARGS)
        fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    kernel = (argv if argv is not None else sys.argv[1:] or ["fwd"])[0]
    if kernel not in KERNELS:
        print(f"launch_bounds_ab: kernel must be one of {sorted(KERNELS)}")
        return 2
    if not torch.cuda.is_available():
        print("launch_bounds_ab: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    source, functions, getter = KERNELS[kernel]
    libs = {k: build_variant(k, v, source, functions)
            for k, v in VARIANTS.items()}
    torch.manual_seed(0)
    params = fr.mlp_params_from_module(NerfMLP(depth=8, width=256,
                                               out_dim=64).to(dev))
    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    n_rays, s = (N_RAYS, S) if kernel == "fwd" else (CHAIN_RAYS, CHAIN_S)
    g = torch.Generator().manual_seed(1)
    o = (torch.randn(n_rays, 3, generator=g) * 0.5).to(dev)
    d = torch.randn(n_rays, 3, generator=g)
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(dev)
    z = torch.sort(torch.rand(n_rays, s, generator=g) * 4 + 0.5,
                   -1).values.to(dev)
    noise = torch.zeros(n_rays, s, device=dev)
    if kernel == "fwd":
        def run():     # the mma.sync forward, whose build this varies
            return fr.render_fwd(kw, o, d, z, noise, False, stash=False,
                                 variant="mma")[:2]
    else:
        _, _, stash = fr.render_fwd(kw, o, d, z, noise, False, stash=True)
        dir_blk = fr.dir_block(kw, d, False)
        g_ray = (torch.randn(n_rays, 128, generator=g) * 0.1).to(dev)
        g_w = (torch.randn(n_rays, s, generator=g) * 0.1).to(dev)

        def run():
            return fr.bwd_chain(kw, z, noise, dir_blk, stash, g_ray, g_w)
    shipped_lib = getattr(fr, getter)
    try:
        outs, times = {}, {k: [] for k in libs}
        for k, lib in libs.items():
            setattr(fr, getter, lambda lib=lib: lib)
            outs[k] = run()
        torch.cuda.synchronize()
        a, b = (outs[k] for k in libs)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"{kernel}: outputs bit-identical: {same}")
        del outs, a, b
        for order in (list(libs), list(libs)[::-1]) * PAIRS:
            for k in order:
                setattr(fr, getter, lambda lib=libs[k]: lib)
                times[k].append(time_ms(run, dev, REPS))
    finally:
        setattr(fr, getter, shipped_lib)
    for k, v in times.items():
        v = sorted(v)
        print(f"{k}: median {v[len(v) // 2]:.3f} ms per launch, range "
              f"{v[0]:.3f}-{v[-1]:.3f} ({len(v)} samples of {REPS})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
