"""Digest of the forward render kernel's outputs on seeded inputs.

    python3 -m crnerf_tpu_torch.tools.fwd_bits

Prints one sha256 per case (bf16 and fp32, exact encode and recurrence,
1024 rays x 256 samples, 8x256, C=64) over the bytes of the ray block and
the weights; then per case of the training forwards (the same dtypes and
encodes, the first 256 rays) one over the ray block, the weights and the
stash of the stash forward, and one over the ray block and the weights of
the xyz-in forward on the rays' sample points. The kernel has no atomics and a fixed order of sums, so two
builds that compute the same function print the same digests on the same
card: run it in two checkouts to show that a change to the kernel's source
left the inference launches bit-identical.
"""

from __future__ import annotations

import hashlib
import sys

import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_render as fr


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_bits: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=8, width=256, out_dim=64).to(dev))
    gen = torch.Generator().manual_seed(1)
    n, s = 1024, 256
    o = (torch.randn(n, 3, generator=gen) * 0.5).to(dev)
    d = torch.randn(n, 3, generator=gen)
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(dev)
    z = torch.sort(torch.rand(n, s, generator=gen) * 4.0 + 0.5,
                   -1).values.to(dev)
    noise = torch.randn(n, s, generator=gen).to(dev)
    for dt in (torch.bfloat16, torch.float32):
        kw = fr.prepare_kernel_weights(params, 15, 4, dt)
        for exact in (True, False):
            blk, w = fr.fused_render_apply(kw, o, d, z, noise, exact)
            torch.cuda.synchronize()
            h = hashlib.sha256(blk.cpu().numpy().tobytes()
                               + w.cpu().numpy().tobytes()).hexdigest()
            print(f"{str(dt)[6:]} exact={exact} {h}")
    m = 256
    pts = (o[:m, None, :] + d[:m, None, :] * z[:m, :, None]).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        kw = fr.prepare_kernel_weights(params, 15, 4, dt)
        for exact in (True, False):
            outs = fr.render_fwd(kw, o[:m], d[:m], z[:m], noise[:m], exact,
                                 stash=True)
            outs += fr.render_fwd(kw, None, d[:m], z[:m], noise[:m], exact,
                                  stash=False, xyz=pts)[:2]
            torch.cuda.synchronize()
            for name, ts in (("stash", outs[:3]), ("xyz-in", outs[3:])):
                h = hashlib.sha256(b"".join(
                    t.cpu().view(torch.uint8).numpy().tobytes()
                    for t in ts)).hexdigest()
                print(f"{str(dt)[6:]} exact={exact} {name} {h}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
