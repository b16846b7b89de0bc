"""Whether the flagship stash-route train step (``tf32_ab``'s: 16 grids of
1024 rays, 64 + 64 samples, 8x256 MLPs, C=64, bf16, Adam) keeps its bits
from run to run on the card, and what keeping them costs.

    python -m crnerf_tpu_torch.tools.step_bits      # needs a GPU
    python -m crnerf_tpu_torch.tools.step_bits --digest


The step is built from its seeds twice and takes 4 steps each time; every
tensor is compared: the first step's gradients, then the parameters,
buffers, embedding cache and validity mask after the last. First with the
operators as they are, then with the three fixes taken out, as the port
had them before: autograd's own backwards of ``F.pad(mode="reflect")``
and ``F.interpolate`` (both add with atomics on the card) and cuDNN free
to choose in every convolution's backward. Then steps in blocks of 6,
fixed, free, free, fixed, four times, within one process, and one
profiled step of each with its device time. With ``--digest``, one run
from the seeds and a sha256 over its tensors' names and bytes: equal in two
checkouts on the same card means the step kept its bits.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from crnerf_tpu_torch.models import common
from crnerf_tpu_torch.tools.tf32_ab import STAGED, trainer

STEPS, WARMUP, BLOCK = 4, 2, 6


class _Interpolate:
    @staticmethod
    def apply(x, out_hw):
        return F.interpolate(x, size=out_hw, mode="bilinear",
                             align_corners=False, antialias=False)


@contextlib.contextmanager
def fixes_removed():
    """The reflect pad, the bilinear resize and the convolutions'
    backwards as autograd and cuDNN give them; restored after."""
    saved = (common.reflect_pad_nchw, common._ResizeBilinear,
             common.deterministic_cudnn)
    common.reflect_pad_nchw = (
        lambda x, pad=1: F.pad(x, (pad, pad, pad, pad), mode="reflect"))
    common._ResizeBilinear = _Interpolate
    common.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        (common.reflect_pad_nchw, common._ResizeBilinear,
         common.deterministic_cudnn) = saved


def run(dev):
    """-> every tensor of a run of STEPS steps from the seeds, by name."""
    state, step, staged = trainer(dev)
    out = {}
    for i in range(STEPS):
        state, _ = step(state, staged[i % STAGED])
        if i == 0:
            out = {f"grad.{k}": p.grad.clone()
                   for k, p in state.system.named_parameters()
                   if p.grad is not None}
    out.update({k: v.detach().clone()
                for k, v in state.system.state_dict().items()})
    out["embedding_cache"] = state.embedding_cache.clone()
    out["embedding_valid"] = state.embedding_valid.clone()
    return out


def digest(tensors) -> str:
    """sha256 over the tensors' names and bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().reshape(-1).cpu().contiguous()
        h.update(k.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def compare(dev, name: str):
    a, b = run(dev), run(dev)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    grads = [k for k in differ if k.startswith("grad.")]
    print(f"{name}: two runs from the seeds, {len(a)} tensors: "
          f"{len(differ)} differ ({len(grads)} of the first step's "
          f"gradients; first: {grads[:4] or differ[:4]})")
    return not differ


def device_ms(prof) -> float:
    """Device time of a profile's kernels, in ms."""
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        total += e.self_cuda_time_total if t is None else t
    return total / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--digest", action="store_true",
                   help="one run from the seeds and its tensors' sha256")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_bits: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    if args.digest:
        out = run(dev)
        print(f"step digest over {len(out)} tensors: {digest(out)}")
        return 0
    print(f"torch {torch.__version__}; cudnn deterministic "
          f"{torch.backends.cudnn.deterministic}, benchmark "
          f"{torch.backends.cudnn.benchmark}")
    same = compare(dev, "fixed")
    with fixes_removed():
        compare(dev, "free")
    state, step, staged = trainer(dev)
    for i in range(WARMUP):
        state, _ = step(state, staged[i % STAGED])
    times, blocks, k = {"fixed": [], "free": []}, [], WARMUP
    for name in ("fixed", "free", "free", "fixed") * 4:
        ctx = fixes_removed if name == "free" else contextlib.nullcontext
        with ctx():
            for _ in range(BLOCK):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, staged[k % STAGED])
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
                k += 1
        blocks.append(f"{name} {statistics.median(times[name][-BLOCK:]):.2f}")
    print(f"block medians, ms: {', '.join(blocks)}")
    for name in ("fixed", "free"):
        ctx = fixes_removed if name == "free" else contextlib.nullcontext
        with ctx():
            state, _ = step(state, staged[k % STAGED])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, staged[k % STAGED])
                torch.cuda.synchronize()
        t = times[name]
        print(f"step {name}: median {statistics.median(t):.2f} ms over "
              f"{len(t)} steps (quartiles "
              f"{' / '.join(f'{q:.2f}' for q in statistics.quantiles(t))})"
              f"; device time of one profiled step {device_ms(prof):.2f} "
              f"ms")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
