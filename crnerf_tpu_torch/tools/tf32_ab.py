"""What the IEEE pin of CGNet's convolutions changes on the card: CGNet's
mask and the gradients of its parameters at the process's default flags
(cuDNN may run fp32 convolutions in TF32) against the same evaluation with
TF32 off everywhere, with the pin (``models.common.ieee_fp32_conv``) in
place and with it taken out; then the flagship stash-route train step (16
grids of 1024 rays, 64 + 64 samples, 8x256 MLPs, C=64, bf16, Adam) with and
without the pin, in blocks of steps in the order pinned, unpinned,
unpinned, pinned within one process.

    python -m crnerf_tpu_torch.tools.tf32_ab      # needs a GPU

CGNet runs in training mode (batch statistics) on the style images of the
step's first batch, the gradients from a seeded cotangent on its logits
(``cgnet_eval``); its pending BatchNorm sums are put back as they were
after each evaluation.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time

import torch

from crnerf_tpu_torch import Config
from crnerf_tpu_torch.data.pipeline import TrainPipeline
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.models import common
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step

GRIDS, WARMUP, STEPS, STAGED = 16, 2, 4, 2


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuBLAS and cuDNN inside the block (legacy flags, as the
    port's fp32 references set them), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def pin_removed():
    """CGNet's convolutions and ``conv`` at fp32 without the pin: what the
    port computed before it."""
    pin = common.ieee_fp32_conv
    common.ieee_fp32_conv = contextlib.nullcontext
    try:
        yield
    finally:
        common.ieee_fp32_conv = pin


def cgnet_eval(cgnet, whole01: torch.Tensor, seed: int = 5):
    """-> (mask, gradients of CGNet's parameters in order) of one
    training-mode forward on ``whole01`` (G, H, W, 3) and a seeded
    cotangent on its logits, the classifier's output: every convolution
    lies before the logits. cuDNN is held to its deterministic algorithms
    in the forward too; the TF32 flags are left as the caller set them.
    The pending BatchNorm sums are left as they were."""
    pending = [m.pending for m in cgnet.norms()]
    was_training = cgnet.training
    cgnet.train()
    params = [p for p in cgnet.parameters()]
    logits = []
    hook = cgnet.classifier.register_forward_hook(
        lambda mod, args, out: logits.append(out))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.enable_grad():
            mask = cgnet(whole01)
            g = torch.Generator(device=mask.device).manual_seed(seed)
            cot = torch.randn(logits[0].shape, generator=g,
                              device=mask.device)
            grads = torch.autograd.grad(logits[0], params, cot)
    finally:
        hook.remove()
        torch.backends.cudnn.deterministic = deterministic
    for m, p in zip(cgnet.norms(), pending):
        m.pending = p
    cgnet.train(was_training)
    return mask.detach(), [t.detach() for t in grads]


def max_rel(a, b) -> float:
    """Largest, over the tensors of a and b, of max |a - b| over max |b|."""
    return max(float((x - y).abs().max()) / (float(y.abs().max()) + 1e-30)
               for x, y in zip(a, b))


def trainer(dev):
    cfg = Config(appearance_wh=(224, 160), compute_dtype="bfloat16",
                 grids_per_step=GRIDS, N_vocab=1500)
    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=(112, 84),
                                 appearance_wh=cfg.appearance_wh)
    pipe = TrainPipeline(scene, batch_size=cfg.batch_size)
    torch.manual_seed(0)
    system = CrNerfSystem(cfg).to(dev)
    opt, sched = make_optimizer(cfg, pipe.iterations, system.parameters())
    state = TrainState.create(
        system, opt, cfg.N_vocab, 32, cfg.nerf_out_dim,
        generator=torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(system, opt, sched, grids_per_step=GRIDS,
                           grad_accum_chunks=cfg.resolved_chunks())
    staged = [{k: torch.from_numpy(v).to(dev)
               for k, v in pipe.make_global_batch(0, i, GRIDS).items()}
              for i in range(STAGED)]
    return state, step, staged


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_ab: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}; process flags: cudnn conv "
          f"{torch.backends.cudnn.conv.fp32_precision}, cuda matmul "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    state, step, staged = trainer(dev)
    cgnet = state.system.implicit_mask
    whole01 = (staged[0]["whole_img"][:, 0] + 1.0) / 2.0
    with no_tf32():
        ref = cgnet_eval(cgnet, whole01)
        again = cgnet_eval(cgnet, whole01)
    twice = all(torch.equal(x, y)
                for x, y in zip([ref[0], *ref[1]], [again[0], *again[1]]))
    print(f"CGNet with TF32 off, twice: same bits {twice} (gradients "
          f"{max_rel(again[1], ref[1]):.3e} of the largest apart)")
    for name, ctx in (("pinned", contextlib.nullcontext),
                      ("unpinned", pin_removed)):
        with ctx():
            mask, grads = cgnet_eval(cgnet, whole01)
        same = (torch.equal(mask, ref[0])
                and all(torch.equal(x, y) for x, y in zip(grads, ref[1])))
        print(f"CGNet {name} at the default flags against TF32 off: mask "
              f"{max_rel([mask], [ref[0]]):.3e}, gradients "
              f"{max_rel(grads, ref[1]):.3e} of the largest; same bits "
              f"{same}")
    times = {"pinned": [], "unpinned": []}
    for i in range(WARMUP):
        state, _ = step(state, staged[i % STAGED])
    k = WARMUP
    for name in ("pinned", "unpinned", "unpinned", "pinned"):
        ctx = pin_removed if name == "unpinned" else contextlib.nullcontext
        with ctx():
            for _ in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, staged[k % STAGED])
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
                k += 1
    for name, t in times.items():
        print(f"stash-route step {name}: median {statistics.median(t):.2f} "
              f"ms over {len(t)} steps ({', '.join(f'{x:.2f}' for x in t)})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
