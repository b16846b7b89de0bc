"""PyTorch + CUDA port of crnerf_tpu for NVIDIA Hopper (H100).

The JAX package ``crnerf_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``crnerf_tpu``. Two paths run end to
end, and the command line drives both (``python -m crnerf_tpu_torch
{prepare,train,eval,metrics,video,serve}``, the JAX package's commands).

Serving:

    apps/serve.py RenderService.handle
      -> render/inference.py Renderer (camera in, rays on the device, u8 out)
      -> render/system.py CrNerfSystem.forward_eval
           appearance encoder + CGNet mask, coarse and fine passes through
           the fused render kernel (ops/fused_render.py, csrc/), StyleNet
           decode.

Training:

    data/pipeline.py TrainPipeline.make_global_batch (numpy, G grids)
      -> train/step.py make_train_step(state, batch)
           render/system.py CrNerfSystem.forward_train (stochastic renderer
           through the fused render forward with its activation stash, the
           random-appearance branch, with Config.encode_c the content
           heads), train/losses.py crnerf_loss, backward
           through the fused render backward kernels (from the stash, or
           with Config.pallas_stash=False or Config.pertube_cord=True by
           recomputing the forward slab by slab), train/optim.py
           optimizer (Adam, SGD, RAdam, Ranger) and schedule,
           train/state.py TrainState (embedding cache, BatchNorm
           statistics).

From the command line: apps/train.py -> train/loop.py Trainer (epochs of
TrainPipeline.epoch_batches through make_train_step, validation through
the Renderer with PSNR and SSIM, checkpoints of the whole state in
utils/checkpoint.py, weights.npz beside them, a graceful stop on SIGTERM
and an exact resume, training-grid panels and a profiler window);
apps/eval.py renders a split, or a scene preset's camera path
(render/camera_path.py) and its GIF, to PNGs from a weights.npz;
apps/video.py renders the camera path in the appearance of each image of a
folder; apps/eval_metric.py scores saved renders (LPIPS through
eval/lpips.py where its weights file is); apps/prepare.py turns a
phototourism scene into the npz cache (data/phototourism.py) that training
reads; data/blender.py loads a Blender scene. Images go in and out through
the standard-library codecs of utils/png.py (PNG), utils/lanczos.py (PIL's
Lanczos resize) and utils/visualization.py (GIF), so the card needs no
image library.

Both take another route through the same entry points when the Config says
so: ``pallas_render=False`` evaluates the MLP per sample point in the fused
MLP kernels (ops/fused_mlp.py) and composites in plain PyTorch
(core/compositing.py), under autograd in training; ``use_pallas=False``
(serving) and ``pallas_train=False`` (training) run the NerfMLP module with
no hand-written kernel.
"""

from crnerf_tpu_torch.config import Config

__all__ = ["Config"]
