"""PyTorch + CUDA port of crnerf_tpu for NVIDIA Hopper (H100).

The JAX package ``crnerf_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``crnerf_tpu``. Two paths run end to
end.

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
           random-appearance branch), train/losses.py crnerf_loss, backward
           through the fused render backward kernels (from the stash, or
           with Config.pallas_stash=False or Config.pertube_cord=True by
           recomputing the forward slab by slab), train/optim.py
           optimizer and schedule, train/state.py TrainState (embedding
           cache, BatchNorm statistics).

Both take another route through the same entry points when the Config says
so: ``pallas_render=False`` evaluates the MLP per sample point in the fused
MLP kernels (ops/fused_mlp.py) and composites in plain PyTorch
(core/compositing.py), under autograd in training; ``use_pallas=False``
(serving) and ``pallas_train=False`` (training) run the NerfMLP module with
no hand-written kernel.
"""

from crnerf_tpu_torch.config import Config

__all__ = ["Config"]
