"""PyTorch + CUDA port of crnerf_tpu for NVIDIA Hopper (H100).

The JAX package ``crnerf_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, ``flax`` or ``crnerf_tpu``. The serving path runs end to end:

    apps/serve.py RenderService.handle
      -> render/inference.py Renderer (camera in, rays on the device, u8 out)
      -> render/system.py CrNerfSystem.forward_eval
           appearance encoder + CGNet mask, coarse and fine passes through
           the fused render kernel (ops/fused_render.py, csrc/), StyleNet
           decode.
"""

from crnerf_tpu_torch.config import Config

__all__ = ["Config"]
