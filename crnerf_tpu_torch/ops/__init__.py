"""Hand-written CUDA kernels and their plain PyTorch versions:
``fused_render`` (encode + NeRF MLP + compositing of one pass, forward and
both backwards) and ``composite`` (alpha compositing alone)."""

from crnerf_tpu_torch.ops.composite import composite_apply  # noqa: F401
