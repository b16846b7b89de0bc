"""Hand-written CUDA kernels and their plain PyTorch versions:
``fused_render`` (encode + NeRF MLP + compositing of one pass, forward and
both backwards), ``fused_mlp`` (encode + NeRF MLP per sample point, forward
and backward) and ``composite`` (alpha compositing alone)."""

from crnerf_tpu_torch.ops.composite import composite_apply  # noqa: F401
from crnerf_tpu_torch.ops.fused_mlp import (  # noqa: F401
    fused_mlp_apply,
    fused_mlp_train,
)
