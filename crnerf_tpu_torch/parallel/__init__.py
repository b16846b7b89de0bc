"""Data parallelism over ``torch.distributed`` (``crnerf_tpu/parallel``)."""
