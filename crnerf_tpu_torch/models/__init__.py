"""Network modules of the serving path (torch counterparts of
``crnerf_tpu.models``). Public functions take and return NHWC images."""
