"""Ray, sampling, encoding and compositing math (torch counterparts of
``crnerf_tpu.core``)."""
