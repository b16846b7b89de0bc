"""Network modules (torch counterparts of ``crnerf_tpu.models``): those of
the serving and training paths, and the reference zoo's unused ones
(``esrgan``, ``networks``, ``NerfWMLP``, ``NerfTanhMLP``, the decoder's
upsampling blocks, ``appearance.Encoder3`` / ``Decoder3``). Public
functions take and return NHWC images."""
