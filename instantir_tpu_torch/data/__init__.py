"""Training data of the port (twin of ``instantir_tpu/data``): blur kernels,
the RealESRGAN degradation and the image-folder datasets."""
