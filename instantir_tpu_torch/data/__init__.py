"""Training data of the port (twin of ``instantir_tpu/data``): blur kernels,
the RealESRGAN degradation, the image-folder datasets and the face-identity
pair dataset."""
