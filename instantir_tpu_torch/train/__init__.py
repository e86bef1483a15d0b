"""Trainers of the port (twin of ``instantir_tpu/train``)."""
