"""Port of instantir_tpu.schedulers."""
