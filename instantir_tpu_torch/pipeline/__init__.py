"""Port of instantir_tpu.pipeline."""
