"""Port of instantir_tpu.models."""
