"""Port of instantir_tpu.ops."""
