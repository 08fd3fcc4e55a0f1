"""Posit quantization policy and post-training quantization."""
