"""Benchmarks of the port (counterparts of f5tts_tpu/eval)."""
