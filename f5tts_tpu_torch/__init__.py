"""PyTorch/CUDA port of f5tts_tpu for one NVIDIA H100 (Hopper, sm_90a).

Zero-shot inference of F5TTS_v1_Base + Vocos and the DiT training step: the
DiT's attention (forward and backward), AdaLN norm and conv position
embedding run as hand-written CUDA kernels (`csrc/`, built with nvcc at
first use); everything else is PyTorch. The JAX package `f5tts_tpu` is the
reference the port is tested against; this package imports nothing of it
and never imports JAX.
"""
