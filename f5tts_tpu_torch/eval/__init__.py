"""Evaluation and benchmarks of the port (counterparts of f5tts_tpu/eval):
test-set generation, the WER / SIM / UTMOS scorers, the RTF, serving and
scaling benchmarks."""
