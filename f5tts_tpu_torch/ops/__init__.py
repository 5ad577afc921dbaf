"""Kernels and plain PyTorch ops of the port. Importing the package
registers the kernels' `torch.library` operators (`f5tts::...`,
`ops/_operators.py`)."""

from f5tts_tpu_torch.ops import adaln_norm, attention, grouped_conv  # noqa: F401
