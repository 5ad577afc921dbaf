"""Spectrogram plotting (counterpart of f5tts_tpu/infer/viz.py; the
reference's utils_infer.save_spectrogram). matplotlib is imported when
called."""

from __future__ import annotations

import numpy as np


def save_spectrogram(mel: np.ndarray, path: str) -> None:
    """mel [n_mels, t] log-mel -> PNG at `path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    im = ax.imshow(np.asarray(mel), origin="lower", aspect="auto", interpolation="nearest",
                   cmap="magma")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
