"""Vocos vocoder: mel [b, 100, t] -> wav [b, (t-1)*hop].

Counterpart of f5tts_tpu/vocoder/vocos.py: embed Conv1d(100 -> dim, k=7),
input LayerNorm, ConvNeXt-v1 blocks (depthwise k7 / LN / pw / exact GELU /
pw / layer-scale gamma), final LayerNorm, a Linear head to n_fft + 2 split
into (log-magnitude | phase), clip(exp(mag), 1e2), then the iSTFT.
Parameters keep the JAX package's layouts (see models/modules.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.ops.stft import hann_window, istft_center
from f5tts_tpu_torch.precision import f32_call
from f5tts_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256


def init_vocos(generator: torch.Generator, cfg: VocosConfig = VocosConfig()) -> m.Params:
    g = generator
    blocks = [{
        "dwconv": m.init_conv1d(g, cfg.dim, cfg.dim, 7, groups=cfg.dim),
        "norm_w": torch.ones(cfg.dim),
        "norm_b": torch.zeros(cfg.dim),
        "pw1": m.init_linear(g, cfg.dim, cfg.intermediate_dim),
        "pw2": m.init_linear(g, cfg.intermediate_dim, cfg.dim),
        "gamma": torch.full((cfg.dim,), 1.0 / cfg.num_layers),
    } for _ in range(cfg.num_layers)]
    return {
        "embed": m.init_conv1d(g, cfg.input_channels, cfg.dim, 7),
        "in_norm_w": torch.ones(cfg.dim),
        "in_norm_b": torch.zeros(cfg.dim),
        "blocks": blocks,
        "final_norm_w": torch.ones(cfg.dim),
        "final_norm_b": torch.zeros(cfg.dim),
        "head": m.init_linear(g, cfg.dim, cfg.n_fft + 2),
    }


def _convnext_v1_block(p: m.Params, x: torch.Tensor) -> torch.Tensor:
    h = m.depthwise_conv1d(p["dwconv"], x, padding=3)
    h = m.layer_norm(h, p["norm_w"], p["norm_b"], eps=1e-6)
    h = m.linear(p["pw2"], m.gelu_exact(m.linear(p["pw1"], h)))
    return x + p["gamma"].to(h.dtype) * h


@f32_call
def vocos_apply(params: m.Params, mel_bnd: torch.Tensor, window: torch.Tensor,
                n_fft: int = 1024, hop: int = 256, dtype=torch.float32) -> torch.Tensor:
    """mel [b, t, n_mels] -> wav [b, (t-1)*hop] (f32), TF32 off
    (`precision.full_f32`)."""
    x = mel_bnd.to(dtype)
    w = params["embed"]["w"].to(dtype)                  # [k, in, out] WIO
    k = w.shape[0]
    x = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=(k - 1) // 2)
    x = x.transpose(1, 2) + params["embed"]["b"].to(dtype)
    x = m.layer_norm(x, params["in_norm_w"], params["in_norm_b"], eps=1e-6)
    for blk in params["blocks"]:
        x = _convnext_v1_block(blk, x)
    x = m.layer_norm(x, params["final_norm_w"], params["final_norm_b"], eps=1e-6)
    h = m.linear(params["head"], x).float()              # [b, t, n_fft + 2]
    mag, phase = h.chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(mag), max=1e2)
    real = (mag * torch.cos(phase)).transpose(1, 2)
    imag = (mag * torch.sin(phase)).transpose(1, 2)
    return istft_center(real, imag, window, n_fft=n_fft, hop=hop)


class Vocos:
    """Callable vocoder on `device`: log-mel [b, n_mels, t] -> wav [b, (t-1)*hop].
    `dtype` is the compute dtype (f32 by default, as in the JAX package).
    For a mel on `device` a call does no host work (the window is made once,
    the iSTFT is device ops), so the pipeline's CUDA graph captures it."""

    def __init__(self, params: m.Params, cfg: VocosConfig = VocosConfig(),
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.params = m.tree_cast(params, dtype, self.device)
        self.cfg = cfg
        self.dtype = dtype
        self.window = hann_window(cfg.n_fft, self.device)

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        return vocos_apply(self.params, mel.to(self.device).transpose(1, 2), self.window,
                           self.cfg.n_fft, self.cfg.hop_length, self.dtype)
