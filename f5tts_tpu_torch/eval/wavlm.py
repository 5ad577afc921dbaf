"""WavLM, the speaker-verification front end of the SIM scorer (the
semantics of `transformers.WavLMModel` with `do_stable_layer_norm`, which
the JAX package builds at f5tts_tpu/eval/ecapa_tdnn.py:156-171; written
here so the card's machine needs no `transformers`).

    wav [b, l] at 16 kHz
    -> conv feature extractor: 7 convs (512 x (10, 3, 3, 3, 3, 2, 2),
       strides (5, 2, 2, 2, 2, 2, 2)), each LayerNorm over channels, GELU
    -> feature_projection: LayerNorm, Linear to hidden
    -> + GELU(weight-normed grouped positional conv, 128 taps, 16 groups,
       the last frame trimmed)
    -> 24 pre-LN layers: LayerNorm, attention with a gated relative-position
       bias, residual; LayerNorm, GELU feed-forward, residual
    -> final LayerNorm

The relative-position bias is a table of 320 log-spaced buckets (distance
<= 800 frames) held by layer 0; its [b * h, t, t] values pass to the later
layers, and each layer gates them per query row with the GRU-style gate
(a · (b · c − 1) + 2) from `gru_rel_pos_linear` and `gru_rel_pos_const`.
`forward` returns the 25 hidden states `output_hidden_states=True` gives:
the input of each layer, then the last layer's output after the final
LayerNorm. Parameter names are the transformers ones, so a
`transformers.WavLMModel` state dict loads as it is. f32 PyTorch (cuBLAS /
cuDNN on the card): no kernel of the port takes a per-head bias.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class WavLMConfig:
    """WavLM-large by default (microsoft/wavlm-large's shapes)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out)

    def forward(self, x):
        x = self.conv(x)
        return F.gelu(self.layer_norm(x.transpose(1, 2)).transpose(1, 2))


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, cfg.conv_bias)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, wav):  # [b, l] -> [b, c, t]
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _PositionalConv(nn.Module):
    """Grouped conv over time, its weight normed over dim 2 (the
    `parametrizations.weight.original0 / original1` of the checkpoint);
    an even kernel's extra output frame is trimmed."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                         groups=cfg.num_conv_pos_embedding_groups)
        self.conv = nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
        self.trim = 1 if k % 2 == 0 else 0

    def forward(self, x):  # [b, t, d]
        y = self.conv(x.transpose(1, 2))
        if self.trim:
            y = y[:, :, :-self.trim]
        return F.gelu(y).transpose(1, 2)


def relative_position_buckets(t: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """[t, t] bucket of key j for query i: half the buckets a sign, exact
    below a quarter of them, log-spaced up to `max_distance` beyond."""
    pos = torch.arange(t, dtype=torch.long, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    max_exact = half // 2
    large = torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
    large = (max_exact + large * (half - max_exact)).to(torch.long)
    large = torch.clamp(large, max=half - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class _Attention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_bias_table: bool):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.head_dim = h, d // h
        self.num_buckets, self.max_distance = cfg.num_buckets, cfg.max_bucket_distance
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.q_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        if has_bias_table:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, h)

    def position_bias(self, t: int) -> torch.Tensor:
        """[h, t, t] of the bucket table (layer 0's)."""
        idx = relative_position_buckets(t, self.num_buckets, self.max_distance,
                                        self.rel_attn_embed.weight.device)
        return self.rel_attn_embed(idx).permute(2, 0, 1)

    def forward(self, x, bias):  # x [b, t, d] (normed), bias [h, t, t]
        b, t, d = x.shape
        h, dh = self.heads, self.head_dim
        gate_in = x.view(b, t, h, dh).permute(0, 2, 1, 3)                  # [b, h, t, dh]
        g = self.gru_rel_pos_linear(gate_in).view(b, h, t, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(g).chunk(2, dim=-1)                # [b, h, t, 1]
        gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        gated = gate * bias[None]                                         # [b, h, t, t]

        def heads(z):
            return z.view(b, t, h, dh).transpose(1, 2)

        q = heads(self.q_proj(x)) * dh ** -0.5
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        probs = torch.softmax(q @ k.transpose(-1, -2) + gated, dim=-1)
        o = (probs @ v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(o)


class _FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_bias_table: bool):
        super().__init__()
        self.attention = _Attention(cfg, has_bias_table)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, bias):
        x = x + self.attention(self.layer_norm(x), bias)
        return x + self.feed_forward(self.final_layer_norm(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg, i == 0) for i in range(cfg.num_hidden_layers))

    def forward(self, x) -> list[torch.Tensor]:
        x = x + self.pos_conv_embed(x)
        bias = self.layers[0].attention.position_bias(x.shape[1])
        states = []
        for layer in self.layers:
            states.append(x)
            x = layer(x, bias)
        states.append(self.layer_norm(x))
        return states


class WavLM(nn.Module):
    """forward(wav [b, l] at 16 kHz) -> the num_hidden_layers + 1 hidden
    states, each [b, t, hidden] (t = the conv stack's frames, 50 a second)."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.config = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        # the pretraining mask vector: never read at inference, loaded so a
        # checkpoint's every tensor is consumed
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.encoder = _Encoder(cfg)

    def forward(self, wav: torch.Tensor) -> list[torch.Tensor]:
        feats = self.feature_extractor(wav).transpose(1, 2)
        return self.encoder(self.feature_projection(feats))
