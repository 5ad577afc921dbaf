"""UTMOS22-strong MOS predictor, loaded from a file (counterpart of
f5tts_tpu/eval/utmos22.py; the reference scores through
`torch.hub.load("tarepan/SpeechMOS", "utmos22_strong")`, which needs the
network at every run).

    wav2vec2-base SSL front end (7-layer conv feature extractor, feature
    projection, 128-tap grouped positional conv, 12 post-LN transformer
    layers) -> concat(features, domain embedding, judge embedding) ->
    BiLSTM(512) -> projection head (2048 -> 1) -> mean over time * 2 + 3.

f32 PyTorch on whatever device the module is moved to (cuDNN's LSTM and
convolutions, cuBLAS, `F.scaled_dot_product_attention` on the card); a wav
at another rate than 16 kHz is resampled with scipy's `resample_poly` on
the host first. `load_checkpoint` reads a state dict of the hub module (or
of this one) through a regex key map, folds weight-norm pairs, and raises
unless >= 99% of the checkpoint's tensors are consumed and every parameter
is filled.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SSL_DIM = 768
EMB_DIM = 128
LSTM_HIDDEN = 512


# ---------------------------------------------------------------------------
# wav2vec2-base SSL frontend
# ---------------------------------------------------------------------------

class _ConvFeatureExtractor(nn.Module):
    """7 strided conv layers: (512,k10,s5) + 4x(512,k3,s2) + 2x(512,k2,s2);
    group-norm after the first conv, GELU everywhere; 16 kHz -> 50 Hz."""

    def __init__(self):
        super().__init__()
        specs = [(10, 5)] + [(3, 2)] * 4 + [(2, 2)] * 2
        self.conv_layers = nn.ModuleList()
        c_in = 1
        for i, (k, s) in enumerate(specs):
            layer = nn.Module()
            layer.conv = nn.Conv1d(c_in, 512, k, stride=s, bias=False)
            layer.layer_norm = nn.GroupNorm(512, 512) if i == 0 else None
            self.conv_layers.append(layer)
            c_in = 512

    def forward(self, x):  # [B, T] -> [B, frames, 512]
        x = x.unsqueeze(1)
        for layer in self.conv_layers:
            x = layer.conv(x)
            if layer.layer_norm is not None:
                x = layer.layer_norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


class _EncoderLayer(nn.Module):
    """Post-LN transformer layer (wav2vec2-base convention)."""

    def __init__(self, dim=SSL_DIM, heads=12, ffn=3072):
        super().__init__()
        self.attention = nn.Module()
        self.attention.k_proj = nn.Linear(dim, dim)
        self.attention.v_proj = nn.Linear(dim, dim)
        self.attention.q_proj = nn.Linear(dim, dim)
        self.attention.out_proj = nn.Linear(dim, dim)
        self.layer_norm = nn.LayerNorm(dim)
        self.feed_forward = nn.Module()
        self.feed_forward.intermediate_dense = nn.Linear(dim, ffn)
        self.feed_forward.output_dense = nn.Linear(ffn, dim)
        self.final_layer_norm = nn.LayerNorm(dim)
        self.heads = heads

    def forward(self, x):
        b, t, d = x.shape
        h = self.heads

        def split(z):
            return z.view(b, t, h, d // h).transpose(1, 2)

        a = self.attention
        q, k, v = split(a.q_proj(x)), split(a.k_proj(x)), split(a.v_proj(x))
        o = F.scaled_dot_product_attention(q, k, v)
        o = a.out_proj(o.transpose(1, 2).reshape(b, t, d))
        x = self.layer_norm(x + o)
        f = self.feed_forward
        y = f.output_dense(F.gelu(f.intermediate_dense(x)))
        return self.final_layer_norm(x + y)


class _Encoder(nn.Module):
    def __init__(self, layers=12):
        super().__init__()
        self.feature_projection = nn.Module()
        self.feature_projection.layer_norm = nn.LayerNorm(512)
        self.feature_projection.projection = nn.Linear(512, SSL_DIM)
        self.pos_conv_embed = nn.Module()
        # 128-tap grouped conv positional embedding (weight-normed in the
        # original; the loader folds weight_g/weight_v into a plain weight)
        self.pos_conv_embed.conv = nn.Conv1d(SSL_DIM, SSL_DIM, 128, padding=64,
                                             groups=16)
        self.layer_norm = nn.LayerNorm(SSL_DIM)
        self.layers = nn.ModuleList([_EncoderLayer() for _ in range(layers)])

    def forward(self, feats):
        x = self.feature_projection.projection(
            self.feature_projection.layer_norm(feats))
        pos = self.pos_conv_embed.conv(x.transpose(1, 2))[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return x


class _Wav2Vec2(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature_extractor = _ConvFeatureExtractor()
        self.encoder = _Encoder()

    def forward(self, wave):
        return self.encoder(self.feature_extractor(wave))


# ---------------------------------------------------------------------------
# UTMOS22 strong head
# ---------------------------------------------------------------------------

class UTMOS22Strong(nn.Module):
    """SSL features + fixed domain/judge embeddings + BiLSTM + linear head.

    forward(wave [B, T], sr) -> MOS [B] in ~[1, 5]. Resamples to 16 kHz
    (scipy polyphase) when sr != 16000.
    """

    def __init__(self):
        super().__init__()
        self.wav2vec2 = _Wav2Vec2()
        self.domain_emb = nn.Parameter(torch.zeros(EMB_DIM))
        self.judge_emb = nn.Parameter(torch.zeros(EMB_DIM))
        self.blstm = nn.LSTM(SSL_DIM + 2 * EMB_DIM, LSTM_HIDDEN,
                             batch_first=True, bidirectional=True)
        self.projection = nn.Sequential(
            nn.Linear(2 * LSTM_HIDDEN, 2048), nn.ReLU(), nn.Linear(2048, 1))

    @torch.no_grad()
    def forward(self, wave: torch.Tensor, sr: int) -> torch.Tensor:
        if sr != 16000:
            from scipy.signal import resample_poly
            from math import gcd

            g = gcd(int(sr), 16000)
            res = resample_poly(wave.cpu().numpy(), 16000 // g, int(sr) // g,
                                axis=-1)
            wave = torch.from_numpy(np.ascontiguousarray(res)).to(wave.device,
                                                                  torch.float32)
        feats = self.wav2vec2(wave)
        b, t, _ = feats.shape
        dom = self.domain_emb.view(1, 1, -1).expand(b, t, -1)
        jud = self.judge_emb.view(1, 1, -1).expand(b, t, -1)
        x = torch.cat([feats, dom, jud], dim=-1)
        y, _ = self.blstm(x)
        score = self.projection(y).mean(dim=1).squeeze(-1)
        return score * 2.0 + 3.0


# ---------------------------------------------------------------------------
# Strict checkpoint loader
# ---------------------------------------------------------------------------

# regex -> replacement, applied in order, mapping known hub/torchaudio-style
# key spellings onto this module's names. Identity mapping covers a
# state_dict saved from this module or from the hub module when names align.
_KEY_MAPS = [
    (r"^model\.", ""),
    (r"^ssl_model\.", "wav2vec2."),
    (r"\.transformer\.layers\.", ".layers."),
    (r"\.encoder\.layers\.", ".encoder.layers."),
    (r"\.self_attn\.", ".attention."),
    (r"\.fc1\.", ".feed_forward.intermediate_dense."),
    (r"\.fc2\.", ".feed_forward.output_dense."),
    (r"\.post_extract_proj\.", ".encoder.feature_projection.projection."),
    (r"^domain_emb\.weight$", "domain_emb"),
    (r"^judge_emb\.weight$", "judge_emb"),
]


def _map_key(k: str) -> str:
    for pat, rep in _KEY_MAPS:
        k = re.sub(pat, rep, k)
    return k


def load_checkpoint(model: UTMOS22Strong, path: str) -> dict:
    """Load a saved utmos22_strong state dict with strict accounting.

    Returns {"consumed": n, "total": n_ckpt, "filled": n_params}. Raises
    RuntimeError if <99% of checkpoint tensors were consumed or any model
    parameter was left unfilled — never scores with silently-dropped weights.
    """
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]

    # fold weight-norm pairs (weight_g, weight_v) -> weight
    folded = {}
    gkeys = [k for k in sd if k.endswith("weight_g")]
    for gk in gkeys:
        vk = gk[:-1] + "v"
        base = gk[: -len(".weight_g")] + ".weight"
        g, v = sd[gk].float(), sd[vk].float()
        norm = v.norm(dim=(0, 1), keepdim=True) if v.ndim == 3 else v.norm()
        folded[base] = g * v / norm
    consumed_raw = set()
    for gk in gkeys:
        consumed_raw.update((gk, gk[:-1] + "v"))

    target = dict(model.named_parameters()) | dict(model.named_buffers())
    filled, unconsumed = set(), []
    for k, v in list(sd.items()) + list(folded.items()):
        if k in consumed_raw:
            continue
        mk = _map_key(k)
        # The SpeechMOS hub module stores domain/judge embeddings as full
        # nn.Embedding TABLES ([num_domains, 128] / [num_judges, 128]); its
        # predictor scores with domain id 0 ("main") and judge id 288 (the
        # mean listener). Select that row for this module's fixed vector.
        if (mk in ("domain_emb", "judge_emb") and v.ndim == 2
                and v.shape[1] == EMB_DIM):
            row = 0 if mk == "domain_emb" else 288
            if v.shape[0] <= row:
                raise RuntimeError(
                    f"utmos22 loader: {k} table has {v.shape[0]} rows, "
                    f"expected mean-listener row {row} to exist")
            v = v[row]
        if mk in target and tuple(target[mk].shape) == tuple(v.shape):
            with torch.no_grad():
                target[mk].copy_(v.to(target[mk].dtype))
            filled.add(mk)
        elif k in folded or k in sd:
            unconsumed.append(k)

    total = len(sd) + len(folded)
    consumed = total - len(unconsumed)
    if consumed < 0.99 * total:
        raise RuntimeError(
            f"utmos22 loader consumed only {consumed}/{total} tensors; "
            f"first unconsumed: {unconsumed[:10]}")
    missing = [k for k in target if k not in filled]
    if missing:
        raise RuntimeError(
            f"utmos22 loader left {len(missing)} params unfilled: "
            f"{missing[:10]}")
    return {"consumed": consumed, "total": total, "filled": len(filled)}


def load_predictor(path: str) -> UTMOS22Strong:
    model = UTMOS22Strong().eval()
    load_checkpoint(model, path)
    return model
