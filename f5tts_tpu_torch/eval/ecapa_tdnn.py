"""ECAPA-TDNN speaker embeddings over WavLM-large for SIM (counterpart of
f5tts_tpu/eval/ecapa_tdnn.py; the reference vendors the UniSpeech model at
src/f5_tts/eval/ecapa_tdnn.py and scores with `wavlm_large_finetune.pth`).

- front end: the port's `WavLM` (eval/wavlm.py), built here from a
  `WavLMConfig` (WavLM-large by default) with random weights until a
  checkpoint loads; its 25 hidden states are summed with softmax weights
  after per-utterance input normalisation (zero mean, unit variance);
- conv -> ReLU -> BatchNorm throughout (the checkpoint's order: its BN
  statistics are of the post-ReLU activations);
- a k5 conv, 3 SE-Res2 blocks (dilations 2, 3, 4, scale 8, Linear SE) and
  the MFA concat of their outputs;
- attentive statistics pooling without global context -> BatchNorm ->
  256-dim embedding.

`load_reference_checkpoint` maps the UniSpeech state dict (the fine-tuned
fairseq WavLM under `feature_extract.model.*`) onto this module and raises
unless >= 99% of its tensors are consumed; `to_reference_state_dict` writes
a module's weights back in that layout. No hub call is made.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from f5tts_tpu_torch.eval.wavlm import WavLM, WavLMConfig
from f5tts_tpu_torch.precision import f32_call


class _ConvReluBn(nn.Module):
    """conv -> ReLU -> BatchNorm."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, padding: int = 0,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, padding=padding, dilation=dilation)
        self.bn = nn.BatchNorm1d(c_out)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class _Res2Dilated(nn.Module):
    """Dilated convs over `scale` channel chunks: branch i takes chunk i plus
    branch i - 1's output; the last chunk passes through."""

    def __init__(self, channels: int, kernel: int, dilation: int, scale: int = 8):
        super().__init__()
        assert channels % scale == 0
        self.scale = scale
        width = channels // scale
        pad = dilation * (kernel - 1) // 2
        self.convs = nn.ModuleList([nn.Conv1d(width, width, kernel, padding=pad,
                                              dilation=dilation) for _ in range(scale - 1)])
        self.bns = nn.ModuleList([nn.BatchNorm1d(width) for _ in range(scale - 1)])

    def forward(self, x):
        chunks = torch.chunk(x, self.scale, dim=1)
        outs = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = chunks[i] if sp is None else sp + chunks[i]
            sp = bn(F.relu(conv(sp)))
            outs.append(sp)
        outs.append(chunks[-1])
        return torch.cat(outs, dim=1)


class _SEScale(nn.Module):
    """Squeeze-excitation with Linear layers over the time mean."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(channels, bottleneck)
        self.fc2 = nn.Linear(bottleneck, channels)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=2)))))
        return x * s.unsqueeze(2)


class SERes2Block(nn.Module):
    def __init__(self, channels: int, kernel: int, dilation: int, scale: int = 8,
                 se_bottleneck: int = 128):
        super().__init__()
        self.pre = _ConvReluBn(channels, channels, 1)
        self.res2 = _Res2Dilated(channels, kernel, dilation, scale)
        self.post = _ConvReluBn(channels, channels, 1)
        self.se = _SEScale(channels, se_bottleneck)

    def forward(self, x):
        return x + self.se(self.post(self.res2(self.pre(x))))


class AttentiveStatsPooling(nn.Module):
    """Attention-weighted mean and std over time (tanh attention, no global
    context)."""

    def __init__(self, channels: int, att_dim: int = 128):
        super().__init__()
        self.att_in = nn.Conv1d(channels, att_dim, 1)
        self.att_out = nn.Conv1d(att_dim, channels, 1)

    def forward(self, x):
        alpha = torch.softmax(self.att_out(torch.tanh(self.att_in(x))), dim=2)
        mean = (alpha * x).sum(dim=2)
        var = (alpha * x * x).sum(dim=2) - mean * mean
        std = torch.sqrt(var.clamp(min=1e-9))
        return torch.cat([mean, std], dim=1)


class ECAPA_TDNN(nn.Module):
    """forward(wav [b, l] at 16 kHz) -> embedding [b, emb_dim]."""

    def __init__(self, feat_dim: int = 1024, channels: int = 512, emb_dim: int = 256,
                 feat_type: str = "wavlm_large", num_feature_layers: Optional[int] = None,
                 wavlm_config: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.feat_type = feat_type
        layers = num_feature_layers or wavlm_config.num_hidden_layers + 1
        self.feature_weight = nn.Parameter(torch.zeros(layers))
        self.instance_norm = nn.InstanceNorm1d(feat_dim)
        self.wavlm = WavLM(wavlm_config).eval()

        cat = channels * 3
        self.layer1 = _ConvReluBn(feat_dim, channels, 5, padding=2)
        self.layer2 = SERes2Block(channels, 3, dilation=2)
        self.layer3 = SERes2Block(channels, 3, dilation=3)
        self.layer4 = SERes2Block(channels, 3, dilation=4)
        self.mfa = nn.Conv1d(cat, cat, 1)
        self.pool = AttentiveStatsPooling(cat)
        self.pool_bn = nn.BatchNorm1d(cat * 2)
        self.fc = nn.Linear(cat * 2, emb_dim)

    def _features(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [b, l] -> [b, feat_dim, t]: the softmax-weighted sum of WavLM's
        hidden states of the normalised wav."""
        wav = (wav - wav.mean(dim=-1, keepdim=True)) / torch.sqrt(
            wav.var(dim=-1, keepdim=True, unbiased=False) + 1e-7)
        with torch.no_grad():
            states = torch.stack(self.wavlm(wav), dim=0)                  # [L, b, t, d]
        w = torch.softmax(self.feature_weight, dim=0)[:, None, None, None]
        feat = (states * w).sum(dim=0)
        return feat.transpose(1, 2) + 1e-6

    @f32_call
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.instance_norm(self._features(wav))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        x = F.relu(self.mfa(torch.cat([x2, x3, x4], dim=1)))
        return self.fc(self.pool_bn(self.pool(x)))


def ECAPA_TDNN_SMALL(feat_dim: int = 1024, feat_type: str = "wavlm_large",
                     wavlm_config: WavLMConfig = WavLMConfig()) -> ECAPA_TDNN:
    """The reference harness's constructor: 512 channels, 256-dim output."""
    return ECAPA_TDNN(feat_dim=feat_dim, channels=512, emb_dim=256, feat_type=feat_type,
                      wavlm_config=wavlm_config)


# ---------------------------------------------------------------------------
# Checkpoint keys (UniSpeech wavlm_large_finetune.pth <-> this module)
# ---------------------------------------------------------------------------

# the ECAPA head: checkpoint name -> this module's
_HEAD_RULES = [
    (r"^feature_weight$", "feature_weight"),
    (r"^layer1\.conv\.(.*)$", r"layer1.conv.\1"),
    (r"^layer1\.bn\.(.*)$", r"layer1.bn.\1"),
    (r"^layer([234])\.Conv1dReluBn1\.(conv|bn)\.(.*)$", r"layer\1.pre.\2.\3"),
    (r"^layer([234])\.Res2Conv1dReluBn\.(convs|bns)\.(\d+)\.(.*)$", r"layer\1.res2.\2.\3.\4"),
    (r"^layer([234])\.Conv1dReluBn2\.(conv|bn)\.(.*)$", r"layer\1.post.\2.\3"),
    (r"^layer([234])\.SE_Connect\.linear1\.(.*)$", r"layer\1.se.fc1.\2"),
    (r"^layer([234])\.SE_Connect\.linear2\.(.*)$", r"layer\1.se.fc2.\2"),
    (r"^conv\.(.*)$", r"mfa.\1"),
    (r"^pooling\.linear1\.(.*)$", r"pool.att_in.\1"),
    (r"^pooling\.linear2\.(.*)$", r"pool.att_out.\1"),
    (r"^bn\.(.*)$", r"pool_bn.\1"),
    (r"^linear\.(.*)$", r"fc.\1"),
]

# the WavLM front end: fairseq (`feature_extract.model.*`) -> the
# transformers names `eval/wavlm.py` keeps (the official conversion's map)
_WAVLM_RULES = [
    (r"^post_extract_proj\.(.*)$", r"feature_projection.projection.\1"),
    (r"^layer_norm\.(.*)$", r"feature_projection.layer_norm.\1"),
    (r"^feature_extractor\.conv_layers\.(\d+)\.0\.(.*)$",
     r"feature_extractor.conv_layers.\1.conv.\2"),
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\.(.*)$",
     r"feature_extractor.conv_layers.\1.layer_norm.\2"),
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.(.*)$",
     r"feature_extractor.conv_layers.\1.layer_norm.\2"),
    (r"^encoder\.pos_conv\.0\.(.*)$", r"encoder.pos_conv_embed.conv.\1"),
    (r"^encoder\.layer_norm\.(.*)$", r"encoder.layer_norm.\1"),
    (r"^encoder\.layers\.(\d+)\.self_attn\.relative_attention_bias\.(.*)$",
     r"encoder.layers.\1.attention.rel_attn_embed.\2"),
    (r"^encoder\.layers\.(\d+)\.self_attn\.grep_linear\.(.*)$",
     r"encoder.layers.\1.attention.gru_rel_pos_linear.\2"),
    (r"^encoder\.layers\.(\d+)\.self_attn\.grep_a$",
     r"encoder.layers.\1.attention.gru_rel_pos_const"),
    (r"^encoder\.layers\.(\d+)\.self_attn\.([kqv]_proj|out_proj)\.(.*)$",
     r"encoder.layers.\1.attention.\2.\3"),
    (r"^encoder\.layers\.(\d+)\.self_attn_layer_norm\.(.*)$",
     r"encoder.layers.\1.layer_norm.\2"),
    (r"^encoder\.layers\.(\d+)\.fc1\.(.*)$",
     r"encoder.layers.\1.feed_forward.intermediate_dense.\2"),
    (r"^encoder\.layers\.(\d+)\.fc2\.(.*)$",
     r"encoder.layers.\1.feed_forward.output_dense.\2"),
    (r"^encoder\.layers\.(\d+)\.final_layer_norm\.(.*)$",
     r"encoder.layers.\1.final_layer_norm.\2"),
    (r"^mask_emb$", "masked_spec_embed"),
]

# this module's names -> the checkpoint's (the two tables above inverted)
_HEAD_INV = [
    (r"^layer([234])\.pre\.(conv|bn)\.(.*)$", r"layer\1.Conv1dReluBn1.\2.\3"),
    (r"^layer([234])\.res2\.(convs|bns)\.(\d+)\.(.*)$", r"layer\1.Res2Conv1dReluBn.\2.\3.\4"),
    (r"^layer([234])\.post\.(conv|bn)\.(.*)$", r"layer\1.Conv1dReluBn2.\2.\3"),
    (r"^layer([234])\.se\.fc1\.(.*)$", r"layer\1.SE_Connect.linear1.\2"),
    (r"^layer([234])\.se\.fc2\.(.*)$", r"layer\1.SE_Connect.linear2.\2"),
    (r"^mfa\.(.*)$", r"conv.\1"),
    (r"^pool\.att_in\.(.*)$", r"pooling.linear1.\1"),
    (r"^pool\.att_out\.(.*)$", r"pooling.linear2.\1"),
    (r"^pool_bn\.(.*)$", r"bn.\1"),
    (r"^fc\.(.*)$", r"linear.\1"),
    (r"^(feature_weight|layer1\..*)$", r"\1"),
]
_WAVLM_INV = [
    (r"^feature_projection\.projection\.(.*)$", r"post_extract_proj.\1"),
    (r"^feature_projection\.layer_norm\.(.*)$", r"layer_norm.\1"),
    (r"^feature_extractor\.conv_layers\.(\d+)\.conv\.(.*)$",
     r"feature_extractor.conv_layers.\1.0.\2"),
    (r"^feature_extractor\.conv_layers\.(\d+)\.layer_norm\.(.*)$",
     r"feature_extractor.conv_layers.\1.2.1.\2"),
    (r"^encoder\.pos_conv_embed\.conv\.parametrizations\.weight\.original0$",
     "encoder.pos_conv.0.weight_g"),
    (r"^encoder\.pos_conv_embed\.conv\.parametrizations\.weight\.original1$",
     "encoder.pos_conv.0.weight_v"),
    (r"^encoder\.pos_conv_embed\.conv\.bias$", "encoder.pos_conv.0.bias"),
    (r"^encoder\.layers\.(\d+)\.attention\.rel_attn_embed\.(.*)$",
     r"encoder.layers.\1.self_attn.relative_attention_bias.\2"),
    (r"^encoder\.layers\.(\d+)\.attention\.gru_rel_pos_linear\.(.*)$",
     r"encoder.layers.\1.self_attn.grep_linear.\2"),
    (r"^encoder\.layers\.(\d+)\.attention\.gru_rel_pos_const$",
     r"encoder.layers.\1.self_attn.grep_a"),
    (r"^encoder\.layers\.(\d+)\.attention\.([kqv]_proj|out_proj)\.(.*)$",
     r"encoder.layers.\1.self_attn.\2.\3"),
    (r"^encoder\.layers\.(\d+)\.layer_norm\.(.*)$",
     r"encoder.layers.\1.self_attn_layer_norm.\2"),
    (r"^encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense\.(.*)$",
     r"encoder.layers.\1.fc1.\2"),
    (r"^encoder\.layers\.(\d+)\.feed_forward\.output_dense\.(.*)$",
     r"encoder.layers.\1.fc2.\2"),
    (r"^encoder\.layers\.(\d+)\.final_layer_norm\.(.*)$",
     r"encoder.layers.\1.final_layer_norm.\2"),
    (r"^encoder\.layer_norm\.(.*)$", r"encoder.layer_norm.\1"),
    (r"^masked_spec_embed$", "mask_emb"),
]

# pretraining-only tensors the speaker model never uses: dropped
_WAVLM_DROP = re.compile(r"^(label_embs_concat|final_proj\.|project_q\.|quantizer\.|target_glu\.)")


def _apply_rules(key: str, rules) -> str | None:
    for pat, repl in rules:
        if re.match(pat, key):
            return re.sub(pat, repl, key)
    return None


def convert_reference_state_dict(state: dict) -> tuple[dict, dict, list, list]:
    """Split and rename the UniSpeech checkpoint: (head state dict, WavLM
    state dict, dropped keys, unmapped keys)."""
    head, wavlm, dropped, unmapped = {}, {}, [], []
    for key, tensor in state.items():
        if key.startswith("feature_extract."):
            sub = key[len("feature_extract."):]
            if sub.startswith("model."):
                sub = sub[len("model."):]
            if _WAVLM_DROP.match(sub):
                dropped.append(key)
                continue
            new = _apply_rules(sub, _WAVLM_RULES)
            if new is None:
                unmapped.append(key)
            else:
                wavlm[new] = tensor
        else:
            new = _apply_rules(key, _HEAD_RULES)
            if new is None:
                unmapped.append(key)
            else:
                head[new] = tensor
    return head, wavlm, dropped, unmapped


def to_reference_state_dict(model: ECAPA_TDNN) -> dict:
    """The module's weights in the UniSpeech layout (fairseq WavLM keys under
    `feature_extract.model.*`, the pos conv as weight_g / weight_v), CPU
    tensors: what `load_reference_checkpoint` reads."""
    out = {}
    for k, v in model.state_dict().items():
        if k.startswith("wavlm."):
            out["feature_extract.model." + _apply_rules(k[len("wavlm."):], _WAVLM_INV)] = v.cpu()
        else:
            out[_apply_rules(k, _HEAD_INV)] = v.cpu()
    return out


def _adapt_weight_norm_keys(sd: dict, target_keys: set) -> dict:
    """pos conv weight_g / weight_v -> the parametrizations names."""
    out = dict(sd)
    for old, new_suffix in (("weight_g", "parametrizations.weight.original0"),
                            ("weight_v", "parametrizations.weight.original1")):
        key = f"encoder.pos_conv_embed.conv.{old}"
        alt = f"encoder.pos_conv_embed.conv.{new_suffix}"
        if key in out and key not in target_keys and alt in target_keys:
            out[alt] = out.pop(key)
    return out


def load_reference_checkpoint(model: ECAPA_TDNN, ckpt_path: str,
                              min_mapped_frac: float = 0.99) -> dict:
    """Load `wavlm_large_finetune.pth` into `model` with strict accounting:
    raises RuntimeError unless >= `min_mapped_frac` of the checkpoint's
    (non-dropped) tensors land in a parameter or buffer. Returns total,
    consumed, frac, dropped, unmapped, unexpected and missing."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state = state.get("model", state)
    head, wavlm, dropped, unmapped = convert_reference_state_dict(state)
    wavlm = _adapt_weight_norm_keys(wavlm, set(model.wavlm.state_dict().keys()))

    missing_h, unexpected_h = model.load_state_dict(head, strict=False)
    missing_w, unexpected_w = model.wavlm.load_state_dict(wavlm, strict=False)

    total = len(state) - len(dropped)
    consumed = len(head) - len(unexpected_h) + len(wavlm) - len(unexpected_w)
    frac = consumed / max(total, 1)
    stats = {
        "total": total, "consumed": consumed, "frac": frac,
        "dropped": dropped, "unmapped": unmapped,
        "unexpected": list(unexpected_h) + list(unexpected_w),
        "missing": [k for k in missing_h if not k.startswith("wavlm.")] + list(missing_w),
    }
    if frac < min_mapped_frac:
        raise RuntimeError(
            f"SIM checkpoint mapping consumed only {consumed}/{total} tensors "
            f"({frac:.1%}); refusing to score with unmapped weights. "
            f"unmapped={unmapped[:8]} unexpected={stats['unexpected'][:8]}")
    return stats
