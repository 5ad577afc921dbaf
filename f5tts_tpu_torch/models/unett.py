"""UNetT backbone, the flat UNet transformer of E2-TTS (counterpart of
f5tts_tpu/models/unett.py:32-223).

- The time embedding is prepended to the sequence as a token, and the
  sequence is padded to a multiple of 128 rows; both are stripped at the
  end. Attention masks the pad rows through `lengths + 1`.
- Pre-norm blocks with RMSNorm (eps 1e-8, kernel K6; K6Q hands int8
  projections its rows quantized): x = attn(norm(x)) + x,
  x = ff(norm(x)) + x. Attention is K3 up to 4096 rows and K7 past them,
  and K7 at every n under qk-norm (`modules.self_attention`).
- The first half's pre-block states are the skip stack; the second half
  reads them back in reverse and merges them: "concat" as
  x @ W[:d] + skip @ W[d:] (no [b, n, 2d] concat), "add", or "none".
- Text and input embeddings are the DiT's in their UNetT forms: no
  per-sample lengths, conv position over every row.
- Training (`cfm_loss`) passes per-sample [b] bool `drop_audio_cond` /
  `drop_text`; autograd runs through the attention kernels' backwards (K4,
  or K9 past the flat gate), K6's f32 formula and the split skip matmul.
The JAX package stacks each half on a leading depth axis for `lax.scan`;
here each half is a Python list of block dicts (`convert.py` unstacks).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.config import ModelArch
from f5tts_tpu_torch.models import dit
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models import remat
from f5tts_tpu_torch.ops.rope import precompute_freqs_cis, rope_flat_tables, rope_freqs_interleaved

TEXT_PRECOMPUTE_MAX_POS = 4096  # reference unett.py:46
# RoPE rows: the JAX package's table stops at 4096, short of the 4224 rows of
# a 4096-frame request (time token + padding); the port's table covers them
ROPE_MAX_POS = 8192
RMS_EPS = 1e-8


def init_unett(generator: torch.Generator, arch: ModelArch) -> m.Params:
    """Random UNetT parameters from `generator` (on the CPU, f32)."""
    if arch.depth % 2:
        raise ValueError("UNetT depth must be even")
    g = generator

    def block(later_half: bool) -> m.Params:
        blk = {"attn_norm": m.init_rms_norm(arch.dim),
               "attn": m.init_attention(g, arch.dim, arch.heads, arch.dim_head, arch.qk_norm),
               "ff_norm": m.init_rms_norm(arch.dim),
               "ff": m.init_feed_forward(g, arch.dim, arch.ff_mult)}
        if later_half and arch.skip_connect_type == "concat":
            blk["skip_proj"] = m.init_linear(g, 2 * arch.dim, arch.dim, bias=False)
        return blk

    half = arch.depth // 2
    return {
        "time_embed": m.init_timestep_embedding(g, arch.dim),
        "text_embed": dit.init_text_embedding(g, arch),
        "input_embed": dit.init_input_embedding(g, arch),
        "first_half": [block(False) for _ in range(half)],
        "second_half": [block(True) for _ in range(half)],
        "norm_out": m.init_rms_norm(arch.dim),
        "proj_out": m.init_linear(g, arch.dim, arch.mel_dim),
    }


class UNetTStatics:
    """Constant tables (text position table, RoPE angles) on `device`."""

    def __init__(self, arch: ModelArch, device=None):
        if arch.depth % 2:
            raise ValueError("UNetT depth must be even")
        self.arch = arch
        text_dim = arch.text_dim or arch.mel_dim
        self.text_freqs_cis = precompute_freqs_cis(text_dim, TEXT_PRECOMPUTE_MAX_POS).to(device)
        self.rope_angles = rope_freqs_interleaved(arch.dim_head, ROPE_MAX_POS).to(device)


def unett_text_embeds(params: m.Params, statics: UNetTStatics, text: torch.Tensor, n: int,
                      dtype=torch.float32) -> tuple:
    """(cond, uncond) text embeddings [b, n, text_dim]: no per-sample length."""
    return tuple(dit.text_embedding(params["text_embed"], statics, text, n, lengths=None,
                                    drop_text=drop, dtype=dtype) for drop in (False, True))


def _block(blk: m.Params, x: torch.Tensor, statics: UNetTStatics, rope_tabs: tuple,
           lengths: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    arch = statics.arch
    if skip is not None:
        if arch.skip_connect_type == "concat":
            w = blk["skip_proj"]["w"]
            d = x.shape[-1]
            x = x @ w[:d].to(x.dtype) + skip @ w[d:].to(x.dtype)
            if "b" in blk["skip_proj"]:
                x = x + blk["skip_proj"]["b"].to(x.dtype)
        elif arch.skip_connect_type == "add":
            x = x + skip
    h = m.rms_norm(blk["attn_norm"], x, RMS_EPS, m.attention_inputs(blk["attn"]))
    x = m.self_attention(blk["attn"], h, arch.heads, rope_tabs, lengths, statics.rope_angles,
                         arch.pe_attn_head) + x
    h = m.rms_norm(blk["ff_norm"], x, RMS_EPS, [blk["ff"]["in"]])
    return m.feed_forward(blk["ff"], h) + x


def unett_forward(params: m.Params, statics: UNetTStatics, x: torch.Tensor,
                  cond: torch.Tensor, text: torch.Tensor, time: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None, drop_audio_cond=False,
                  drop_text=False, cfg_infer: bool = False,
                  text_embeds: Optional[tuple] = None, dtype=torch.float32) -> torch.Tensor:
    """Flow prediction [b, n, mel] (f32); with cfg_infer, [2b, n, mel]: cond
    rows then uncond rows (the uncond rows drop the audio cond and the text).
    `drop_audio_cond` / `drop_text` (without cfg_infer): bools or [b] bool
    tensors. `params` must hold the fused to_qkv (`fuse_backbone_qkv`)."""
    arch = statics.arch
    b, n, _ = x.shape
    if time.dim() == 0:
        time = time.expand(b)
    t_emb = m.timestep_embedding(params["time_embed"], time, dtype=dtype)
    x = x.to(dtype)
    cond = cond.to(dtype)
    ip = params["input_embed"]

    if cfg_infer:
        te_c, te_u = (text_embeds if text_embeds is not None
                      else unett_text_embeds(params, statics, text, n, dtype))
        h = torch.cat([dit.input_embedding(ip, x, cond, te_c, False),
                       dit.input_embedding(ip, x, cond, te_u, True)], dim=0)
        t_emb = torch.cat([t_emb, t_emb], dim=0)
        lengths = torch.cat([lengths, lengths]) if lengths is not None else None
    else:
        if text_embeds is None:
            te = dit.text_embedding(params["text_embed"], statics, text, n, lengths=None,
                                    drop_text=drop_text, dtype=dtype)
        else:
            te = text_embeds[1] if drop_text is True else text_embeds[0]
        h = dit.input_embedding(ip, x, cond, te, drop_audio_cond)

    # the time token, then padding to a multiple of 128 rows; the pad rows
    # are masked out of every softmax through lengths_tok
    h = torch.cat([t_emb[:, None, :], h], dim=1)
    bb = h.shape[0]
    lengths_tok = (lengths.to(torch.int32) + 1 if lengths is not None
                   else torch.full((bb,), n + 1, dtype=torch.int32, device=h.device))
    n_pad = -(-(n + 1) // 128) * 128
    h = F.pad(h, (0, 0, 0, n_pad - n - 1))
    rope_tabs = rope_flat_tables(statics.rope_angles, n_pad, arch.heads, arch.pe_attn_head,
                                 dtype=h.dtype)

    # under checkpoint_activations each block is checkpointed; the skip
    # stack stays outside (the first half's block inputs, kept as they are)
    skips = []
    for blk in params["first_half"]:
        skips.append(h)  # the pre-block state is the skip
        h = remat.run_block(arch, _block, blk, h, statics, rope_tabs, lengths_tok)
    for blk, skip in zip(params["second_half"], reversed(skips)):
        h = remat.run_block(arch, _block, blk, h, statics, rope_tabs, lengths_tok, skip)

    # strip the time token and the padding
    h = m.rms_norm(params["norm_out"], h, eps=RMS_EPS)[:, 1:n + 1]
    return m.linear(params["proj_out"], h).float()
