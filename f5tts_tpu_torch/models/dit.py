"""DiT backbone (counterpart of f5tts_tpu/models/dit.py).

- text_embedding: +1 token shift (0 = filler), curtail/pad to the mel
  length, filler beyond each sample's length, freqs_cis added on valid
  positions only, ConvNeXt V2 stack with padding re-zeroed after each block.
- input_embedding: Linear(concat(x, cond, text)) + ConvPositionEmbedding (K2;
  two launches of K10 at the dim-768 presets' 48 channels a group).
  Both also serve the UNetT in its forms: no per-sample `lengths` (the text
  is neither cut nor masked per sample; the conv runs over every row).
- text_embedding_average_upsampling: the live text tokens spread evenly
  over each sample's frames (`average_upsample_text`, an integer gather on
  the device, from the length the forward is given).
- dit_apply: the blocks (K1, K3; K6 and K7 under qk-norm; checkpointed
  under `arch.checkpoint_activations`, `models/remat.py`), the long skip
  (`long_skip_connection`: Linear(cat[blocks' output, their input])),
  final AdaLN (K1) + projection.
- dit_forward(cfg_infer=True): cond rows then uncond rows in one 2b batch;
  the uncond rows drop both the audio cond and the text.
- precompute_t_mods: every step's AdaLN modulation at once, before the loop;
  hoist_t_mods: its one-step counterpart, which the training forward uses.
- drop_audio_cond / drop_text: a bool (the sampler's CFG packing) or a [b]
  bool tensor (training's per-sample CFG dropout).
- Tensor parallelism: statics made with `tp` (`parallel.mesh.Mesh.tp`)
  run the blocks on this rank's shards (`parallel.mesh.shard_params`) and
  heads; the embeddings, AdaLN modulations, long skip and proj_out stay
  whole on every rank, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.config import ModelArch
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models import remat
from f5tts_tpu_torch.ops.rope import (
    precompute_freqs_cis,
    rope_flat_tables,
    rope_freqs_interleaved,
)

TEXT_PRECOMPUTE_MAX_POS = 8192  # reference dit.py:47


def init_text_embedding(gen: torch.Generator, arch: ModelArch) -> m.Params:
    text_dim = arch.text_dim or arch.mel_dim
    text = {"embed": {"w": torch.randn(arch.text_num_embeds + 1, text_dim, generator=gen)}}
    if arch.conv_layers > 0:
        text["blocks"] = [m.init_convnext_v2_block(gen, text_dim, text_dim * arch.conv_mult)
                          for _ in range(arch.conv_layers)]
    return text


def init_input_embedding(gen: torch.Generator, arch: ModelArch) -> m.Params:
    text_dim = arch.text_dim or arch.mel_dim
    return {"proj": m.init_linear(gen, arch.mel_dim * 2 + text_dim, arch.dim),
            "conv_pos": m.init_conv_pos_embedding(gen, arch.dim)}


def init_dit(generator: torch.Generator, arch: ModelArch) -> m.Params:
    """Random DiT parameters from `generator` (on the CPU, f32). The AdaLN,
    norm_out and proj_out linears are zero (AdaLN-zero), as in the JAX
    package: such a DiT is an identity until those are trained or randomised
    (`activate_zero_init`)."""
    g = generator
    p = {
        "time_embed": m.init_timestep_embedding(g, arch.dim),
        "text_embed": init_text_embedding(g, arch),
        "input_embed": init_input_embedding(g, arch),
        "blocks": [m.init_dit_block(g, arch.dim, arch.heads, arch.dim_head, arch.ff_mult,
                                    arch.qk_norm) for _ in range(arch.depth)],
        "norm_out": m.init_adaln_final(g, arch.dim, zero=True),
        "proj_out": m.init_linear(g, arch.dim, arch.mel_dim, zero=True),
    }
    if arch.long_skip_connection:
        p["long_skip"] = m.init_linear(g, arch.dim * 2, arch.dim, bias=False)
    return p


def activate_zero_init(params: m.Params, generator: torch.Generator,
                       scale: float = 0.05) -> m.Params:
    """Replace every all-zero float leaf (AdaLN and final-norm linears,
    proj_out, GRN gamma/beta) with scale * N(0, 1), so a random-init model
    carries real signal (the JAX package's scripts/int8_quality_ab.py does
    the same)."""
    def act(a):
        if a.is_floating_point() and a.numel() and not bool(torch.any(a != 0)):
            return scale * torch.randn(a.shape, generator=generator).to(a.dtype)
        return a
    return m.tree_map(act, params)


class DiTStatics:
    """Constant tables (text position table, RoPE angles) on `device`, and
    the tensor-parallel group `tp` the forward runs over (None: one rank)."""

    def __init__(self, arch: ModelArch, device=None, tp=None):
        self.arch = arch
        self.tp = tp
        m.local_heads(arch.heads, arch.pe_attn_head, tp)  # a mesh must divide the heads
        text_dim = arch.text_dim or arch.mel_dim
        self.text_freqs_cis = precompute_freqs_cis(text_dim, TEXT_PRECOMPUTE_MAX_POS).to(device)
        self.rope_angles = rope_freqs_interleaved(arch.dim_head, TEXT_PRECOMPUTE_MAX_POS).to(device)


def text_embedding(p: m.Params, statics: DiTStatics, text: torch.Tensor, seq_len: int,
                   lengths: Optional[torch.Tensor] = None, drop_text=False,
                   dtype=torch.float32) -> torch.Tensor:
    """text [b, nt] ids, -1 padded -> [b, seq_len, text_dim]. `drop_text`: a
    bool, or a [b] bool tensor that drops the text of some samples."""
    arch = statics.arch
    b, nt = text.shape
    text = text.long() + 1  # -1 pad -> 0 filler
    text = text[:, :seq_len] if nt >= seq_len else F.pad(text, (0, seq_len - nt))

    valid = None
    if lengths is not None:
        valid = torch.arange(seq_len, device=text.device)[None, :] < lengths[:, None]
        text = torch.where(valid, text, 0)
    pad_mask = text == 0
    if isinstance(drop_text, torch.Tensor):
        text = torch.where(drop_text[:, None], 0, text)
    elif drop_text:
        text = torch.zeros_like(text)

    # F.embedding, not w[text]: advanced indexing's backward accumulates the
    # thousands of filler (0) ids one by one (8.9 ms a training step at
    # 16 x 1024 on the H100); embedding's backward reduces them in segments
    emb = F.embedding(text, p["embed"]["w"]).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=emb.device)
    if valid is not None:
        emb = torch.where(valid[:, :, None], emb, zero)
    if arch.conv_layers > 0:
        freqs = statics.text_freqs_cis[:seq_len].to(dtype)
        if valid is not None:
            emb = emb + freqs[None] * valid[:, :, None].to(dtype)
        else:
            emb = emb + freqs[None]
        if arch.text_mask_padding:
            emb = torch.where(pad_mask[:, :, None], zero, emb)
            for blk in p["blocks"]:
                emb = torch.where(pad_mask[:, :, None], zero, m.convnext_v2_block(blk, emb))
        else:
            for blk in p["blocks"]:
                emb = m.convnext_v2_block(blk, emb)
    if arch.text_embedding_average_upsampling:
        target = lengths if lengths is not None else torch.full(
            (b,), seq_len, dtype=torch.int32, device=text.device)
        emb = average_upsample_text(emb, ~pad_mask, target)
    return emb


def average_upsample_text(text: torch.Tensor, text_mask: torch.Tensor,
                          target_lens: torch.Tensor) -> torch.Tensor:
    """Zipvoice-style average upsampling (JAX dit.py:158-196): a row's
    text_len live tokens [b, n, d] (text_mask [b, n]) are compacted to the
    front, and token j covers audio_len // text_len frames, the last
    audio_len % text_len tokens one more; frames >= target_lens[b] and rows
    without a live token are zero. A gather: no host value, so a CUDA graph
    can take target_lens from its input buffers."""
    b, n, _ = text.shape
    text_lens = text_mask.sum(dim=1)
    order = torch.argsort((~text_mask).to(torch.int8), dim=1, stable=True)  # live ids first
    compact = torch.gather(text, 1, order[:, :, None].expand_as(text))
    pos = torch.arange(n, device=text.device)[None, :]
    tl = torch.clamp(text_lens, min=1)[:, None]
    al = torch.clamp(target_lens.long(), min=1)[:, None]
    base, rem = al // tl, al % tl
    cutoff = (tl - rem) * base
    tok = torch.where(pos < cutoff, pos // torch.clamp(base, min=1),
                      (tl - rem) + (pos - cutoff) // torch.clamp(base + 1, min=1))
    tok = torch.clamp(tok, 0, n - 1)
    out = torch.gather(compact, 1, tok[:, :, None].expand_as(text))
    valid = (pos < target_lens[:, None]) & (text_lens[:, None] > 0)
    return torch.where(valid[:, :, None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))


def input_embedding(p: m.Params, x: torch.Tensor, cond: torch.Tensor,
                    text_embed: torch.Tensor, drop_audio_cond=False,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`drop_audio_cond`: a bool, or a [b] bool tensor."""
    if isinstance(drop_audio_cond, torch.Tensor):
        cond = torch.where(drop_audio_cond[:, None, None], torch.zeros((), dtype=cond.dtype,
                                                                      device=cond.device), cond)
    elif drop_audio_cond:
        cond = torch.zeros_like(cond)
    h = m.linear(p["proj"], torch.cat([x, cond, text_embed], dim=-1))
    return m.conv_pos_embedding(p["conv_pos"], h, lengths) + h


def dit_apply(params: m.Params, statics: DiTStatics, x: torch.Tensor,
              block_mods, final_mod: torch.Tensor,
              lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Blocks (each checkpointed under `arch.checkpoint_activations`) + the
    long skip + final AdaLN + proj_out. block_mods[i] is block i's [b, 6*dim]."""
    arch = statics.arch
    n = x.shape[1]
    heads, pe = m.local_heads(arch.heads, arch.pe_attn_head, statics.tp)
    rope_tabs = rope_flat_tables(statics.rope_angles, n, heads, pe, dtype=x.dtype)
    residual = x
    for blk, mods in zip(params["blocks"], block_mods):
        x = remat.run_block(arch, m.dit_block, blk, x, mods, heads, rope_tabs, lengths,
                            statics.rope_angles, pe, statics.tp)
    if arch.long_skip_connection:
        x = m.linear(params["long_skip"], torch.cat([x, residual], dim=-1))
    x = m.adaln_final(x, final_mod)
    return m.linear(params["proj_out"], x)


def t_mods_from_emb(params: m.Params, t_emb: torch.Tensor) -> tuple:
    """(per-block [b, 6*dim] mods, final [b, 2*dim] mod) from [b, dim] t_emb."""
    h = F.silu(t_emb)
    block_mods = [m.linear(blk["attn_norm"]["linear"], h) for blk in params["blocks"]]
    return block_mods, m.linear(params["norm_out"]["linear"], h)


def hoist_t_mods(params: m.Params, t_emb: torch.Tensor) -> tuple:
    """One step's AdaLN modulation for every block at once, from t_emb
    [b, dim]: (block_mods [L, b, 6*dim], final_mod [b, 2*dim]). The training
    counterpart of `precompute_t_mods` (JAX dit.py:355-369)."""
    block_mods, final_mod = t_mods_from_emb(params, t_emb)
    return torch.stack(block_mods), final_mod


def precompute_t_mods(params: m.Params, t_values: torch.Tensor, batch: int,
                      dtype=torch.bfloat16) -> tuple:
    """All timestep-dependent AdaLN work for `t_values` [S], at once.
    Returns (block_mods [L, S, batch, 6*dim], final_mod [S, batch, 2*dim])."""
    s = t_values.shape[0]
    t_flat = t_values[:, None].expand(s, batch).reshape(-1)
    emb = m.timestep_embedding(params["time_embed"], t_flat, dtype=dtype)
    block_mods, final_mod = t_mods_from_emb(params, emb)
    block_mods = torch.stack(block_mods).reshape(len(params["blocks"]), s, batch, -1)
    return block_mods, final_mod.reshape(s, batch, -1)


def dit_forward(params: m.Params, statics: DiTStatics, x: torch.Tensor,
                cond: torch.Tensor, text: torch.Tensor, time: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, drop_audio_cond=False,
                drop_text=False, cfg_infer: bool = False,
                text_embeds: Optional[tuple] = None, dtype=torch.float32,
                t_mods: Optional[tuple] = None) -> torch.Tensor:
    """Flow prediction [b, n, mel] (f32); with cfg_infer, [2b, n, mel]: cond
    rows then uncond rows. `t_mods` = (block_mods [L, B, 6*dim], final_mod
    [B, 2*dim]) with B the packed batch replaces the timestep embedding.
    `drop_audio_cond` / `drop_text` (without cfg_infer): bools or [b] bool
    tensors."""
    b, n, _ = x.shape
    x = x.to(dtype)
    cond = cond.to(dtype)
    ip = params["input_embed"]

    def te(drop):
        if text_embeds is not None:
            return text_embeds[1] if drop else text_embeds[0]
        return text_embedding(params["text_embed"], statics, text, n, lengths=lengths,
                              drop_text=drop, dtype=dtype)

    if cfg_infer:
        h = torch.cat([input_embedding(ip, x, cond, te(False), False, lengths),
                       input_embedding(ip, x, cond, te(True), True, lengths)], dim=0)
        lengths = torch.cat([lengths, lengths]) if lengths is not None else None
    else:
        h = input_embedding(ip, x, cond, te(drop_text), drop_audio_cond, lengths)

    if t_mods is None:
        if time.dim() == 0:
            time = time.expand(b)
        t_emb = m.timestep_embedding(params["time_embed"], time, dtype=dtype)
        if cfg_infer:
            t_emb = torch.cat([t_emb, t_emb], dim=0)
        t_mods = hoist_t_mods(params, t_emb)
    out = dit_apply(params, statics, h, t_mods[0], t_mods[1], lengths)
    return out.float()
