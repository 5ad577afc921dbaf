"""MMDiT backbone, the SD3-style dual-stream (audio + text) transformer
(counterpart of f5tts_tpu/models/mmdit.py:38-428).

- Text stream: embedding + the absolute freqs_cis table (1024 positions,
  longer texts clamped at the table edge), padding zeroed.
- Audio stream: Linear(concat(x, cond)) + conv position embedding (K2, over
  every row).
- Joint attention on the fused projections: the two streams' qkv are
  concatenated on the sequence axis, roped with the per-stream tables
  concatenated the same way, and attended under the joint key mask (audio
  padding leaves dead keys in the middle) by kernel K5; the output is split
  back. Under qk-norm (`q_norm`, `k_norm`, `c_q_norm`, `c_k_norm` leaves) or
  with unfused projections, the head layout instead: per-stream heads,
  per-head RMSNorm (K6), per-stream RoPE, the joint sequence attended by
  kernel K11. The text stream is padded so the joint length is a multiple of
  128, its pad keys masked, as the JAX package pads it for its kernels.
- AdaLN (K1) on both streams; the last block is context_pre_only: its text
  stream gets only a final AdaLN, no feed-forward and no to_out_c.
- Every AdaLN modulation is computed before the block loop
  (`mmdit_hoist_t_mods`), and for every ODE step at once in the sampler
  (`mmdit_precompute_t_mods`).
- Training (`cfm_loss`): per-sample [b] bool drops; the joint attention's
  backward is kernel K8, which reads the joint dO on every row (dead rows
  get a zero dO from the masks after to_out / to_out_c, and the last
  block's text rows from its unused text output).
The JAX package stacks the depth - 1 uniform blocks for `lax.scan`; here
they are a Python list of block dicts (`convert.py` unstacks).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.config import ModelArch
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models import remat
from f5tts_tpu_torch.ops.attention import fused_qkv_rope_attention_bias, masked_flash_attention
from f5tts_tpu_torch.ops.rope import (
    apply_rotary,
    precompute_freqs_cis,
    rope_flat_tables,
    rope_freqs_interleaved,
)

TEXT_PRECOMPUTE_MAX_POS = 1024  # reference mmdit.py:39
ROPE_MAX_POS = 8192


class MMDiTStatics:
    """Constant tables (text position table, RoPE angles) on `device`."""

    def __init__(self, arch: ModelArch, device=None):
        self.arch = arch
        self.text_freqs_cis = precompute_freqs_cis(arch.dim, TEXT_PRECOMPUTE_MAX_POS).to(device)
        self.rope_angles = rope_freqs_interleaved(arch.dim_head, ROPE_MAX_POS).to(device)


def init_mmdit(generator: torch.Generator, arch: ModelArch) -> m.Params:
    """Random MMDiT parameters from `generator` (on the CPU, f32). The AdaLN,
    norm_out and proj_out linears are zero, as in the JAX package
    (`dit.activate_zero_init` randomises them)."""
    g = generator
    inner = arch.heads * arch.dim_head

    def joint_attention(context_pre_only: bool) -> m.Params:
        p = {name: m.init_linear(g, arch.dim, inner)
             for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c")}
        p["to_out"] = m.init_linear(g, inner, arch.dim)
        if not context_pre_only:
            p["to_out_c"] = m.init_linear(g, inner, arch.dim)
        if arch.qk_norm == "rms_norm":
            for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
                p[name] = m.init_rms_norm(arch.dim_head)
        return p

    def block(context_pre_only: bool) -> m.Params:
        blk = {"attn_norm_x": m.init_adaln(g, arch.dim, zero=True),
               "attn": joint_attention(context_pre_only),
               "ff_x": m.init_feed_forward(g, arch.dim, arch.ff_mult)}
        if context_pre_only:
            blk["attn_norm_c"] = m.init_adaln_final(g, arch.dim, zero=True)
        else:
            blk["attn_norm_c"] = m.init_adaln(g, arch.dim, zero=True)
            blk["ff_c"] = m.init_feed_forward(g, arch.dim, arch.ff_mult)
        return blk

    return {
        "time_embed": m.init_timestep_embedding(g, arch.dim),
        "text_embed": {"embed": {"w": torch.randn(arch.text_num_embeds + 1, arch.dim,
                                                  generator=g)}},
        "audio_embed": {"linear": m.init_linear(g, 2 * arch.mel_dim, arch.dim),
                        "conv_pos": m.init_conv_pos_embedding(g, arch.dim)},
        "blocks": [block(False) for _ in range(arch.depth - 1)],
        "last_block": block(True),
        "norm_out": m.init_adaln_final(g, arch.dim, zero=True),
        "proj_out": m.init_linear(g, arch.dim, arch.mel_dim, zero=True),
    }


def mmdit_text_embedding(p: m.Params, statics: MMDiTStatics, text: torch.Tensor,
                         drop_text=False, mask_padding: bool = True,
                         dtype=torch.float32) -> torch.Tensor:
    """text [b, nt] ids, -1 padded -> [b, nt, dim] (reference mmdit.py:42-63).
    `drop_text`: a bool, or a [b] bool tensor."""
    text = text.long() + 1
    pad_mask = text == 0
    if isinstance(drop_text, torch.Tensor):
        text = torch.where(drop_text[:, None], 0, text)
    elif drop_text:
        text = torch.zeros_like(text)
    emb = F.embedding(text, p["embed"]["w"]).to(dtype)
    nt = text.shape[1]
    pos = statics.text_freqs_cis[:min(nt, TEXT_PRECOMPUTE_MAX_POS)]
    if nt > pos.shape[0]:  # clamp long positions at the table edge
        pos = torch.cat([pos, pos[-1:].expand(nt - pos.shape[0], -1)])
    emb = emb + pos[None].to(dtype)
    if mask_padding:
        emb = torch.where(pad_mask[:, :, None], torch.zeros((), dtype=dtype, device=emb.device),
                          emb)
    return emb


def mmdit_text_embeds(params: m.Params, statics: MMDiTStatics, text: torch.Tensor,
                      dtype=torch.float32) -> tuple:
    """(cond, uncond) text streams [b, nt, dim]."""
    return tuple(mmdit_text_embedding(params["text_embed"], statics, text, drop,
                                      statics.arch.text_mask_padding, dtype)
                 for drop in (False, True))


def _joint_attention(p: m.Params, x, c, heads: int,
                     kmask: torch.Tensor, joint_tabs: tuple, rope_angles: torch.Tensor) -> tuple:
    """modules.py:581-705 / mmdit.py:120-222: attend the concatenated streams
    under the joint key mask kmask [b, n + nt], split; dead rows of each
    stream zeroed after its to_out. x and c may be `QuantRows` (int8
    projections without the hedge). Fused params without qk-norm: the flat
    qkv of both streams, roped from `joint_tabs`, by K5. Otherwise the head
    layout: each stream's q/k/v split into heads (under qk-norm K6 reads q
    and k in place from the projections' head views), audio RoPE on the
    audio rows and text RoPE on the text rows (`rope_angles`), the joint
    sequence by K11, heads merged. The context_pre_only block has no
    to_out_c and returns no text stream."""
    n = x.shape[1]
    if "to_qkv" in p and "q_norm" not in p:
        with remat.tagged("qkv"):
            qkv_x, qkv_c = m.linear(p["to_qkv"], x), m.linear(p["to_qkv_c"], c)
        qkv = torch.cat([qkv_x, qkv_c], dim=1)
        o = fused_qkv_rope_attention_bias(qkv, joint_tabs[0], joint_tabs[1], kmask, heads)
    else:
        with remat.tagged("qkv"):
            if "to_qkv" in p:
                qkv_x = m.linear(p["to_qkv"], x).chunk(3, dim=-1)
                qkv_c = m.linear(p["to_qkv_c"], c).chunk(3, dim=-1)
            else:
                qkv_x = [m.linear(p[name], x) for name in ("to_q", "to_k", "to_v")]
                qkv_c = [m.linear(p[name], c) for name in ("to_q_c", "to_k_c", "to_v_c")]
        qk = (qkv_x[0], qkv_x[1], qkv_c[0], qkv_c[1])
        if "q_norm" in p:  # K6 reads q and k in place from the projections
            q, k, cq, ck = (m.rms_norm(p[name], m.head_view(t, heads)) for name, t in
                            zip(("q_norm", "k_norm", "c_q_norm", "c_k_norm"), qk))
        else:
            q, k, cq, ck = (m.split_heads(t, heads) for t in qk)
        v, cv = m.split_heads(qkv_x[2], heads), m.split_heads(qkv_c[2], heads)
        q, k, cq, ck = (apply_rotary(t, rope_angles) for t in (q, k, cq, ck))
        o = m.merge_heads(masked_flash_attention(
            torch.cat([q, cq], dim=2), torch.cat([k, ck], dim=2), torch.cat([v, cv], dim=2),
            kmask))
    zero = torch.zeros((), dtype=o.dtype, device=o.device)
    # Both projections keep `o` itself for their backward (the tensor the
    # attention saves under grad), not copies of its rows: to_out runs over
    # the whole joint output and drops the text rows after; to_out_c is a
    # batched product on the strided view of the text rows (an int8 leaf:
    # K12 reads that view in place, `modules.linear`).
    xo = torch.where(kmask[:, :n, None], m.linear(p["to_out"], o)[:, :n], zero)
    if "to_out_c" not in p:
        return xo, None
    pc = p["to_out_c"]
    if "w_i8" in pc:
        co = m.linear(pc, o[:, n:])
    else:
        co = torch.matmul(o[:, n:], pc["w"].to(o.dtype).expand(o.shape[0], -1, -1))
        if "b" in pc:
            co = co + pc["b"].to(o.dtype)
    return xo, torch.where(kmask[:, n:, None], co, zero)


def _mmdit_block(blk: m.Params, x: torch.Tensor, c: torch.Tensor, mods_x: torch.Tensor,
                 mods_c: torch.Tensor, heads: int, kmask: torch.Tensor, joint_tabs: tuple,
                 rope_angles: torch.Tensor, context_pre_only: bool = False) -> tuple:
    """modules.py:816-846. mods_x [b, 6*dim]; mods_c [b, 6*dim], or [b, 2*dim]
    for the context_pre_only last block. Each norm is told which projections
    read its rows (K1Q where they all take them quantized)."""
    attn = blk["attn"]
    readers_c = m.attention_inputs(attn, context=True)
    if context_pre_only:
        norm_c = m.adaln_final(c, mods_c, readers_c)
    else:
        c_sm, c_ss, c_gm, c_s2, c_sc2, c_g2 = mods_c.chunk(6, dim=-1)
        norm_c = m.adaln_pre(c, c_sm, c_ss, readers_c)
    x_sm, x_ss, x_gm, x_s2, x_sc2, x_g2 = mods_x.chunk(6, dim=-1)
    norm_x = m.adaln_pre(x, x_sm, x_ss, m.attention_inputs(attn))

    x_attn, c_attn = _joint_attention(attn, norm_x, norm_c, heads, kmask, joint_tabs,
                                      rope_angles)
    if context_pre_only:
        c = None
    else:
        c = c + c_gm[:, None, :] * c_attn
        norm_c = m.adaln_pre(c, c_s2, c_sc2, [blk["ff_c"]["in"]])
        c = c + c_g2[:, None, :] * m.feed_forward(blk["ff_c"], norm_c)
    x = x + x_gm[:, None, :] * x_attn
    norm_x = m.adaln_pre(x, x_s2, x_sc2, [blk["ff_x"]["in"]])
    x = x + x_g2[:, None, :] * m.feed_forward(blk["ff_x"], norm_x)
    return x, c


def mmdit_hoist_t_mods(params: m.Params, t_emb: torch.Tensor) -> dict:
    """Every AdaLN modulation from t_emb [..., dim] (any leading shape):
    blocks_x / blocks_c [L, ..., 6*dim], last_x [..., 6*dim], last_c and
    final [..., 2*dim]."""
    h = F.silu(t_emb)

    def mod(p):
        return m.linear(p["linear"], h)

    return {
        "blocks_x": torch.stack([mod(blk["attn_norm_x"]) for blk in params["blocks"]]),
        "blocks_c": torch.stack([mod(blk["attn_norm_c"]) for blk in params["blocks"]]),
        "last_x": mod(params["last_block"]["attn_norm_x"]),
        "last_c": mod(params["last_block"]["attn_norm_c"]),
        "final": mod(params["norm_out"]),
    }


def mmdit_precompute_t_mods(params: m.Params, t_values: torch.Tensor, batch: int,
                            dtype=torch.bfloat16):
    """Every step's AdaLN modulation for `t_values` [S] at once; returns
    `at(i)`, step i's mods dict (counterpart of dit.precompute_t_mods)."""
    s = t_values.shape[0]
    t_flat = t_values[:, None].expand(s, batch).reshape(-1)
    emb = m.timestep_embedding(params["time_embed"], t_flat, dtype=dtype)
    mods = mmdit_hoist_t_mods(params, emb.reshape(s, batch, -1))

    def at(i: int) -> dict:
        return {"blocks_x": mods["blocks_x"][:, i], "blocks_c": mods["blocks_c"][:, i],
                "last_x": mods["last_x"][i], "last_c": mods["last_c"][i],
                "final": mods["final"][i]}

    return at


def mmdit_forward(params: m.Params, statics: MMDiTStatics, x: torch.Tensor,
                  cond: torch.Tensor, text: torch.Tensor, time: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None, drop_audio_cond=False,
                  drop_text=False, cfg_infer: bool = False,
                  text_embeds: Optional[tuple] = None, dtype=torch.float32,
                  t_mods: Optional[dict] = None) -> torch.Tensor:
    """Flow prediction [b, n, mel] (f32); with cfg_infer, [2b, n, mel]: cond
    rows then uncond rows. `t_mods` (`mmdit_hoist_t_mods` of the packed
    batch) replaces the timestep embedding. Fused to_qkv / to_qkv_c
    (`fuse_backbone_qkv`) without qk-norm run the flat K5; qk-norm or unfused
    projections the head layout and K11."""
    arch = statics.arch
    b, n, _ = x.shape
    x = x.to(dtype)
    cond = cond.to(dtype)
    c_kmask = text != -1  # live text positions (mmdit.py:232)
    audio_kmask = (torch.arange(n, device=x.device)[None, :] < lengths[:, None]
                   if lengths is not None else None)

    def audio_embed(cc, drop):
        if isinstance(drop, torch.Tensor):
            cc = torch.where(drop[:, None, None], torch.zeros((), dtype=cc.dtype,
                                                              device=cc.device), cc)
        elif drop:
            cc = torch.zeros_like(cc)
        h = m.linear(params["audio_embed"]["linear"], torch.cat([x, cc], dim=-1))
        return m.conv_pos_embedding(params["audio_embed"]["conv_pos"], h) + h

    if cfg_infer:
        c_c, c_u = (text_embeds if text_embeds is not None
                    else mmdit_text_embeds(params, statics, text, dtype))
        h = torch.cat([audio_embed(cond, False), audio_embed(cond, True)], dim=0)
        c = torch.cat([c_c, c_u], dim=0)
        c_kmask = torch.cat([c_kmask, c_kmask], dim=0)
        if audio_kmask is not None:
            audio_kmask = torch.cat([audio_kmask, audio_kmask], dim=0)
    else:
        if text_embeds is None:
            c = mmdit_text_embedding(params["text_embed"], statics, text, drop_text,
                                     arch.text_mask_padding, dtype)
        else:
            c = text_embeds[1] if drop_text is True else text_embeds[0]
        h = audio_embed(cond, drop_audio_cond)

    # pad the text stream so the joint length is a multiple of 128, its pad
    # keys masked (mmdit.py:372-378); the joint key mask, once a forward
    nt = c.shape[1]
    nt_pad = -(-(n + nt) // 128) * 128 - n
    if nt_pad != nt:
        c = F.pad(c, (0, 0, 0, nt_pad - nt))
        c_kmask = torch.cat([c_kmask, c_kmask.new_zeros((c.shape[0], nt_pad - nt))], dim=1)
    if audio_kmask is None:
        audio_kmask = c_kmask.new_ones((c.shape[0], n))
    kmask = torch.cat([audio_kmask, c_kmask], dim=1)

    # joint rope tables: audio rows rotate with audio positions, text rows
    # with text positions
    ca, sa = rope_flat_tables(statics.rope_angles, n, arch.heads, None, dtype=dtype)
    ct, st = rope_flat_tables(statics.rope_angles, nt_pad, arch.heads, None, dtype=dtype)
    joint_tabs = (torch.cat([ca, ct]), torch.cat([sa, st]))

    if t_mods is None:
        if time.dim() == 0:
            time = time.expand(b)
        t_emb = m.timestep_embedding(params["time_embed"], time, dtype=dtype)
        if cfg_infer:
            t_emb = torch.cat([t_emb, t_emb], dim=0)
        t_mods = mmdit_hoist_t_mods(params, t_emb)

    # checkpoint_activations covers the depth - 1 uniform blocks, not the
    # context_pre_only last one (JAX mmdit.py:415-428)
    for blk, mx, mc in zip(params["blocks"], t_mods["blocks_x"], t_mods["blocks_c"]):
        h, c = remat.run_block(arch, _mmdit_block, blk, h, c, mx, mc, arch.heads, kmask,
                               joint_tabs, statics.rope_angles)
    h, _ = _mmdit_block(params["last_block"], h, c, t_mods["last_x"], t_mods["last_c"],
                        arch.heads, kmask, joint_tabs, statics.rope_angles,
                        context_pre_only=True)
    h = m.adaln_final(h, t_mods["final"])
    return m.linear(params["proj_out"], h).float()
