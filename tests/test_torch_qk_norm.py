"""qk-norm attention and the key-masked head-layout attention (kernel K11's
plain version) against the JAX package on the CPU.

Kernel level: `mha_reference_masked` (through the `masked_flash_attention`
wrapper: CPU tensors take the plain version) against the Pallas
`_masked_flash_forward` in interpret mode and the JAX `mha_reference_masked`
at n = 128 and 256 with dead keys mid-sequence; its gradient against
`jax.vjp(masked_flash_attention)`; the head-layout RoPE `apply_rotary` /
`apply_rotary_partial_heads`. Module level: `self_attention` with qk-norm
and with unfused projections, the DiT, UNetT and MMDiT forwards with
`qk_norm="rms_norm"` against the JAX XLA path (`backend="xla"`), the MMDiT
with unfused params against its fused forward, `cfm_sample` with `y0=` at
the MMDiT with qk-norm, one `InferencePipeline.infer` smoke. Weights are
drawn from numpy seeds (`tests.test_torch_dit.np_params`: the RMSNorm
weights, qk-norm's included, 1 + 0.1 N(0, 1)); f32 on both sides. Small
shapes: dim 128, depth 2, heads 2 x 64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.ops import attention as jatt
from f5tts_tpu.ops import rope as jrope
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import dit_params_from_jax, mmdit_params_from_jax, unett_params_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import mmdit as tmmdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models import unett as tunett
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops import rope as trope
from f5tts_tpu_torch.ops.rope import rope_flat_tables
from f5tts_tpu_torch.utils import make_time_grid
from tests.test_torch_dit import _live, _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_num_embeds=32,
            qk_norm="rms_norm")
DIT = dict(BASE, text_dim=64, conv_layers=1)
UNETT = dict(BASE, text_dim=None, conv_layers=0, text_mask_padding=False)
MMDIT = dict(BASE, text_dim=None, conv_layers=0, text_mask_padding=True)
# f32 on both sides, outputs O(1-10): sum-order differences, relative
ATOL, RTOL = 2e-4, 2e-4


def _kmask(b, n):
    """Row 0: a dead run mid-sequence and a dead tail; row 1: one dead
    64-key tile and a dead tail."""
    kmask = np.ones((b, n), bool)
    kmask[0, n // 4: n // 2] = False
    kmask[0, n - 10:] = False
    kmask[1, 64:128] = False
    kmask[1, n - n // 5:] = False
    return kmask


@pytest.mark.parametrize("n", [128, 256])
def test_masked_attention_plain_matches_pallas_and_jax(n):
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(3))
    kmask = _kmask(2, n)
    pallas = np.asarray(jatt._masked_flash_forward(*map(jnp.asarray, (q, k, v, kmask))))
    xla = np.asarray(jatt.mha_reference_masked(*map(jnp.asarray, (q, k, v, kmask))))
    got = _np(tatt.masked_flash_attention(*map(_t, (q, k, v, kmask))))
    np.testing.assert_array_equal(got, _np(tatt.mha_reference_masked(*map(_t, (q, k, v, kmask)))))
    # f32 throughout, |o| < ~2, every row (the mask is on keys only)
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5)


def test_masked_attention_row_without_live_keys_is_the_mean_of_v():
    """The plain version keeps the JAX reference's semantics for a batch row
    with no live key (K11 writes zeros there; no model path makes one)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 2, 128, 64)).astype(np.float32) for _ in range(3))
    kmask = np.ones((2, 128), bool)
    kmask[1] = False
    got = _np(tatt.masked_flash_attention(*map(_t, (q, k, v, kmask))))
    want = np.asarray(jatt.mha_reference_masked(*map(jnp.asarray, (q, k, v, kmask))))
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                       got[1].shape), atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_masked_attention_grad_matches_jax_vjp():
    rng = np.random.default_rng(2)
    n = 128
    q, k, v, do = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(4))
    kmask = _kmask(2, n)
    _, vjp = jax.vjp(lambda a, b_, c: jatt.masked_flash_attention(a, b_, c, jnp.asarray(kmask)),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tatt.masked_flash_attention(*xs, _t(kmask)), xs, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-5, rtol=1e-4)
    dead = ~kmask
    for i in range(2):  # dead keys get no gradient in dk and dv
        assert not _np(got[1])[i][:, dead[i]].any() and not _np(got[2])[i][:, dead[i]].any()


def test_masked_attention_wrapper_cpu_plain_and_refuses_other_devices():
    _build.reset_launches()
    x = torch.zeros(1, 2, 64, 64)
    tatt.masked_flash_attention(x, x, x, torch.ones(1, 64, dtype=torch.bool))
    assert _build.launches() == {}
    meta = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.masked_flash_attention(meta, meta, meta, meta)


@pytest.mark.parametrize("pe_attn_head", [None, 1])
def test_apply_rotary_head_layout_matches_jax(pe_attn_head):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 50, 64)).astype(np.float32)
    ang = jrope.rope_freqs_interleaved(64, 80)
    want = np.asarray(jrope.apply_rotary_partial_heads(jnp.asarray(x), ang, pe_attn_head))
    tang = trope.rope_freqs_interleaved(64, 80)
    got = _np(trope.apply_rotary_partial_heads(_t(x), tang, pe_attn_head))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(_np(trope.apply_rotary(_t(x), tang)),
                               np.asarray(jrope.apply_rotary(jnp.asarray(x), ang)), atol=2e-5)
    # the head layout and the flat layout rotate alike
    flat = _t(x).transpose(1, 2).reshape(2, 50, 3 * 64)
    np.testing.assert_allclose(
        _np(trope.apply_rotary_flat(flat, tang, 3, pe_attn_head)),
        got.transpose(0, 2, 1, 3).reshape(2, 50, 3 * 64), atol=2e-5)


@pytest.mark.parametrize("fused,pe_attn_head,qk_norm", [
    (True, None, "rms_norm"), (False, None, "rms_norm"), (True, 1, "rms_norm"),
    (False, 1, None)])
def test_self_attention_head_layout_matches_jax(fused, pe_attn_head, qk_norm, monkeypatch):
    """qk-norm or unfused projections take the head layout and K7 (its plain
    version) at every n, never the flat K3."""
    calls = []
    real = tm.attention
    monkeypatch.setattr(tm, "attention", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tm, "fused_qkv_rope_attention", None)  # K3 must not be reached
    tree = np_params(lambda: jm.init_attention(jax.random.PRNGKey(0), 128, 2, 64, qk_norm), 6)
    rng = np.random.default_rng(6)
    n = 256
    x = rng.standard_normal((2, n, 128)).astype(np.float32)
    lens = np.array([n, 177], np.int32)
    ang = jrope.rope_freqs_interleaved(64, n)
    want = np.asarray(jm.self_attention(jx(tree), jnp.asarray(x), 2, ang, jnp.asarray(lens),
                                        pe_attn_head, backend="xla"))
    p = tm.tree_map(_t, tree)
    if fused:
        p = tm.fuse_attention_qkv(p)
    tang = trope.rope_freqs_interleaved(64, n)
    tabs = rope_flat_tables(tang, n, 2, pe_attn_head, dtype=torch.float32)
    got = _np(tm.self_attention(p, _t(x), 2, tabs, _t(lens), tang, pe_attn_head))
    assert calls == [1]
    np.testing.assert_allclose(_live(got, lens), _live(want, lens), atol=ATOL, rtol=1e-4)
    assert not got[1, 177:].any()


def _forward_case(rng, b, n, nt):
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 60:] = 0
    text = rng.integers(0, 32, (b, nt)).astype(np.int32)
    text[0, nt - 20:] = -1
    time = np.array([0.3, 0.7], np.float32)
    return x, cond, text, time


@pytest.mark.parametrize("backbone", ["DiT", "UNetT", "MMDiT"])
def test_qk_norm_forward_matches_jax(backbone):
    jmod, tmod, conv, kw, n = {
        "DiT": (jdit, tdit, dit_params_from_jax, DIT, 256),
        "UNetT": (junett, tunett, unett_params_from_jax, UNETT, 255),
        "MMDiT": (jmmdit, tmmdit, mmdit_params_from_jax, MMDIT, 200)}[backbone]
    jarch = JArch(**kw)
    init = {"DiT": jdit.init_dit, "UNetT": junett.init_unett, "MMDiT": jmmdit.init_mmdit}[backbone]
    tree = np_params(lambda: init(jax.random.PRNGKey(0), jarch), 0)
    tp = tm.fuse_backbone_qkv(conv(tree))
    statics_j = {"DiT": jdit.DiTStatics, "UNetT": junett.UNetTStatics,
                 "MMDiT": jmmdit.MMDiTStatics}[backbone](jarch)
    statics_t = {"DiT": tdit.DiTStatics, "UNetT": tunett.UNetTStatics,
                 "MMDiT": tmmdit.MMDiTStatics}[backbone](TArch(**kw))
    fwd_j = {"DiT": jdit.dit_forward, "UNetT": junett.unett_forward,
             "MMDiT": jmmdit.mmdit_forward}[backbone]
    fwd_t = {"DiT": tdit.dit_forward, "UNetT": tunett.unett_forward,
             "MMDiT": tmmdit.mmdit_forward}[backbone]
    rng = np.random.default_rng(8)
    b = 2
    x, cond, text, time = _forward_case(rng, b, n, 70)
    lens = np.array([n, 141], np.int32)
    fwd = jax.jit(functools.partial(fwd_j, statics=statics_j, cfg_infer=True, backend="xla"))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens)))
    got = _np(fwd_t(tp, statics_t, _t(x), _t(cond), _t(text), _t(time), lengths=_t(lens),
                    cfg_infer=True))
    assert got.shape == want.shape == (2 * b, n, 100)
    lens2 = np.concatenate([lens, lens])
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=ATOL, rtol=RTOL)
    assert np.abs(_live(want, lens2)).max() > 0.1


@pytest.fixture(scope="module")
def mmdit_qk():
    jarch = JArch(**MMDIT)
    tree = np_params(lambda: jmmdit.init_mmdit(jax.random.PRNGKey(0), jarch), 0)
    return jarch, TArch(**MMDIT), tree, mmdit_params_from_jax(tree)


def test_converter_carries_the_qk_norm_leaves(mmdit_qk):
    jarch, tarch, tree, raw = mmdit_qk
    names = ("q_norm", "k_norm", "c_q_norm", "c_k_norm")
    for blk, i in ((raw["blocks"][0], 0), (raw["last_block"], None)):
        for name in names:
            src = tree["blocks"]["attn"][name]["w"][i] if i is not None else \
                tree["last_block"]["attn"][name]["w"]
            np.testing.assert_array_equal(_np(blk["attn"][name]["w"]), src)
    init = tmmdit.init_mmdit(torch.Generator().manual_seed(0), tarch)
    assert tm.tree_map(lambda a: tuple(a.shape), init) == tm.tree_map(lambda a: tuple(a.shape), raw)
    fused = tm.fuse_backbone_qkv(raw)
    assert set(names) <= set(fused["blocks"][0]["attn"]) and "to_qkv" in fused["last_block"]["attn"]


@pytest.mark.parametrize("qk_norm", ["rms_norm", None])
def test_mmdit_unfused_params_match_fused_forward(mmdit_qk, qk_norm):
    """Unfused projections take the head layout (K11's plain version); fused
    ones the flat K5 without qk-norm and the head layout with it."""
    _, tarch, _, raw = mmdit_qk
    if qk_norm is None:
        raw = tm.tree_map(lambda a: a, raw)
        for blk in raw["blocks"] + [raw["last_block"]]:
            for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
                del blk["attn"][name]
    rng = np.random.default_rng(9)
    n = 200
    x, cond, text, time = _forward_case(rng, 2, n, 70)
    lens = np.array([n, 141], np.int32)
    statics = tmmdit.MMDiTStatics(tarch)
    outs = [_np(tmmdit.mmdit_forward(p, statics, _t(x), _t(cond), _t(text), _t(time),
                                     lengths=_t(lens), cfg_infer=True))
            for p in (raw, tm.fuse_backbone_qkv(raw))]
    lens2 = np.concatenate([lens, lens])
    np.testing.assert_allclose(_live(outs[0], lens2), _live(outs[1], lens2), atol=ATOL, rtol=RTOL)


def test_mmdit_qk_norm_cfm_sample_matches_jax(mmdit_qk):
    jarch, tarch, tree, raw = mmdit_qk
    tp = tm.fuse_backbone_qkv(raw)
    rng = np.random.default_rng(11)
    b, n, nfe = 2, 256, 4
    lens = np.array([60, 90], np.int32)
    dur = np.array([256, 201], np.int32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, 64)).astype(np.int32)
    text[1, 40:] = -1
    y0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    y0[1, 201:] = 0
    want = np.asarray(jcfm.cfm_sample(
        jx(tree), jmmdit.MMDiTStatics(jarch), jnp.asarray(cond), jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(dur), j_make_time_grid(nfe, sway_sampling_coef=-1.0),
        y0=jnp.asarray(y0), cfg_strength=2.0, dtype=jnp.float32, backend="xla",
        backbone=jcfm.BACKBONES["MMDiT"]))
    got = _np(tcfm.cfm_sample(tp, tmmdit.MMDiTStatics(tarch), _t(cond), _t(text), _t(lens),
                              _t(dur), make_time_grid(nfe, sway_sampling_coef=-1.0), y0=_t(y0),
                              cfg_strength=2.0, dtype=torch.float32,
                              backbone=tcfm.BACKBONES["MMDiT"]))
    for i in range(b):
        np.testing.assert_array_equal(got[i, :lens[i]], cond[i, :lens[i]])
    # f32 through 4 steps of a 2-block MMDiT: sum-order drift only
    np.testing.assert_allclose(_live(got, dur), _live(want, dur), atol=2e-3, rtol=1e-3)
    assert np.abs(_live(got, dur) - _live(y0, dur)).max() > 0.1


def test_mmdit_qk_norm_pipeline_infer_on_cpu(mmdit_qk):
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_pipeline import VOCAB, _ref_wav
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    _, tarch, _, raw = mmdit_qk
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator().manual_seed(0),
                                         tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    pipe = tpipe.InferencePipeline(raw, tmmdit.MMDiTStatics(tarch), voc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=2), tokenizer="char",
                                   dtype=torch.float32, device="cpu", backbone="MMDiT")
    assert "q_norm" in pipe.params["blocks"][0]["attn"]
    wave, sr, mel = pipe.infer(_ref_wav(), 24000, "a quiet voice.", "hello there.",
                               nfe_step=2, fix_duration=2.0)
    assert sr == 24000 and np.isfinite(wave).all() and np.abs(wave).max() > 0
    assert mel.shape[0] == 100 and len(wave) > 0
