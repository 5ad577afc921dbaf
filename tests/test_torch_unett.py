"""Port UNetT (E2-TTS) and the shared attention modules against the JAX
package on the CPU.

Same numpy-seeded weights on both sides (`tests.test_torch_dit.np_params`:
drawn in the JAX init's tree layout, RMSNorm weights 1 + 0.1 N(0, 1)),
converted by
`convert.unett_params_from_jax` and QKV-fused as the pipeline fuses them.
The JAX side runs its XLA path in f32 (`backend="xla"`), the port its plain
versions (CPU tensors) in f32. Small shapes: dim 128, depth 2 (one block a
half), heads 2 x 64, the mel width as text width.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.config import PRESETS, ModelArch as TArch
from f5tts_tpu_torch.convert import unett_params_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models import unett as tunett
from f5tts_tpu_torch.ops.rope import rope_flat_tables
from f5tts_tpu_torch.utils import make_time_grid
from tests.test_torch_dit import _live, _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=None,
             conv_layers=0, text_num_embeds=32, text_mask_padding=False)
# f32 on both sides; outputs are O(1): the differences are sum orders
ATOL = 2e-4


def small_unett(seed: int = 0):
    """(JAX arch, port arch, numpy JAX params, port params with fused QKV)."""
    jarch = JArch(**SMALL)
    tree = np_params(lambda: junett.init_unett(jax.random.PRNGKey(seed), jarch), seed)
    return jarch, TArch(**SMALL), tree, tm.fuse_backbone_qkv(unett_params_from_jax(tree))


@pytest.fixture(scope="module")
def model():
    return small_unett()


def test_converter_and_fusion(model):
    jarch, _, tree, tp = model
    assert len(tp["first_half"]) == len(tp["second_half"]) == jarch.depth // 2
    raw = unett_params_from_jax(tree)
    np.testing.assert_array_equal(_np(raw["second_half"][0]["skip_proj"]["w"]),
                                  tree["second_half"]["skip_proj"]["w"][0])
    np.testing.assert_array_equal(_np(raw["first_half"][0]["attn_norm"]["w"]),
                                  tree["first_half"]["attn_norm"]["w"][0])
    # fused and unfused JAX trees convert to the same fused port params
    fused_j = unett_params_from_jax(jax.tree.map(np.asarray, jm.fuse_backbone_qkv(tree)))
    for half in ("first_half", "second_half"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(_np(fused_j[half][0]["attn"]["to_qkv"][k]),
                                          _np(tp[half][0]["attn"]["to_qkv"][k]))
        assert "to_q" not in tp[half][0]["attn"]


def test_init_unett_shapes_match_jax():
    jarch = JArch(**dict(SMALL, depth=4))
    jt = jax.eval_shape(lambda: junett.init_unett(jax.random.PRNGKey(0), jarch))
    tp = tunett.init_unett(torch.Generator().manual_seed(0), TArch(**dict(SMALL, depth=4)))
    conv = unett_params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jt))
    assert tm.tree_map(lambda a: tuple(a.shape), tp) == tm.tree_map(lambda a: tuple(a.shape), conv)
    with pytest.raises(ValueError, match="even"):
        tunett.init_unett(torch.Generator(), TArch(**dict(SMALL, depth=3)))


def test_presets_match_jax():
    from f5tts_tpu.config import PRESETS as JPRESETS

    names = ("F5TTS_v1_Base", "F5TTS_Base", "F5TTS_v1_Small", "F5TTS_Small", "E2TTS_Base",
             "E2TTS_Small", "MMDiT_Base")
    assert set(PRESETS) == set(names) <= set(JPRESETS)
    for name in names:
        t, j = PRESETS[name], JPRESETS[name]
        assert t.backbone == j.backbone
        ja = dataclasses.asdict(j.arch)
        assert dataclasses.asdict(t.arch) == {k: ja[k] for k in dataclasses.asdict(t.arch)}
    assert TArch(qk_norm="rms_norm").qk_norm == "rms_norm"
    with pytest.raises(ValueError, match="qk_norm"):
        TArch(qk_norm="layer_norm")


def test_rms_norm_module_matches_jax(model):
    _, _, tree, tp = model
    x = np.random.default_rng(4).standard_normal((2, 40, 128)).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], jx(tree["first_half"]["ff_norm"]))
    np.testing.assert_allclose(
        _np(tm.rms_norm(tp["first_half"][0]["ff_norm"], _t(x), eps=1e-8)),
        np.asarray(jm.rms_norm(p_j, jnp.asarray(x), eps=1e-8)), atol=1e-5)


@pytest.mark.parametrize("gate", ["flat", "heads"])
def test_self_attention_gates_match_jax(model, gate, monkeypatch):
    """The flat gate (K3's plain version) and the head-split gate (rope, head
    split, K7's plain version) against the JAX self_attention's XLA path."""
    jarch, tarch, tree, tp = model
    calls = []
    real = tm.attention
    monkeypatch.setattr(tm, "attention", lambda *a: calls.append(1) or real(*a))
    if gate == "heads":  # the gate at 4096 rows, lowered to reach it at n = 256
        monkeypatch.setattr(tm, "FLAT_ATTN_MAX_N", 128)
    rng = np.random.default_rng(6)
    n = 256
    x = rng.standard_normal((2, n, 128)).astype(np.float32)
    lens = np.array([n, 177], np.int32)
    attn_j = jax.tree.map(lambda a: a[0], jx(tree["first_half"]["attn"]))
    statics = junett.UNetTStatics(jarch)
    want = np.asarray(jm.self_attention(attn_j, jnp.asarray(x), 2, statics.rope_angles[:n],
                                        jnp.asarray(lens), backend="xla"))
    angles = tunett.UNetTStatics(tarch).rope_angles
    tabs = rope_flat_tables(angles, n, 2, dtype=torch.float32)
    got = _np(tm.self_attention(tp["first_half"][0]["attn"], _t(x), 2, tabs, _t(lens), angles))
    assert len(calls) == (gate == "heads")
    np.testing.assert_allclose(_live(got, lens), _live(want, lens), atol=ATOL, rtol=1e-4)
    assert not got[1, 177:].any()


@pytest.mark.parametrize("cfg_infer", [True, False])
def test_unett_forward_matches_jax(model, cfg_infer):
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(8)
    # 255 frames + the time token fill 256 rows; 250 + 1 are padded to 256
    b, n = 2, (250 if cfg_infer else 255)
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 80:] = 0
    text = rng.integers(0, 32, (b, 64)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 201], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    drop = {} if cfg_infer else {"drop_audio_cond": True, "drop_text": True}
    fwd = jax.jit(functools.partial(junett.unett_forward, statics=junett.UNetTStatics(jarch),
                                    cfg_infer=cfg_infer, backend="xla", **drop))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens)))
    got = _np(tunett.unett_forward(tp, tunett.UNetTStatics(tarch), _t(x), _t(cond), _t(text),
                                   _t(time), lengths=_t(lens), cfg_infer=cfg_infer, **drop))
    assert got.shape == want.shape == ((2 if cfg_infer else 1) * b, n, 100)
    lens2 = np.concatenate([lens, lens]) if cfg_infer else lens
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=ATOL, rtol=1e-4)
    assert np.abs(_live(want, lens2)).max() > 0.1


def test_unett_cfm_sample_matches_jax(model):
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(11)
    b, n, nfe = 2, 255, 4
    lens = np.array([60, 90], np.int32)
    dur = np.array([255, 201], np.int32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, 80)).astype(np.int32)
    text[1, 70:] = -1
    y0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    y0[1, 201:] = 0
    want = np.asarray(jcfm.cfm_sample(
        jx(tree), junett.UNetTStatics(jarch), jnp.asarray(cond), jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(dur), j_make_time_grid(nfe, sway_sampling_coef=-1.0),
        y0=jnp.asarray(y0), cfg_strength=2.0, dtype=jnp.float32, backend="xla",
        backbone=jcfm.BACKBONES["UNetT"]))
    got = _np(tcfm.cfm_sample(tp, tunett.UNetTStatics(tarch), _t(cond), _t(text), _t(lens),
                              _t(dur), make_time_grid(nfe, sway_sampling_coef=-1.0), y0=_t(y0),
                              cfg_strength=2.0, dtype=torch.float32,
                              backbone=tcfm.BACKBONES["UNetT"]))
    for i in range(b):
        np.testing.assert_array_equal(got[i, :lens[i]], cond[i, :lens[i]])
    # f32 through 4 steps of a 2-block UNetT: sum-order drift only
    np.testing.assert_allclose(_live(got, dur), _live(want, dur), atol=2e-3, rtol=1e-3)
    assert np.abs(_live(got, dur) - _live(y0, dur)).max() > 0.1


def test_unett_pipeline_infer_on_cpu(model):
    """One InferencePipeline.infer smoke at tiny size: the UNetT bucket keeps
    frames + the time token a bucket multiple."""
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_pipeline import VOCAB, _ref_wav
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    _, tarch, _, tp = model
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator().manual_seed(0),
                                         tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    pipe = tpipe.InferencePipeline(tp, tunett.UNetTStatics(tarch), voc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=2), tokenizer="char",
                                   dtype=torch.float32, device="cpu", backbone="UNetT")
    wave, sr, mel = pipe.infer(_ref_wav(), 24000, "a quiet voice.", "hello there.",
                               nfe_step=2, fix_duration=2.0)
    assert sr == 24000 and np.isfinite(wave).all() and np.abs(wave).max() > 0
    assert mel.shape[0] == 100 and len(wave) > 0
