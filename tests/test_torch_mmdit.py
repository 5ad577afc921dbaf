"""Port MMDiT against the JAX MMDiT on the CPU.

Same numpy-seeded weights on both sides (`tests.test_torch_dit.np_params`:
the zero-initialised AdaLN, norm_out and proj_out leaves random too),
converted by `convert.mmdit_params_from_jax` and QKV-fused (to_qkv and
to_qkv_c) as the pipeline fuses them. The JAX side runs its XLA path in f32
(`backend="xla"`: no text padding, `mha_reference_masked`); the port pads the
text stream to a 128-row joint length and runs K5's plain version, f32.
Small shapes: dim 128, depth 2 (one block + the context_pre_only last
block), heads 2 x 64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import mmdit_params_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import mmdit as tmmdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.utils import make_time_grid
from tests.test_torch_dit import _live, _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=None,
             conv_layers=0, text_num_embeds=32, text_mask_padding=True)
# f32 on both sides; the random AdaLN gates scale the stream, so the outputs
# are O(1-10): sum-order differences, relative
ATOL, RTOL = 2e-4, 2e-4


def small_mmdit(seed: int = 0):
    """(JAX arch, port arch, numpy JAX params, port params with fused QKV)."""
    jarch = JArch(**SMALL)
    tree = np_params(lambda: jmmdit.init_mmdit(jax.random.PRNGKey(seed), jarch), seed)
    return jarch, TArch(**SMALL), tree, tm.fuse_backbone_qkv(mmdit_params_from_jax(tree))


@pytest.fixture(scope="module")
def model():
    return small_mmdit()


def test_converter_and_fusion(model):
    jarch, _, tree, tp = model
    assert len(tp["blocks"]) == jarch.depth - 1
    assert "to_out_c" not in tp["last_block"]["attn"] and "ff_c" not in tp["last_block"]
    fused_j = mmdit_params_from_jax(jax.tree.map(np.asarray, jm.fuse_backbone_qkv(tree)))
    for got, want in ((tp["blocks"][0], fused_j["blocks"][0]), (tp["last_block"],
                                                               fused_j["last_block"])):
        for name in ("to_qkv", "to_qkv_c"):
            for k in ("w", "b"):
                np.testing.assert_array_equal(_np(got["attn"][name][k]),
                                              _np(want["attn"][name][k]))
        assert not {"to_q", "to_q_c", "to_v_c"} & set(got["attn"])


def test_init_mmdit_shapes_match_jax():
    jarch = JArch(**dict(SMALL, depth=3))
    jt = jax.eval_shape(lambda: jmmdit.init_mmdit(jax.random.PRNGKey(0), jarch))
    tp = tmmdit.init_mmdit(torch.Generator().manual_seed(0), TArch(**dict(SMALL, depth=3)))
    conv = mmdit_params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jt))
    assert tm.tree_map(lambda a: tuple(a.shape), tp) == tm.tree_map(lambda a: tuple(a.shape), conv)
    assert not tp["blocks"][0]["attn_norm_x"]["linear"]["w"].any()  # AdaLN-zero


@pytest.mark.parametrize("drop_text,nt", [(False, 90), (True, 90), (False, 1100)])
def test_text_embedding_matches_jax(model, drop_text, nt):
    """nt 1100 passes the 1024-row position table: clamped at its edge."""
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(7)
    text = rng.integers(0, 32, (2, nt)).astype(np.int32)
    text[1, 60:] = -1
    want = np.asarray(jmmdit.mmdit_text_embedding(jx(tree["text_embed"]),
                                                  jmmdit.MMDiTStatics(jarch), jnp.asarray(text),
                                                  drop_text))
    got = _np(tmmdit.mmdit_text_embedding(tp["text_embed"], tmmdit.MMDiTStatics(tarch), _t(text),
                                          drop_text))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_precompute_t_mods_matches_jax(model):
    _, _, tree, tp = model
    t = np.array([0.0, 0.1, 0.55, 0.9], np.float32)
    at_j = jmmdit.mmdit_precompute_t_mods(jx(tree), jnp.asarray(t), 2, dtype=jnp.float32)
    at_t = tmmdit.mmdit_precompute_t_mods(tp, _t(t), 2, dtype=torch.float32)
    for i in (0, 3):
        want, got = at_j(i), at_t(i)
        for k in ("blocks_x", "blocks_c", "last_x", "last_c", "final"):
            assert tuple(got[k].shape) == tuple(want[k].shape)
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hoisted,cfg_infer", [(False, True), (True, True), (False, False)])
def test_mmdit_forward_matches_jax(model, hoisted, cfg_infer):
    """Ragged audio lengths (dead keys mid joint sequence) and padded text;
    the port pads 200 + 70 joint rows to 384."""
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(8)
    b, n = 2, 200
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 80:] = 0
    text = rng.integers(0, 32, (b, 70)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 141], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    kw_j, kw_t = {}, {}
    if hoisted:
        kw_j["t_mods"] = jmmdit.mmdit_precompute_t_mods(jx(tree), jnp.asarray(time[:1]), 2 * b,
                                                        dtype=jnp.float32)(0)
        kw_t["t_mods"] = tmmdit.mmdit_precompute_t_mods(tp, _t(time[:1]), 2 * b,
                                                        dtype=torch.float32)(0)
        time = np.full((b,), time[0], np.float32)
    drop = {} if cfg_infer else {"drop_audio_cond": True, "drop_text": True}
    fwd = jax.jit(functools.partial(jmmdit.mmdit_forward, statics=jmmdit.MMDiTStatics(jarch),
                                    cfg_infer=cfg_infer, backend="xla", **drop))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens), **kw_j))
    got = _np(tmmdit.mmdit_forward(tp, tmmdit.MMDiTStatics(tarch), _t(x), _t(cond), _t(text),
                                   _t(time), lengths=_t(lens), cfg_infer=cfg_infer, **drop,
                                   **kw_t))
    assert got.shape == want.shape == ((2 if cfg_infer else 1) * b, n, 100)
    lens2 = np.concatenate([lens, lens]) if cfg_infer else lens
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=ATOL, rtol=RTOL)
    assert np.abs(_live(want, lens2)).max() > 0.1


def test_mmdit_cfm_sample_matches_jax(model):
    jarch, tarch, tree, tp = model
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


def test_mmdit_pipeline_infer_on_cpu(model):
    """One InferencePipeline.infer smoke at tiny size."""
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_pipeline import VOCAB, _ref_wav
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    _, tarch, _, tp = model
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator().manual_seed(0),
                                         tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    pipe = tpipe.InferencePipeline(tp, tmmdit.MMDiTStatics(tarch), voc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=2), tokenizer="char",
                                   dtype=torch.float32, device="cpu", backbone="MMDiT")
    wave, sr, mel = pipe.infer(_ref_wav(), 24000, "a quiet voice.", "hello there.",
                               nfe_step=2, fix_duration=2.0)
    assert sr == 24000 and np.isfinite(wave).all() and np.abs(wave).max() > 0
    assert mel.shape[0] == 100 and len(wave) > 0
