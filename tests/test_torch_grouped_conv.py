"""The generic grouped conv1d (kernel K10's plain version) and the dim-768
presets' conv-position path against the JAX package on the CPU.

Kernel level: `grouped_conv1d_ref` and the `grouped_conv1d` wrapper (CPU
tensors: the plain version) against the Pallas `grouped_conv1d_pallas` in
interpret mode and the XLA `_xla_grouped_conv`, at W = c / groups in
{48, 64, 24} and k in {31, 7, 4} (odd and even: same padding puts
(k - 1) // 2 rows before); the wrapper's gradient against
`jax.vjp(grouped_conv1d)`. Module level: `conv_pos_embedding` at c = 768,
16 groups, under a length mask; the DiT (dim 768, 12 x 64 heads, depth 2)
and UNetT forwards, whose input embedding runs the unfused chain, against
the JAX XLA path (`backend="xla"`); one `InferencePipeline.infer` smoke at
dim 768. Weights and inputs are drawn from numpy seeds; both sides in f32
unless stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.ops import grouped_conv as jgc
from f5tts_tpu_torch.config import PRESETS, ModelArch as TArch
from f5tts_tpu_torch.convert import dit_params_from_jax, unett_params_from_jax
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models import unett as tunett
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import grouped_conv as tgc
from tests.test_torch_dit import _live, _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the dim-768 presets' shape: 12 heads of 64, 16 conv groups of 48 channels
SMALL768 = dict(dim=768, depth=2, heads=12, dim_head=64, ff_mult=2, text_dim=64,
                conv_layers=1, text_num_embeds=32)


def _conv_inputs(width, k, groups=2, b=2, n=40, seed=0):
    rng = np.random.default_rng(seed)
    c = width * groups
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal((k, width, c)) / np.sqrt(width * k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w, bias, groups


@pytest.mark.parametrize("width", [48, 64, 24])
@pytest.mark.parametrize("k", [31, 7, 4])
def test_grouped_conv1d_plain_matches_pallas_and_xla(width, k):
    x, w, bias, groups = _conv_inputs(width, k)
    pallas = np.asarray(jgc.grouped_conv1d_pallas(jnp.asarray(x), jnp.asarray(w),
                                                  jnp.asarray(bias), groups))
    xla = np.asarray(jgc._xla_grouped_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                           groups))
    ref = _np(tgc.grouped_conv1d_ref(_t(x), _t(w), _t(bias), groups))
    got = _np(tgc.grouped_conv1d(_t(x), _t(w), _t(bias), groups))
    assert got.shape == pallas.shape == x.shape
    # f32 sums of k * W products, |y| < ~5: sum-order differences only
    np.testing.assert_allclose(ref, pallas, atol=2e-5)
    np.testing.assert_allclose(ref, xla, atol=2e-5)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("width,k", [(48, 31), (24, 4)])
def test_grouped_conv1d_bf16_within_one_ulp_of_pallas(width, k):
    """bf16 in: the wrapper adds the bias in f32 and rounds once (K10's
    rounding); the Pallas path rounds the conv, then the sum with a bf16
    bias. So they are at most 1.5 bf16 ulps (2^-8 relative each) of the
    larger of |conv| and |y| apart."""
    x, w, bias, groups = _conv_inputs(width, k, seed=1)
    xb, wb, bb = (_t(a).to(torch.bfloat16) for a in (x, w, bias))
    got = _np(tgc.grouped_conv1d(xb, wb, bb, groups).float())
    want = np.asarray(jgc.grouped_conv1d_pallas(
        *(jnp.asarray(_np(t.float()), jnp.bfloat16) for t in (xb, wb, bb)), groups)
    ).astype(np.float32)
    mag = np.maximum(np.abs(want), np.abs(want - _np(bb.float())))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= 1.5 * ulp + 1e-6)


@pytest.mark.parametrize("width,k", [(48, 31), (24, 4)])
def test_grouped_conv1d_grad_matches_jax_vjp(width, k):
    x, w, bias, groups = _conv_inputs(width, k, seed=2)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: jgc.grouped_conv1d(a, b_, c, groups),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy))
    xs = [_t(a).requires_grad_() for a in (x, w, bias)]
    got = torch.autograd.grad(tgc.grouped_conv1d(*xs, groups), xs, _t(dy))
    for g, wv in zip(got, want):
        # f32 sums of up to b * n * k products: relative
        np.testing.assert_allclose(_np(g), np.asarray(wv), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,groups,k", [(1024, 16, 31), (768, 16, 31), (128, 2, 31),
                                        (1024, 16, 7), (1000, 16, 31)])
def test_supports_fused_conv_pos_mirrors_jax(c, groups, k, monkeypatch):
    """The JAX gate as it decides on a TPU (n = 1024, a multiple of 8)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert tgc.supports_fused_conv_pos(c, groups, k) == jgc.supports_fused_conv_pos(c, groups,
                                                                                    1024, k)


def test_grouped_conv1d_wrapper_cpu_plain_and_refuses_other_devices():
    x, w, bias, groups = _conv_inputs(48, 31)
    _build.reset_launches()
    tgc.grouped_conv1d(_t(x), _t(w), _t(bias), groups)
    assert _build.launches() == {}
    meta = torch.empty(1, 8, 96, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgc.grouped_conv1d(meta, meta, meta, 2)


@pytest.mark.parametrize("masked", [True, False])
def test_conv_pos_embedding_768_matches_jax(masked):
    """c = 768, 16 groups of 48 channels: the unfused chain (mask, conv +
    bias, mask, Mish, conv, mask, Mish), not K2."""
    tree = np_params(lambda: jm.init_conv_pos_embedding(jax.random.PRNGKey(0), 768), 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 96, 768)).astype(np.float32)
    lens = np.array([96, 61], np.int32)
    mask = np.arange(96)[None, :] < lens[:, None]
    want = np.asarray(jm.conv_pos_embedding(jx(tree), jnp.asarray(x),
                                            jnp.asarray(mask) if masked else None))
    got = _np(tm.conv_pos_embedding(tm.tree_map(_t, tree), _t(x), _t(lens) if masked else None))
    # f32, |y| < ~3: sum orders of two 1488-term convs
    np.testing.assert_allclose(got, want, atol=5e-5)
    if masked:
        assert not got[1, 61:].any()


@pytest.fixture(scope="module")
def dit768():
    jarch = JArch(**SMALL768)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 0)
    return jarch, TArch(**SMALL768), tree, tm.fuse_backbone_qkv(dit_params_from_jax(tree))


def test_dit_768_forward_matches_jax(dit768):
    jarch, tarch, tree, tp = dit768
    rng = np.random.default_rng(8)
    b, n = 2, 128
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 40:] = 0
    text = rng.integers(0, 32, (b, 48)).astype(np.int32)
    text[0, 30:] = -1
    lens = np.array([n, 101], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    fwd = jax.jit(functools.partial(jdit.dit_forward, statics=jdit.DiTStatics(jarch),
                                    cfg_infer=True, backend="xla"))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens)))
    got = _np(tdit.dit_forward(tp, tdit.DiTStatics(tarch), _t(x), _t(cond), _t(text), _t(time),
                               lengths=_t(lens), cfg_infer=True))
    lens2 = np.concatenate([lens, lens])
    # f32 on both sides, outputs O(1-10): sum-order differences, relative
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=5e-4, rtol=2e-4)
    assert np.abs(_live(want, lens2)).max() > 0.1


def test_unett_768_forward_matches_jax():
    kw = dict(SMALL768, text_dim=None, conv_layers=0, text_mask_padding=False)
    jarch = JArch(**kw)
    tree = np_params(lambda: junett.init_unett(jax.random.PRNGKey(0), jarch), 1)
    tp = tm.fuse_backbone_qkv(unett_params_from_jax(tree))
    rng = np.random.default_rng(9)
    b, n = 2, 127  # + the time token: one 128-row bucket
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, 40)).astype(np.int32)
    lens = np.array([n, 90], np.int32)
    time = np.array([0.2, 0.6], np.float32)
    fwd = jax.jit(functools.partial(junett.unett_forward, statics=junett.UNetTStatics(jarch),
                                    cfg_infer=True, backend="xla"))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens)))
    got = _np(tunett.unett_forward(tp, tunett.UNetTStatics(TArch(**kw)), _t(x), _t(cond),
                                   _t(text), _t(time), lengths=_t(lens), cfg_infer=True))
    lens2 = np.concatenate([lens, lens])
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=5e-4, rtol=2e-4)
    assert np.abs(_live(want, lens2)).max() > 0.1


def test_small_presets_take_the_generic_conv():
    for name in ("F5TTS_v1_Small", "F5TTS_Small", "E2TTS_Small"):
        arch = PRESETS[name].arch
        assert not tgc.supports_fused_conv_pos(arch.dim, 16, 31)
        assert (arch.dim // 16) % 8 == 0 and arch.dim // 16 <= tgc.MAX_WIDTH
    for name in ("F5TTS_v1_Base", "F5TTS_Base", "E2TTS_Base", "MMDiT_Base"):
        assert tgc.supports_fused_conv_pos(PRESETS[name].arch.dim, 16, 31)


def test_dit_768_pipeline_infer_on_cpu(dit768):
    """One InferencePipeline.infer smoke at the F5TTS_v1_Small widths (depth 2)."""
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_pipeline import VOCAB, _ref_wav
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    _, tarch, _, tp = dit768
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator().manual_seed(0),
                                         tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    pipe = tpipe.InferencePipeline(tp, tdit.DiTStatics(tarch), voc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=2), tokenizer="char",
                                   dtype=torch.float32, device="cpu")
    wave, sr, mel = pipe.infer(_ref_wav(), 24000, "a quiet voice.", "hello there.",
                               nfe_step=2, fix_duration=2.0)
    assert sr == 24000 and np.isfinite(wave).all() and np.abs(wave).max() > 0
    assert mel.shape[0] == 100 and len(wave) > 0
