"""The port's BigVGAN vocoder and bigvgan (Slaney) mel against the JAX
package on the CPU (f32).

The anti-aliasing filter bit-equal; the 2x resamplers and snakebeta to
1e-6; the generator at small configs on the same numpy-seeded weights
(`bigvgan_params_from_jax`) to 1e-4; `convert_bigvgan_state_dict` on a
numpy-built reference-key dict with weight_g / weight_v equal to the JAX
conversion; the bigvgan `MelFrontend`, `NumpyMel` and the pipeline's
`ref_mel` to 1e-4; an `InferencePipeline` smoke with the bigvgan mel and a
small BigVGAN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import MelConfig as JMelConfig
from f5tts_tpu.infer import pipeline as jpipe
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.ops import mel as jmel
from f5tts_tpu.train import dataset as jds
from f5tts_tpu.vocoder import bigvgan as jbig
from f5tts_tpu_torch.config import MelConfig, SamplingConfig
from f5tts_tpu_torch.convert import bigvgan_params_from_jax
from f5tts_tpu_torch.infer import pipeline as tpipe
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.ops import mel as tmel
from f5tts_tpu_torch.train import dataset as tds
from f5tts_tpu_torch.vocoder import bigvgan as tbig
from tests.test_torch_dit import _np, _t, jx, small_dit, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_bigvgan.py's SMALL, one with every AMP kernel and dilation of
# the v2 config at narrow width, and the 100-band input at narrow width
# (the pipeline's)
SMALL = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
             upsample_initial_channel=16, resblock_kernel_sizes=(3,),
             resblock_dilation_sizes=((1, 2),))
SMALL_AMP = dict(SMALL, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3)
SMALL_100 = dict(SMALL_AMP, num_mels=100, upsample_rates=(4, 4, 2, 2, 2, 2),
                 upsample_kernel_sizes=(8, 8, 4, 4, 4, 4), upsample_initial_channel=64)
CONFIGS = {"small": SMALL, "small_amp": SMALL_AMP, "small_100": SMALL_100}
# max-abs on the wav: f32 sum orders; the six-stage config drives the wav
# into the clamp and its drift through six stages reaches ~1.4e-4
GEN_ATOL = {"small": 1e-4, "small_amp": 1e-4, "small_100": 3e-4}


def np_bigvgan(cfg_kw: dict, seed: int = 0):
    """Numpy-seeded weights in the JAX init's tree: conv weights N(0, 1 /
    (dim 1 x k)) (PyTorch's fan-in of both layouts), biases 0.05 N(0, 1),
    snake alpha / beta 0.3 N(0, 1) in log scale."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if leaf.ndim == 3:
            std = 1.0 / np.sqrt(leaf.shape[1] * leaf.shape[2])
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        scale = 0.05 if getattr(path[-1], "key", None) == "b" else 0.3
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
    cfg = jbig.BigVGANConfig(**cfg_kw)
    tree = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: jbig.init_bigvgan(jax.random.PRNGKey(0), cfg)))
    return cfg, tbig.BigVGANConfig(**cfg_kw), tree


def test_filters_bit_equal():
    for args in ((0.25, 0.3, 12), (0.5, 0.6, 12), (0.2, 0.1, 13), (0.0, 0.3, 8), (0.1, 0.05, 32)):
        np.testing.assert_array_equal(tbig.kaiser_sinc_filter1d(*args),
                                      jbig.kaiser_sinc_filter1d(*args))
    np.testing.assert_array_equal(tbig.resample_filter(), jbig._upsample2_filter())
    np.testing.assert_array_equal(tbig.resample_filter(), jbig._downsample2_filter())


def test_resample_and_snakebeta_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 37)).astype(np.float32)
    filt = jbig._upsample2_filter()
    up_j = jbig.upsample1d_2x(jnp.asarray(x), jnp.asarray(filt))
    up_t = tbig.upsample1d_2x(_t(x), _t(filt))
    assert up_t.shape == (2, 6, 74)
    np.testing.assert_allclose(_np(up_t), np.asarray(up_j), atol=1e-6)
    down_j = jbig.downsample1d_2x(up_j, jnp.asarray(filt))
    down_t = tbig.downsample1d_2x(up_t, _t(filt))
    assert down_t.shape == (2, 6, 37)
    np.testing.assert_allclose(_np(down_t), np.asarray(down_j), atol=1e-6)
    alpha, beta = (0.5 * rng.standard_normal(6).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _np(tbig.snakebeta(_t(x), _t(alpha), _t(beta))),
        np.asarray(jbig.snakebeta(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))),
        atol=1e-6)
    np.testing.assert_allclose(
        _np(tbig.aa_snake(_t(x), _t(alpha), _t(beta), _t(filt))),
        np.asarray(jbig.aa_snake(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                 jnp.asarray(filt), jnp.asarray(filt))), atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_matches_jax(name):
    jcfg, tcfg, tree = np_bigvgan(CONFIGS[name], seed=2)
    t = 24
    mel = np.random.default_rng(3).standard_normal((2, jcfg.num_mels, t)).astype(np.float32)
    want = np.asarray(jbig.BigVGAN(jx(tree), jcfg).decode(jnp.asarray(mel)))
    voc = tbig.BigVGAN(bigvgan_params_from_jax(tree), tcfg, device="cpu")
    got = _np(voc(_t(mel)))
    assert got.shape == want.shape == (2, t * int(np.prod(jcfg.upsample_rates)))
    assert np.abs(want).max() > 0.05  # the weights drive the output
    np.testing.assert_allclose(got, want, atol=GEN_ATOL[name])


def test_init_bigvgan_tree_matches_jax():
    cfg_kw = SMALL_AMP
    want = jax.eval_shape(lambda: jbig.init_bigvgan(jax.random.PRNGKey(0),
                                                    jbig.BigVGANConfig(**cfg_kw)))
    got = tbig.init_bigvgan(torch.Generator().manual_seed(0), tbig.BigVGANConfig(**cfg_kw))
    shapes = jax.tree.map(lambda a: tuple(a.shape), got)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), want)
    assert not got["resblocks"][0]["alpha1"][0].any()  # log-scale snake at 0
    # the port keeps every field but snake_logscale, which it fixes at the
    # JAX default (log scale)
    assert jbig.BigVGANConfig().snake_logscale
    assert set(jbig.BigVGANConfig.__dataclass_fields__) - set(
        tbig.BigVGANConfig.__dataclass_fields__) == {"snake_logscale"}
    assert tbig.BigVGANConfig() == tbig.BigVGANConfig(**{
        k: getattr(jbig.BigVGANConfig(), k) for k in tbig.BigVGANConfig.__dataclass_fields__})


def _reference_state_dict(cfg, rng) -> dict:
    """A reference-key generator state dict, weight-normed (weight_g /
    weight_v) but for conv_pre's plain weight, numpy values."""
    sd = {}

    def conv(name, shape, bias=True, norm=True):
        if norm:
            sd[f"{name}.weight_v"] = rng.standard_normal(shape).astype(np.float32)
            sd[f"{name}.weight_g"] = rng.uniform(0.5, 2.0, (shape[0], 1, 1)).astype(np.float32)
        else:
            sd[f"{name}.weight"] = rng.standard_normal(shape).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(shape[1] if "ups" in name
                                                     else shape[0]).astype(np.float32)

    ch = cfg.upsample_initial_channel
    conv("conv_pre", (ch, cfg.num_mels, 7), norm=False)
    n_res = len(cfg.resblock_kernel_sizes)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        conv(f"ups.{i}.0", (c_in, c_out, k))
        for j, (kr, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            m = i * n_res + j
            for d in range(len(dils)):
                conv(f"resblocks.{m}.convs1.{d}", (c_out, c_out, kr))
                conv(f"resblocks.{m}.convs2.{d}", (c_out, c_out, kr))
                for a in (2 * d, 2 * d + 1):
                    for p in ("alpha", "beta"):
                        sd[f"resblocks.{m}.activations.{a}.act.{p}"] = \
                            rng.standard_normal(c_out).astype(np.float32)
    c_final = ch // 2 ** len(cfg.upsample_rates)
    for p in ("alpha", "beta"):
        sd[f"activation_post.act.{p}"] = rng.standard_normal(c_final).astype(np.float32)
    conv("conv_post", (1, c_final, 7), bias=False)
    return sd


@pytest.mark.parametrize("name", ["small", "small_amp"])
def test_convert_state_dict_matches_jax(name):
    jcfg, tcfg, _ = np_bigvgan(CONFIGS[name])
    sd = _reference_state_dict(jcfg, np.random.default_rng(4))
    want = jbig.convert_bigvgan_state_dict(sd, jcfg)
    got = tbig.convert_bigvgan_state_dict(sd, tcfg)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(jax.tree.map(_np, got))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    # the folded weight keeps its direction and takes g's norm per out channel
    w = _np(got["ups"][0]["w"])
    norms = np.sqrt((w ** 2).sum(axis=(1, 2)))
    np.testing.assert_allclose(norms, sd["ups.0.0.weight_g"].reshape(-1), rtol=1e-5)
    # the state dict's tensors are taken as well
    got_t = tbig.convert_bigvgan_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                            tcfg)
    torch.testing.assert_close(got_t["conv_post"]["w"], got["conv_post"]["w"], rtol=0, atol=0)


def test_slaney_filterbank_and_mel_match_jax():
    for norm in (None, "slaney"):
        np.testing.assert_array_equal(
            tmel.mel_filterbank(24000, 1024, 100, mel_scale="slaney", norm=norm),
            jmel.mel_filterbank(24000, 1024, 100, mel_scale="slaney", norm=norm))
    np.testing.assert_array_equal(tmel.filterbank_for(MelConfig(mel_spec_type="bigvgan")),
                                  jmel.mel_filterbank(24000, 1024, 100, mel_scale="slaney",
                                                      norm="slaney"))
    wav = (np.random.default_rng(0).standard_normal((2, 24000)) * 0.1).astype(np.float32)
    jcfg = JMelConfig(mel_spec_type="bigvgan")
    want = np.asarray(jmel.MelFrontend(jcfg)(jnp.asarray(wav)))
    got = _np(tmel.MelFrontend(MelConfig(mel_spec_type="bigvgan"), device="cpu")(_t(wav)))
    assert got.shape == want.shape == (2, 100, 24000 // 256)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the host mel of the training data
    np.testing.assert_allclose(tds.NumpyMel(MelConfig(mel_spec_type="bigvgan"))(wav[0]),
                               jds.NumpyMel(jcfg)(wav[0]), atol=1e-4)
    for n in (24000, 24100, 255, 1000):
        for kind in ("vocos", "bigvgan"):
            assert (MelConfig(mel_spec_type=kind).frames_for_samples(n)
                    == JMelConfig(mel_spec_type=kind).frames_for_samples(n))
    with pytest.raises(ValueError, match="mel_spec_type"):
        tmel.MelFrontend(MelConfig(mel_spec_type="hifigan"), device="cpu")


def _bigvgan_pipelines():
    jarch, tarch, tree, tp = small_dit(seed=2)
    jcfg, tcfg, vtree = np_bigvgan(SMALL_100, seed=6)
    port = tpipe.InferencePipeline(
        tp, tdit.DiTStatics(tarch), tbig.BigVGAN(bigvgan_params_from_jax(vtree), tcfg,
                                                 device="cpu"),
        {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,'!?")},
        mel_cfg=MelConfig(mel_spec_type="bigvgan"), sampling=SamplingConfig(nfe_steps=2),
        tokenizer="char", dtype=torch.float32, device="cpu")
    jax_pipe = jpipe.InferencePipeline(
        jx(tree), jdit.DiTStatics(jarch), jbig.BigVGAN(jx(vtree), jcfg), port.vocab_char_map,
        mel_cfg=JMelConfig(mel_spec_type="bigvgan"), tokenizer="char", dtype=jnp.float32,
        backend="xla")
    return port, jax_pipe


def test_pipeline_with_bigvgan_on_cpu():
    """ref_mel's frames follow the mel (len // 256 for bigvgan, len // 256 +
    1 for vocos) and match the JAX pipeline's; one request through
    `infer` and the graph body's static buffers gives a finite wav of
    frames x 256 samples."""
    from tests.test_torch_pipeline import _ref_wav

    port, jax_pipe = _bigvgan_pipelines()
    for seconds in (1.1, 0.5):
        wav = _ref_wav(seconds)
        got = port.ref_mel(wav)
        assert got.shape == (len(wav) // 256, 100)
        np.testing.assert_allclose(got, jax_pipe.ref_mel(wav), atol=1e-4)
        vocos_pipe = tpipe.InferencePipeline(port.params, port.statics, port.vocoder,
                                             port.vocab_char_map, tokenizer="char",
                                             dtype=torch.float32, device="cpu")
        assert vocos_pipe.ref_mel(wav).shape == (len(wav) // 256 + 1, 100)
    wave, sr, mel = port.infer(_ref_wav(), 24000, "a quiet voice.", "hello there.", seed=1,
                               nfe_step=2, fix_duration=1.5)
    assert sr == 24000 and np.isfinite(wave).all() and np.abs(wave).max() > 0
    (entry,) = port.graphs.values()
    assert entry.wav is None and entry.inputs["y0"].shape[1] == 256  # the CPU: no graph
    total = int(1.5 * 24000 / 256)
    assert len(wave) == (total - len(_ref_wav()) // 256) * 256


def test_bigvgan_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tbig.init_bigvgan(torch.Generator().manual_seed(0), tbig.BigVGANConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbig.BigVGAN(params, tbig.BigVGANConfig(**SMALL))
