"""The pipeline's one-dispatch generate (`InferencePipeline.fused_generate`)
on the CPU, where its static buffers feed the body directly (on a card they
feed one CUDA graph per key; `tests/test_torch_cuda.py` holds a replay
against the eager path).

- against the JAX pipeline's `_fused` computation (`cfm_sample(..., y0=)`
  with the port's noise, then the JAX Vocos), for the DiT, the UNetT and the
  MMDiT, same numpy-seeded weights: mel and wav in f32;
- a long request and then a shorter one in the same bucket give what fresh
  eager calls give (the static buffers keep no stale rows);
- the key: a new text bucket or NFE makes a new one, a change of CFG
  strength or sway reuses it, and the new values still take effect.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch.config import SamplingConfig
from f5tts_tpu_torch.convert import vocos_params_from_jax
from f5tts_tpu_torch.infer import pipeline as tpipe
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.utils import make_time_grid
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import _np, _t, jx, np_params, small_dit
from tests.test_torch_mmdit import small_mmdit
from tests.test_torch_pipeline import VOCAB, _ref_wav
from tests.test_torch_unett import small_unett
from tests.test_torch_vocos_mel import SMALL_VOCOS
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = {"DiT": small_dit, "UNetT": small_unett, "MMDiT": small_mmdit}


@pytest.fixture(scope="module")
def vocoders():
    jvcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jvcfg), 4)
    return (jvocos.Vocos(jx(vtree), jvcfg),
            tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**SMALL_VOCOS),
                         device="cpu"))


def _pipeline(backbone: str, voc, nfe: int = 4, **arch_over):
    """(port pipeline on the CPU in f32, JAX arch, numpy JAX params); the
    port's arch with `arch_over`."""
    jarch, tarch, tree, tp = SMALL[backbone](seed=3)
    tarch = dataclasses.replace(tarch, **arch_over)
    return tpipe.InferencePipeline(tp, tcfm.BACKBONES[backbone].statics_cls(tarch), voc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=nfe), tokenizer="char",
                                   dtype=torch.float32, device="cpu", backbone=backbone), jarch, tree


def _request(rng, b: int, n: int, nt: int, lens, dur, text_len):
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, nt)).astype(np.int32)
    for i, t in enumerate(text_len):
        text[i, t:] = -1
    y0 = _np(tcfm.make_noise(torch.Generator().manual_seed(int(rng.integers(1 << 30))), b, n,
                             100, _t(np.asarray(dur, np.int32)), noise_max_len=512))
    return cond, text, np.asarray(lens, np.int32), np.asarray(dur, np.int32), y0


def _live(a, lengths):
    return np.concatenate([a[i, :l] for i, l in enumerate(lengths)], axis=0)


@pytest.mark.parametrize("backbone", ["DiT", "UNetT", "MMDiT"])
def test_fused_generate_matches_jax_fused(backbone, vocoders):
    jvoc, tvoc = vocoders
    pipe, jarch, tree = _pipeline(backbone, tvoc)
    n = 256 - tcfm.BACKBONES[backbone].seq_extra_tokens  # a bucket of the pipeline
    cond, text, lens, dur, y0 = _request(np.random.default_rng(11), 2, n, 64, [60, 90],
                                         [n, 201], [64, 40])
    grid = make_time_grid(4, sway_sampling_coef=-1.0)
    mel, wav = pipe.fused_generate(_t(cond), _t(text), _t(lens), _t(dur), grid, _t(y0), 2.0)

    # the JAX `_fused`: cfm_sample with the port's noise, then the vocoder
    jbd = jcfm.BACKBONES[backbone]
    want_mel = jcfm.cfm_sample(
        jx(tree), jbd.statics_cls(jarch), jnp.asarray(cond), jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(dur), j_make_time_grid(4, sway_sampling_coef=-1.0),
        y0=jnp.asarray(y0), cfg_strength=jnp.float32(2.0), dtype=jnp.float32, backend="xla",
        backbone=jbd)
    want_wav = np.asarray(jvoc(jnp.transpose(want_mel, (0, 2, 1))))
    want_mel = np.asarray(want_mel)
    got_mel, got_wav = _np(mel), _np(wav)
    assert got_mel.shape == want_mel.shape and got_wav.shape == want_wav.shape
    # f32 through 4 steps of a 2-block backbone: sum-order drift only; the
    # wav to 1e-3 of its peak
    np.testing.assert_allclose(_live(got_mel, dur), _live(want_mel, dur), atol=2e-3, rtol=1e-3)
    hop_dur = [int(d) * 256 for d in dur]
    np.testing.assert_allclose(_live(got_wav, hop_dur), _live(want_wav, hop_dur),
                               atol=1e-3 * np.abs(want_wav).max())
    assert list(pipe.graphs) == [(2, n, 64, 4)]


def _eager(pipe, cond, text, lens, dur, grid, y0, cfg):
    mel = tcfm.cfm_sample(pipe.params, pipe.statics, _t(cond), _t(text), _t(lens), _t(dur), grid,
                          y0=_t(y0), cfg_strength=cfg, dtype=torch.float32, backbone=pipe.bdef)
    return _np(mel), _np(pipe.vocoder(mel.transpose(1, 2)))


@pytest.mark.parametrize("backbone,upsample", [("DiT", False), ("MMDiT", False), ("DiT", True)])
def test_shorter_request_in_a_bucket_leaves_no_stale_rows(backbone, upsample, vocoders):
    # with text_embedding_average_upsampling the text spreads over each
    # request's own duration, which the body reads from the static buffers
    pipe, _, _ = _pipeline(backbone, vocoders[1],
                           **({"text_embedding_average_upsampling": True} if upsample else {}))
    rng = np.random.default_rng(5)
    grid = make_time_grid(3, sway_sampling_coef=-1.0)
    long = _request(rng, 1, 256, 128, [120], [256], [128])
    short = _request(rng, 1, 256, 128, [30], [140], [70])
    outs = [pipe.fused_generate(*map(_t, req[:4]), grid, _t(req[4]), 2.0) for req in (long, short)]
    assert len(pipe.graphs) == 1
    for req, (mel, wav) in zip((long, short), outs):
        want_mel, want_wav = _eager(pipe, *req[:4], grid, req[4], 2.0)
        np.testing.assert_allclose(_np(mel), want_mel, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(wav), want_wav, atol=1e-5, rtol=1e-5)
    # the short request's rows past its duration hold its own noise-free
    # sample, not the long one's
    assert np.abs(_np(outs[1][0])[0, 140:] - _np(outs[0][0])[0, 140:]).max() > 1e-3
    if upsample:  # each request's text spread over its own duration
        from f5tts_tpu_torch.models import dit as tdit

        embeds = [tdit.text_embedding(pipe.params["text_embed"], pipe.statics, _t(req[1]), 256,
                                      lengths=_t(req[3])) for req in (long, short)]
        assert embeds[0][0, 255].any() and not embeds[1][0, 140:].any()
        assert embeds[1][0, 139].any()


def test_keys_follow_buckets_and_nfe_not_cfg_or_sway(vocoders):
    pipe, _, _ = _pipeline("DiT", vocoders[1], nfe=2)
    ref = _ref_wav()
    kw = dict(seed=4, fix_duration=1.6)
    base = pipe.generate_chunk(ref, "a quiet voice. ", "hello there.", **kw)
    keys = set(pipe.graphs)
    assert len(keys) == 1
    (b, n, nt, nfe), = keys
    assert (b, nt, nfe) == (1, 64, 2)

    # CFG strength and sway change values, not shapes: the same key, new results
    for extra in (dict(cfg_strength=1.0), dict(sway_sampling_coef=0.5)):
        wave, mel = pipe.generate_chunk(ref, "a quiet voice. ", "hello there.", **kw, **extra)
        assert set(pipe.graphs) == keys
        assert np.abs(mel - base[1]).max() > 1e-3
        req = pipe.prepare_chunk(ref, "a quiet voice. ", "hello there.", **kw, **extra)
        want_mel, _ = _eager(pipe, *(_np(req[k]) for k in ("cond", "text", "lens", "duration")),
                             req["t_grid"], _np(req["y0"]), req["cfg_strength"])
        np.testing.assert_allclose(mel, want_mel[0, req["ref_frames"]:req["total"]].T,
                                   atol=1e-5, rtol=1e-5)

    pipe.generate_chunk(ref, "a quiet voice. ", "hello there.", nfe_step=3, **kw)
    assert (1, n, 64, 3) in pipe.graphs and len(pipe.graphs) == 2
    pipe.generate_chunk(ref, "a quiet voice. ", "hello there, " * 6, **kw)  # > 64 text ids
    assert (1, n, 128, 2) in pipe.graphs and len(pipe.graphs) == 3


def test_cfm_sample_takes_cfg_strength_as_a_tensor():
    _, tarch, _, tp = small_dit(seed=1)
    statics = tcfm.BACKBONES["DiT"].statics_cls(tarch)
    cond, text, lens, dur, y0 = _request(np.random.default_rng(2), 1, 128, 64, [20], [100], [30])
    grid = make_time_grid(2, sway_sampling_coef=-1.0)
    outs = [_np(tcfm.cfm_sample(tp, statics, _t(cond), _t(text), _t(lens), _t(dur), grid,
                                y0=_t(y0), cfg_strength=cfg, dtype=torch.float32))
            for cfg in (1.5, torch.tensor(1.5))]
    np.testing.assert_array_equal(outs[0], outs[1])
