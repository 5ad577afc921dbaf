"""Port inference pipeline (f5tts_tpu_torch.infer) against the JAX package.

- importing the port leaves JAX and the JAX package out of `sys.modules`;
- entry points called without `device` raise when CUDA is absent;
- host-side text/duration/audio helpers match the JAX pipeline's;
- the whole slice: `generate_chunk` (mel front end, tokenizer, duration,
  bucket, `cfm_sample`, Vocos, RMS) on the CPU in f32 against the JAX path
  fed the same weights, reference audio, text and noise.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.infer import pipeline as jpipe
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.text import vocab as jvocab
from f5tts_tpu.utils import duration_bucket as j_duration_bucket
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch.config import SamplingConfig
from f5tts_tpu_torch.convert import vocos_params_from_jax
from f5tts_tpu_torch.infer import pipeline as tpipe
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.ops.mel import MelFrontend
from f5tts_tpu_torch.text import vocab as tvocab
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import _np, jx, np_params, small_dit
from tests.test_torch_vocos_mel import SMALL_VOCOS
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,'!?")}  # 32 ids


def test_port_imports_no_jax():
    code = ("import sys, f5tts_tpu_torch, f5tts_tpu_torch.infer.pipeline, "
            "f5tts_tpu_torch.convert, f5tts_tpu_torch.ops.attention, chip_smoke, "
            "f5tts_tpu_torch.models.unett, f5tts_tpu_torch.models.mmdit, "
            "f5tts_tpu_torch.train.step, f5tts_tpu_torch.train.dataset, "
            "f5tts_tpu_torch.train.checkpoint, f5tts_tpu_torch.train.trainer, "
            "f5tts_tpu_torch.scripts.train_bench, f5tts_tpu_torch.scripts.profile_generate, "
            "f5tts_tpu_torch.scripts.kernel_ab, f5tts_tpu_torch.eval.rtf_bench, "
            "f5tts_tpu_torch.text.pinyin, f5tts_tpu_torch.ops.quant, "
            "f5tts_tpu_torch.scripts.int8_quality_ab, f5tts_tpu_torch.infer.speech_edit, "
            "f5tts_tpu_torch.infer.align, f5tts_tpu_torch.vocoder.bigvgan, "
            "f5tts_tpu_torch.compat, f5tts_tpu_torch.infer.utils_infer, "
            "f5tts_tpu_torch.models.remat\n"
            "from f5tts_tpu_torch.config import load_model_config, model_config_from_dict\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'f5tts_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tarch, _, tp = small_dit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MelFrontend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvocos.Vocos(tvocos.init_vocos(torch.Generator(), tvocos.VocosConfig(**SMALL_VOCOS)),
                     tvocos.VocosConfig(**SMALL_VOCOS))
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator(), tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.InferencePipeline(tp, tdit.DiTStatics(tarch), voc, VOCAB, tokenizer="char")


def test_text_and_duration_helpers_match_jax():
    text = ("Hello there, this is a test! It has several sentences; some are long, others "
            "short. 你好，世界。Done?")
    for max_chars in (16, 40, 135):
        assert tpipe.chunk_text(text, max_chars) == jpipe.chunk_text(text, max_chars)
    assert tpipe.max_chars_for_ref("ref text. ", 2.7, 1.2) == jpipe.max_chars_for_ref("ref text. ", 2.7, 1.2)
    for gen, speed, fix in (("short", 1.0, None), ("a much longer text here", 0.8, None),
                            ("x", 1.0, 3.5)):
        assert (tpipe.estimate_duration_frames(254, "ref text. ", gen, speed, fix)
                == jpipe.estimate_duration_frames(254, "ref text. ", gen, speed, fix))
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (5000, 300, 9000)]
    for dur in (0.15, 0.0):
        np.testing.assert_array_equal(tpipe.cross_fade(waves, 24000, dur),
                                      jpipe.cross_fade(waves, 24000, dur))
    texts = ["hello world.", "zzz ?", "ünïcode"]
    np.testing.assert_array_equal(tvocab.list_str_to_idx(texts, VOCAB),
                                  jvocab.list_str_to_idx(texts, VOCAB))
    np.testing.assert_array_equal(tvocab.list_str_to_tensor(texts, pad_to=20),
                                  jvocab.list_str_to_tensor(texts, pad_to=20))


@pytest.fixture(scope="module")
def pipelines():
    jarch, tarch, tree, tp = small_dit(seed=2)
    jvcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jvcfg), 4)
    tvoc = tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**SMALL_VOCOS),
                        device="cpu")
    port = tpipe.InferencePipeline(tp, tdit.DiTStatics(tarch), tvoc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=4), tokenizer="char",
                                   dtype=torch.float32, device="cpu")
    jax_pipe = jpipe.InferencePipeline(jx(tree), jdit.DiTStatics(jarch),
                                       jvocos.Vocos(jx(vtree), jvcfg), VOCAB, tokenizer="char",
                                       dtype=jnp.float32, backend="xla")
    return port, jax_pipe


def _ref_wav(seconds=1.1, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 24000)) / 24000
    return (0.03 * np.sin(2 * np.pi * 180 * t) + 0.005 * rng.standard_normal(t.shape)).astype(np.float32)


def test_ref_mel_and_tokenize_match_jax(pipelines):
    port, jax_pipe = pipelines
    wav = _ref_wav()
    np.testing.assert_allclose(port.ref_mel(wav), jax_pipe.ref_mel(wav), atol=1e-3)
    texts = ["ref text. some words to say."]
    np.testing.assert_array_equal(port.tokenize(texts), jax_pipe.tokenize(texts))


def test_generate_chunk_matches_jax_path(pipelines):
    port, jax_pipe = pipelines
    ref_wav, ref_text, gen_text, seed = _ref_wav(), "a quiet voice. ", "hello there, friend.", 3
    wave, gen_mel = port.generate_chunk(ref_wav, ref_text, gen_text, seed=seed, nfe_step=4)

    # the JAX path, step by step as its generate_chunk runs, with the port's noise
    rms = float(np.sqrt(np.mean(ref_wav ** 2)))
    ref_scaled = ref_wav * (0.1 / rms)
    ref_mel = jax_pipe.ref_mel(ref_scaled)
    ref_frames = ref_mel.shape[0]
    total = jpipe.estimate_duration_frames(ref_frames, ref_text, gen_text)
    ids = jax_pipe.tokenize([ref_text + gen_text])
    total = int(jcfm.compute_duration(jnp.asarray((ids != -1).sum(axis=1)),
                                      jnp.asarray([ref_frames]), jnp.asarray([total]), 4096)[0])
    n = j_duration_bucket(total, 256, 4096)
    cond = np.zeros((1, n, 100), np.float32)
    cond[0, :ref_frames] = ref_mel
    y0 = _np(tcfm.make_noise(torch.Generator().manual_seed(seed), 1, n, 100,
                             torch.tensor([total]), noise_max_len=4096))
    mel = jcfm.cfm_sample(jax_pipe.params, jax_pipe.statics, jnp.asarray(cond), jnp.asarray(ids),
                          jnp.asarray([ref_frames]), jnp.asarray([total]),
                          j_make_time_grid(4, sway_sampling_coef=-1.0), y0=jnp.asarray(y0),
                          cfg_strength=2.0, dtype=jnp.float32, backend="xla")
    wave_full = np.asarray(jax_pipe.vocoder(jnp.transpose(mel, (0, 2, 1))))
    want = wave_full[0, ref_frames * 256: min(total * 256, wave_full.shape[1])] * (rms / 0.1)
    want_mel = np.asarray(mel)[0, ref_frames:total].T

    assert wave.shape == want.shape and gen_mel.shape == want_mel.shape
    # f32 on both sides; mel agrees to sum-order drift, the wav to 1e-3 of its peak
    np.testing.assert_allclose(gen_mel, want_mel, atol=5e-3)
    np.testing.assert_allclose(wave, want, atol=1e-3 * np.abs(want).max())


def test_infer_chunks_and_cross_fades(pipelines):
    port, _ = pipelines
    ref = _ref_wav()
    gen = "first part of the text, which is long enough. second part comes after it."
    kw = dict(seed=1, nfe_step=2, speed=0.1, fix_duration=3.0)  # 3 chunks, 281 frames each
    wave, sr, mel = port.infer(ref, 24000, "a quiet voice.", gen, **kw)
    chunks = tpipe.chunk_text(gen, max(tpipe.max_chars_for_ref("a quiet voice. ", 1.1, 0.1), 16))
    assert len(chunks) == 3
    parts = [port.generate_chunk(ref, "a quiet voice. ", c, **kw) for c in chunks]
    np.testing.assert_allclose(wave, tpipe.cross_fade([p[0] for p in parts], 24000, 0.15),
                               atol=1e-6)
    assert sr == 24000 and np.isfinite(wave).all()
    assert mel.shape == (100, sum(p[1].shape[1] for p in parts))
    # a 48 kHz reference is resampled to 24 kHz first
    wave48, _, _ = port.infer(np.repeat(ref, 2), 48000, "a quiet voice.", chunks[0], **kw)
    assert abs(len(wave48) - len(parts[0][0])) <= 256
