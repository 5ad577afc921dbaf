"""Speech editing and the CTC aligner in the port (f5tts_tpu_torch.infer.
speech_edit / align) against the JAX package on the CPU.

`build_edit_cond` and the aligner's dynamic program bit-equal; `edit_speech`
at a tiny DiT + Vocos (f32) against the JAX `edit_speech` on the same
weights, audio and noise (the JAX key's, passed in); `edit_speech_by_text`
wired through `spans_for_edits`; the weights-gated leg raising without
weights and running its model on the device the caller names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.infer import align as jalign
from f5tts_tpu.infer import speech_edit as jedit
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.infer import align as talign
from f5tts_tpu_torch.infer import speech_edit as tedit
from f5tts_tpu_torch.models import cfm as tcfm
from tests.test_torch_dit import _np, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPF = 256 / 24000  # seconds a mel frame

EDIT_CASES = [
    ([(20 * SPF, 30 * SPF)], [15 * SPF]),
    ([(20 * SPF, 30 * SPF)], None),
    ([(0.0, 12 * SPF), (40 * SPF, 41 * SPF), (60 * SPF, 90 * SPF)], None),
    ([(0.0, 12 * SPF), (40 * SPF, 41 * SPF), (60 * SPF, 90 * SPF)], [0.05, 0.3, 0.0]),
    ([(0.11, 0.23), (0.5, 0.71)], [0.4, 0.07]),
    ([(10 * SPF, 10 * SPF), (99 * SPF, 100 * SPF)], [0.1, 0.2]),
]


@pytest.mark.parametrize("parts,fix", EDIT_CASES)
def test_build_edit_cond_bit_equal(parts, fix):
    mel = np.random.default_rng(0).standard_normal((100, 6)).astype(np.float32)
    want = jedit.build_edit_cond(mel, parts, fix)
    got = tedit.build_edit_cond(mel, parts, fix)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def pipelines():
    """A tiny DiT + Vocos pipeline on each side (the weights of
    tests/test_torch_pipeline.py's), 4 NFE by default."""
    from f5tts_tpu.infer import pipeline as jpipe
    from f5tts_tpu.models import dit as jdit
    from f5tts_tpu.vocoder import vocos as jvocos
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.convert import vocos_params_from_jax
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.models import dit as tdit
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_dit import jx, np_params, small_dit
    from tests.test_torch_pipeline import VOCAB
    from tests.test_torch_vocos_mel import SMALL_VOCOS

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


def _wav():
    from tests.test_torch_pipeline import _ref_wav

    return _ref_wav(seconds=1.6, seed=8)  # rms ~0.02: scaled to 0.1 and back


def _jax_noise(port, wav, text, parts, fix, seed):
    """The noise the JAX edit_speech draws from PRNGKey(seed), at the
    port's bucket and length (the same as the JAX ones)."""
    req = tedit.prepare_edit(port, wav, 24000, text, parts, fix, y0=torch.zeros(1))
    n = req["cond"].shape[1]
    noise = jcfm.make_noise(jax.random.PRNGKey(seed), 1, n, 100, jnp.asarray([req["total"]]))
    return torch.from_numpy(np.array(noise)), req


@pytest.mark.parametrize("parts,fix", [([(0.3, 0.5)], [0.25]),
                                       ([(0.2, 0.4), (0.9, 1.2)], None)])
def test_edit_speech_matches_jax(pipelines, parts, fix):
    port, jax_pipe = pipelines
    wav, text, seed = _wav(), "hello there, friend.", 4
    y0, req = _jax_noise(port, wav, text, parts, fix, seed)
    got, sr = tedit.edit_speech(port, wav, 24000, text, parts, fix, seed=seed, nfe_step=4, y0=y0)
    want, jsr = jedit.edit_speech(jax_pipe, wav, 24000, text, parts, fix, seed=seed, nfe_step=4)
    assert sr == jsr == 24000 and got.shape == want.shape and got.dtype == np.float32
    # f32 on both sides: two mel front ends, 4 steps of a 2-block DiT, Vocos
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.abs(want).max() > 1e-3

    # the mel: the port's cond and mask against the JAX splice, then the
    # sampler on each side's own cond with the same noise
    rms = float(np.sqrt(np.mean(wav ** 2)))
    jmel = np.asarray(jax_pipe.mel.frames_to_mel_bnd(jnp.asarray((wav * (0.1 / rms))[None])))[0]
    jcond, jmask = jedit.build_edit_cond(jmel, parts, fix)
    total = req["total"]
    assert jcond.shape[0] == total
    np.testing.assert_allclose(_np(req["cond"])[0, :total], jcond, atol=2e-3)
    np.testing.assert_array_equal(_np(req["edit_mask"])[0, :total], jmask)
    assert not _np(req["edit_mask"])[0, total:].any()
    n = req["cond"].shape[1]
    cond = np.zeros((1, n, 100), np.float32)
    cond[0, :total] = jcond
    emask = np.zeros((1, n), bool)
    emask[0, :total] = jmask
    want_mel = np.asarray(jcfm.cfm_sample(
        jax_pipe.params, jax_pipe.statics, jnp.asarray(cond), jnp.asarray(_np(req["text"])),
        jnp.asarray([total]), jnp.asarray([total]), j_make_time_grid(4, sway_sampling_coef=-1.0),
        y0=jnp.asarray(_np(y0)), cfg_strength=2.0, dtype=jnp.float32, backend="xla",
        edit_mask=jnp.asarray(emask)))
    req = tedit.prepare_edit(port, wav, 24000, text, parts, fix, nfe_step=4, y0=y0)
    req.pop("total"), req.pop("rms")
    got_mel = _np(tcfm.cfm_sample(port.params, port.statics, dtype=port.dtype,
                                  backbone=port.bdef, **req))
    np.testing.assert_allclose(got_mel[0, :total], want_mel[0, :total], atol=2e-3)
    # kept frames are the spliced original exactly
    np.testing.assert_array_equal(got_mel[0, :total][jmask], _np(req["cond"])[0, :total][jmask])


def test_edit_speech_seed_noise_and_by_text(pipelines, monkeypatch):
    """Without y0 the noise comes from the seed (repeatable); text edits go
    through `spans_for_edits` into the same edit as their seconds; without
    `char_spans` the aligner runs on the pipeline's device."""
    port, _ = pipelines
    wav = _wav()
    text = "hello there"
    spans = [talign.CharSpan(c, 0.1 * i, 0.1 * (i + 1)) for i, c in enumerate(text)]
    a, _ = tedit.edit_speech(port, wav, 24000, "hello world", [(0.6, 1.1)], [0.3], seed=2,
                             nfe_step=2)
    b, _ = tedit.edit_speech_by_text(port, wav, 24000, text, "hello world", ["there"],
                                     fix_durations=[0.3], char_spans=spans, seed=2, nfe_step=2)
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, b)
    seen = []

    def fake_align_text(wav_, sr_, text_, **kw):
        seen.append((sr_, text_, kw))
        return spans
    monkeypatch.setattr(talign, "align_text", fake_align_text)
    d, _ = tedit.edit_speech_by_text(port, wav, 24000, text, "hello world", ["there"],
                                     fix_durations=[0.3], seed=2, nfe_step=2)
    np.testing.assert_array_equal(a, d)
    assert seen == [(24000, text, {"device": torch.device("cpu")})]
    c, _ = tedit.edit_speech(port, wav, 24000, "hello world", [(0.6, 1.1)], [0.3], seed=3,
                             nfe_step=2)
    assert np.abs(a - c).max() > 1e-4


@pytest.mark.parametrize("seed", range(4))
def test_ctc_viterbi_align_matches_jax(seed):
    rng = np.random.default_rng(seed)
    t, v = 60, 12
    logits = rng.standard_normal((t, v)).astype(np.float32) * 3
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    # repeated tokens included, with T >= L + repeats
    tokens = [int(x) for x in rng.integers(1, v, 20)] + [3, 3, 5]
    assert talign.ctc_viterbi_align(log_probs, tokens) == jalign.ctc_viterbi_align(log_probs,
                                                                                   tokens)
    assert talign.ctc_viterbi_align(log_probs, tokens, blank=2) == \
        jalign.ctc_viterbi_align(log_probs, tokens, blank=2)
    assert talign.ctc_viterbi_align(log_probs, []) == []
    with pytest.raises(ValueError):
        talign.ctc_viterbi_align(log_probs[:3], tokens)


def test_align_with_logits_and_spans_for_edits_match_jax():
    rng = np.random.default_rng(5)
    text = "Hi, bob. Bob hi!"
    vocab = {c: i + 1 for i, c in enumerate("hiob")}
    logits = rng.standard_normal((50, 6)).astype(np.float32) * 2
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    got = talign.align_with_logits(log_probs, text, vocab, 0.02)
    want = jalign.align_with_logits(log_probs, text, vocab, 0.02)
    assert [(c.char, c.start_s, c.end_s) for c in got] == \
        [(c.char, c.start_s, c.end_s) for c in want]
    for edits in (["bob", "hi"], [(0, 2), (9, 12)], ["Bob"]):
        assert talign.spans_for_edits(got, edits, text) == jalign.spans_for_edits(want, edits, text)
    assert talign.spans_for_edits(got, [(4, 7)]) == jalign.spans_for_edits(want, [(4, 7)])
    for bad in (["zzz"], [(2, 4)]):  # absent substring; only unaligned chars inside
        with pytest.raises(ValueError):
            talign.spans_for_edits(got, bad, text)
    with pytest.raises(ValueError, match="no character"):
        talign.align_with_logits(log_probs, "!!", vocab, 0.02)


def test_align_text_raises_without_weights(tmp_path, monkeypatch):
    """Nothing is downloaded: a model that is not on the disk raises
    RuntimeError."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    missing = str(tmp_path / "no-aligner")
    with pytest.raises(RuntimeError, match="unavailable"):
        talign.align_text(_wav(), 24000, "hello", model_name=missing, device="cpu")
    with pytest.raises(RuntimeError, match="unavailable"):
        talign.load_alignment_model(missing, device="cpu")


class _FakeCTC(torch.nn.Module):
    """Stands in for the wav2vec2-CTC model: 320-sample frames, a fixed
    projection of each frame to 6 logits; records the input's device."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Parameter(
            torch.from_numpy(np.random.default_rng(9).standard_normal((320, 6)).astype(np.float32)))
        self.devices = []

    def forward(self, x):
        self.devices.append(x.device)
        frames = x[:, : x.shape[1] // 320 * 320].reshape(x.shape[0], -1, 320)
        return type("Out", (), {"logits": 30.0 * frames @ self.proj})()


def test_align_text_runs_model_on_named_device(monkeypatch):
    """The acoustic model runs on the device the caller names and only its
    log-probs come back; with no device named and no card it raises."""
    fake, vocab = _FakeCTC(), {c: i + 1 for i, c in enumerate("helo")}
    cpu = torch.device("cpu")
    monkeypatch.setitem(talign._aligner_cache, ("fake", cpu), (fake, vocab, 0))
    wav = _wav()
    got = talign.align_text(wav, 24000, "hello", model_name="fake", device="cpu")
    assert fake.devices == [cpu]
    wav16 = torch.from_numpy(talign.audio_io.resample(wav, 24000, 16000))
    with torch.no_grad():
        log_probs = torch.log_softmax(fake(wav16[None]).logits[0], -1).numpy()
    want = talign.align_with_logits(log_probs, "hello", vocab,
                                    (len(wav16) / 16000.0) / log_probs.shape[0])
    assert [(c.char, c.start_s, c.end_s) for c in got] == \
        [(c.char, c.start_s, c.end_s) for c in want]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talign.align_text(wav, 24000, "hello", model_name="fake")
