"""The port's evaluation harness (`eval/utils_eval.py`, `eval/eval_infer_batch.py`,
`eval/eval_runner.py`) on the CPU against the JAX package's.

- Seed-TTS and LibriSpeech metainfo from `meta.lst` files written here;
- `get_inference_prompt` on seeded wavs (24 and 16 kHz, quiet and loud,
  English and Chinese, pinyin and char): the same batches in the same
  shuffled order, mels within 1e-5 relative;
- `normalize_for_wer` / `compute_wer` on `tests/test_eval.py`'s fixtures;
- `generate_batches` at `tests/test_eval.py`'s tiny DiT in f32, the JAX
  `cfm_sample` handed the port's noise: the wavs within 1e-4;
- `score_test_set` over stub scorers: the results files equal;
- the entry points raise without a card unless given device="cpu".
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.eval import eval_infer_batch as jeib
from f5tts_tpu.eval import eval_runner as jrunner
from f5tts_tpu.eval import utils_eval as jeval
from f5tts_tpu.infer import audio_io as jaudio
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import dit_params_from_jax, vocos_params_from_jax
from f5tts_tpu_torch.eval import eval_infer_batch as teib
from f5tts_tpu_torch.eval import eval_runner as trunner
from f5tts_tpu_torch.eval import utils_eval as teval
from f5tts_tpu_torch.infer import audio_io as taudio
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_eval.py's tiny DiT and Vocos
TINY_DIT = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
                text_num_embeds=2545, text_dim=16, conv_layers=1)
TINY_VOCOS = dict(input_channels=100, dim=32, intermediate_dim=64, num_layers=1)


def test_seedtts_and_librispeech_metainfo_match_jax(tmp_path):
    meta = tmp_path / "meta.lst"
    meta.write_text("utt1|prompt text|p1.wav|target text|gt1.wav\n"
                    "utt2|pt|p2.wav|tt\n"
                    "utt3|abs|/abs/p3.wav|x|/abs/g3.wav\n"
                    "bad line\n", encoding="utf-8")
    got = teval.get_seedtts_testset_metainfo(str(meta))
    assert got == jeval.get_seedtts_testset_metainfo(str(meta))
    assert len(got) == 3 and got[1][4].endswith("wavs/utt2.wav")
    cross = tmp_path / "cross.lst"
    cross.write_text("1089-134686-0000\t3.0\tREF TEXT\t1188-133604-0001\t5.0\tGEN TEXT\n"
                     "121-121726-0000\t2.5\tanother ref\t237-134493-0003\t4.1\tgen two\n",
                     encoding="utf-8")
    got = teval.get_librispeech_test_clean_metainfo(str(cross), "/ls")
    assert got == jeval.get_librispeech_test_clean_metainfo(str(cross), "/ls")
    assert got[0][2] == "/ls/1089/134686/1089-134686-0000.flac" and got[0][3] == " GEN TEXT"


def _prompt_set(tmp_path) -> list[tuple]:
    """Seeded prompts: 24 / 16 kHz, quiet (rescaled) and loud, English and
    Chinese texts; several fall into one bucket."""
    rng = np.random.default_rng(20)
    cases = [(1.0, 24000, 0.02, "prompt text here.", "target text"),
             (1.1, 24000, 0.3, "prompt text here.", "target text"),
             (3.0, 16000, 0.05, "a longer prompt", "and a longer target sentence."),
             (1.05, 24000, 0.2, "prompt text here.", "target text"),
             (2.0, 16000, 0.1, "你好，世界。", "我们今天一起去公园。"),
             (0.6, 24000, 0.01, "short", "the quick brown fox jumps."),
             (1.02, 24000, 0.3, "prompt text here.", "target text!")]
    metainfo = []
    for i, (secs, sr, amp, ptext, gtext) in enumerate(cases):
        p = tmp_path / f"p{i}.wav"
        taudio.write_wav(str(p), (rng.standard_normal(int(sr * secs)) * amp).astype(np.float32), sr)
        gt = tmp_path / f"g{i}.wav"
        taudio.write_wav(str(gt), (rng.standard_normal(int(sr * (secs + 1))) * 0.1)
                         .astype(np.float32), sr)
        metainfo.append((f"utt{i}", ptext, str(p), gtext, str(gt)))
    return metainfo


@pytest.mark.parametrize("tokenizer,batch,truth", [("pinyin", 2, False), ("char", 3, False),
                                                   ("pinyin", 1, True)])
def test_get_inference_prompt_matches_jax(tmp_path, tokenizer, batch, truth):
    metainfo = _prompt_set(tmp_path)
    kw = dict(tokenizer=tokenizer, infer_batch_size=batch, num_buckets=10, min_secs=0.5,
              max_secs=10, use_truth_duration=truth, speed=1.1)
    got = teval.get_inference_prompt(metainfo, **kw)
    want = jeval.get_inference_prompt(metainfo, **kw)
    assert [b["utts"] for b in got] == [b["utts"] for b in want]
    assert max(len(b["utts"]) for b in got) == min(batch, 3)
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"]
        for k in ("ref_mel_lens", "total_mel_lens"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_allclose(g["ref_rms"], w["ref_rms"], rtol=1e-6)
        assert g["ref_mels"].shape == w["ref_mels"].shape
        np.testing.assert_allclose(g["ref_mels"], w["ref_mels"], rtol=1e-5,
                                   atol=1e-5 * np.abs(w["ref_mels"]).max())


WER_FIXTURES = [
    ("Hello World", "hello world", "en"), ("don't stop", "dont stop", "en"),
    ("state-of-the-art", "state of the art", "en"), ("a  b", "a b", "en"),
    ("  hello there ", "hello there", "en"), ("the quick brown fox", "the quack brown", "en"),
    ("one two", "one two three four", "en"), ("你好世界", "你好地界", "zh"),
    ("你好，世界。", "你好世界", "zh"), ("一 二 三", "一二三", "zh"), ("我用GPU", "我用gpu", "zh"),
    ("ＡＢ（Ｃ）", "ＡＢ", "zh"), ("Hello, world!", "hello world", "en"), ("", "", "en"),
    ("", "extra", "en"), ("the cat sat", "the dog sat", "en"), ("a b c d", "a b", "en"),
]


def test_wer_matches_jax():
    for truth, hypo, lang in WER_FIXTURES:
        for text in (truth, hypo):
            assert teval.normalize_for_wer(text, lang) == jeval.normalize_for_wer(text, lang)
        assert teval.compute_wer(truth, hypo, lang) == jeval.compute_wer(truth, hypo, lang)
    assert teval.compute_wer("state-of-the-art", "state of the art") == 4.0
    pairs = [("a.wav", "hello there world"), ("b.wav", "good morning")]
    asr = {"a.wav": "hello their world", "b.wav": "good morning"}.get
    assert (teval.run_asr_wer("en", pairs, asr_fn=asr)
            == jeval.run_asr_wer("en", pairs, asr_fn=asr))


def test_wer_backends_raise_without_their_packages():
    for lang, pkg in (("zh", "funasr"), ("en", "faster_whisper")):
        try:
            __import__(pkg)
        except ImportError:
            with pytest.raises(RuntimeError, match=pkg.replace("_", "-")):
                teval.run_asr_wer(lang, [("x.wav", "x")])
    with pytest.raises(ValueError):
        teval.run_asr_wer("fr", [])


@pytest.fixture(scope="module")
def tiny_models():
    jarch = JArch(**TINY_DIT)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 20)
    jvcfg = jvocos.VocosConfig(**TINY_VOCOS)
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(1), jvcfg), 21)
    tp = tm.fuse_backbone_qkv(dit_params_from_jax(tree))
    tvoc = tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**TINY_VOCOS),
                        device="cpu")
    return (jx(tree), jdit.DiTStatics(jarch), jvocos.Vocos(jx(vtree), jvcfg).decode,
            tp, tdit.DiTStatics(TArch(**TINY_DIT)), tvoc)


def _batches():
    rng = np.random.default_rng(0)
    return [{"utts": ["a", "b"], "ref_rms": np.asarray([0.05, 0.2], np.float32),
             "ref_mels": rng.standard_normal((2, 50, 100)).astype(np.float32),
             "ref_mel_lens": np.asarray([50, 40], np.int32),
             "total_mel_lens": np.asarray([100, 90], np.int32),
             "texts": [list("hello there"), list("goodbye now")]},
            {"utts": ["c"], "ref_rms": np.asarray([0.02], np.float32),
             "ref_mels": rng.standard_normal((1, 140, 100)).astype(np.float32),
             "ref_mel_lens": np.asarray([140], np.int32),
             "total_mel_lens": np.asarray([300], np.int32),
             "texts": [["ni3", "hao3", " ", "w", "o"]]}]


def test_generate_batches_matches_jax(tmp_path, tiny_models, monkeypatch):
    jparams, jstatics, jvoc, tp, tstatics, tvoc = tiny_models
    vocab = load_vocab(EMILIA_VOCAB)
    seed = 3
    real_sample = jcfm.cfm_sample

    def jax_sample_with_port_noise(params, statics, cond, text, lens, duration, t_grid, *,
                                   key=None, **kw):
        b, n, d = cond.shape
        y0 = tcfm.make_noise(torch.Generator().manual_seed(seed), b, n, d,
                             torch.from_numpy(np.array(duration)))
        return real_sample(params, statics, cond, text, lens, duration, t_grid,
                           y0=jnp.asarray(y0.numpy()), **kw)

    monkeypatch.setattr(jcfm, "cfm_sample", jax_sample_with_port_noise)
    written = {"jax": {}, "port": {}}
    for side, mod in (("jax", jaudio), ("port", taudio)):
        real_write = mod.write_wav

        def spy(path, wav, sr, side=side, real_write=real_write):
            written[side][os.path.basename(path)] = np.asarray(wav, np.float32)
            real_write(path, wav, sr)

        monkeypatch.setattr(mod, "write_wav", spy)
    kw = dict(nfe_step=2, seed=seed, bucket_size=128, max_duration=512)
    want = jeib.generate_batches(jparams, jstatics, jvoc, vocab, _batches(),
                                 str(tmp_path / "jax"), dtype=jnp.float32, backend="xla", **kw)
    got = teib.generate_batches(tp, tstatics, tvoc, vocab, _batches(), str(tmp_path / "port"),
                                dtype=torch.float32, device="cpu", **kw)
    assert got.keys() == want.keys()
    assert got["utterances"] == want["utterances"] == 3
    assert got["audio_seconds"] == want["audio_seconds"]
    assert sorted(written["port"]) == sorted(written["jax"]) == ["a.wav", "b.wav", "c.wav"]
    for name, w in written["jax"].items():
        g = written["port"][name]
        assert g.shape == w.shape and np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g, w, atol=1e-4)
        assert os.path.exists(tmp_path / "port" / name)


def test_eval_runner_matches_jax(tmp_path, monkeypatch):
    meta = tmp_path / "meta.lst"
    meta.write_text("utt1|prompt one|p1.wav|target one|gt1.wav\n"
                    "utt2|prompt two|p2.wav|target two words|gt2.wav\n"
                    "utt3|prompt 3|p3.wav|never generated|gt3.wav\n")
    gen = tmp_path / "gen"
    gen.mkdir()
    for u in ("utt1", "utt2"):
        (gen / f"{u}.wav").write_bytes(b"")
    triples = trunner.build_seedtts_test_set(str(meta), str(gen))
    assert triples == jrunner.build_seedtts_test_set(str(meta), str(gen)) and len(triples) == 2
    cross = tmp_path / "cross.lst"
    cross.write_text("1089-134686-0000\t3.0\tREF\t1188-133604-0001\t5.0\tGEN TEXT\n")
    (gen / "1188-133604-0001.wav").write_bytes(b"")
    for truth in (False, True):
        assert (trunner.build_librispeech_test_set(str(cross), str(gen), "/ls", truth)
                == jrunner.build_librispeech_test_set(str(cross), str(gen), "/ls", truth))
    with pytest.raises(FileNotFoundError):
        trunner.build_librispeech_test_set(str(cross), str(tmp_path), "/ls")
    for n in (1, 2, 3, 5):
        assert trunner._shard(list(range(7)), n) == jrunner._shard(list(range(7)), n)

    def fake_asr(path):
        return "target one" if "utt1" in path else "target too words"

    def wer(mod):
        real = mod.run_asr_wer
        return lambda lang, pairs, device=None: real(lang, pairs, device=device, asr_fn=fake_asr)

    def sim(lang_unused=None):
        return lambda pairs, ckpt, device=None: [
            {"gen": g, "gt": r, "sim": 0.5 + 0.1 * i} for i, (g, r) in enumerate(pairs)]

    for task in ("wer", "sim"):
        results = {}
        for side, (utils, runner) in (("jax", (jeval, jrunner)), ("port", (teval, trunner))):
            monkeypatch.setattr(utils, "run_asr_wer", wer(utils))
            monkeypatch.setattr(utils, "run_sim", sim())
            mean = runner.score_test_set(task, triples, str(gen), lang="en", device="cpu")
            results[side] = (mean, (gen / f"_{task}_results.jsonl").read_text(encoding="utf-8"))
        assert results["port"] == results["jax"]
    lines = results["port"][1].strip().splitlines()
    assert json.loads(lines[0])["sim"] == 0.5 and lines[-1] == "SIM: 0.55"
    with pytest.raises(ValueError):
        trunner.score_test_set("mos", triples, str(gen))


def test_entry_points_take_the_card_unless_told(tmp_path, tiny_models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tp, tstatics, tvoc = tiny_models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teib.generate_batches(tp, tstatics, tvoc, load_vocab(EMILIA_VOCAB), _batches(),
                              str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.run_sim([], str(tmp_path / "missing.pth"))
    from f5tts_tpu_torch.eval.eval_utmos import eval_utmos

    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_utmos(str(tmp_path), ckpt=str(tmp_path / "missing.pt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.score_test_set("sim", [("g.wav", "r.wav", "t")], str(tmp_path), sim_ckpt="x")
