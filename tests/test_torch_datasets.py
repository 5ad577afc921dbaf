"""Port training data (f5tts_tpu_torch.train.dataset, train.datasets.*)
against the JAX package, on the CPU.

The same seeded wavs, rows and corpora go through both packages. Tolerances:
- mels: rel-L2 <= 1e-6 against the JAX `NumpyMel` (the same numpy math);
- texts, frame lengths, skipped rows, prep outputs (raw.arrow rows,
  duration.json and vocab.txt): exact.
"""

import json
import os

import numpy as np
import pytest

from f5tts_tpu.config import MelConfig as JMelConfig
from f5tts_tpu.train import dataset as jds
from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.train import dataset as tds
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _wav(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.2 * np.sin(2 * np.pi * (150 + 40 * seed) * t) + 0.02 * rng.standard_normal(t.shape)
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Rows {audio_path, text, duration} over wavs at 24 and 16 kHz; row 2
    is too short (0.2 s) and row 5 too long for the 0.3-30 s filter (its
    duration says 31 s), so both are skipped forward."""
    root = tmp_path_factory.mktemp("corpus")
    rows = []
    specs = [(1.2, 24000), (0.9, 16000), (0.2, 24000), (1.5, 16000), (0.7, 24000), (1.0, 24000)]
    for i, (sec, sr) in enumerate(specs):
        audio_io.write_wav(str(root / f"u{i}.wav"), _wav(sec, sr, i), sr)
        dur = 31.0 if i == 5 else sec
        text = ["ni3", " ", "hao3"] if i == 3 else f"sample text {i}"
        rows.append({"audio_path": f"u{i}.wav", "text": text, "duration": dur})
    return root, rows


def test_custom_dataset_list_of_dicts_matches_jax(corpus):
    root, rows = corpus
    durations = [r["duration"] for r in rows]
    port = tds.CustomDataset(rows, durations=durations, audio_root=str(root))
    jax_side = jds.CustomDataset(rows, durations=durations, mel_cfg=JMelConfig(),
                                 audio_root=str(root))
    assert len(port) == len(jax_side) == 6
    for i in range(len(rows)):
        assert port.get_frame_len(i) == jax_side.get_frame_len(i)
        assert port.get_text(i) == jax_side.get_text(i)
        got, want = port[i], jax_side[i]
        assert got.text == want.text and got.mel.shape == want.mel.shape
        assert got.mel.dtype == np.float32 and _rel(got.mel, want.mel) <= 1e-6
    # the skip-forward: row 2 (0.2 s) reads row 3, row 5 (31 s) wraps to row 0
    assert port.get_text(2) == rows[3]["text"] and port.get_text(5) == rows[0]["text"]
    np.testing.assert_array_equal(port[5].mel, port[0].mel)
    # frames: 24 kHz rows len // 256 + 1; 16 kHz rows resampled first
    assert port[0].mel.shape == (int(1.2 * 24000) // 256 + 1, 100)
    assert port[1].mel.shape == (int(0.9 * 24000) // 256 + 1, 100)
    # without durations the rows' own; a row without one raises
    no_dur = tds.CustomDataset(rows, audio_root=str(root))
    assert no_dur.get_frame_len(0) == port.get_frame_len(0)
    bad = tds.CustomDataset([{"audio_path": "u0.wav", "text": "x", "duration": None}])
    with pytest.raises(KeyError, match="no 'duration'"):
        bad.get_frame_len(0)
    with pytest.raises(KeyError, match="no 'duration'"):
        jds.CustomDataset([{"audio_path": "u0.wav", "text": "x",
                            "duration": None}]).get_frame_len(0)


def test_custom_dataset_preprocessed_mel_both_orientations():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((37, 100)).astype(np.float32)   # [t, n_mels]
    b = rng.standard_normal((100, 52)).astype(np.float32)   # [n_mels, t]
    rows = [{"mel_spec": a.tolist(), "text": "x", "duration": 0.1},
            {"mel_spec": b.tolist(), "text": ["a", "b"], "duration": 40.0}]
    port = tds.CustomDataset(rows, preprocessed_mel=True)
    jax_side = jds.CustomDataset(rows, preprocessed_mel=True)
    for i in range(2):  # no skip-forward over preprocessed rows
        got, want = port[i], jax_side[i]
        np.testing.assert_array_equal(got.mel, want.mel)
        assert got.text == want.text and port.get_text(i) == want.text
    np.testing.assert_array_equal(port[0].mel, a)
    np.testing.assert_array_equal(port[1].mel, b.T)


def _hf_rows():
    """Two stereo rows at 16 kHz ([channels, samples]), a 0.1 s mono row,
    a mono row at 24 kHz."""
    rows = []
    for i, (sec, sr, stereo) in enumerate([(1.1, 16000, True), (0.1, 16000, False),
                                           (0.8, 24000, False), (0.6, 16000, True)]):
        left = _wav(sec, sr, 10 + i)
        array = np.stack([left, 0.5 * left[::-1]]) if stereo else left
        rows.append({"audio": {"array": array, "sampling_rate": sr}, "text": f"hf row {i}"})
    return rows


def test_hf_dataset_stereo_16k_matches_jax():
    """Mono rows against the JAX HFDataset throughout; stereo rows' mels
    against the JAX one read directly (its skip-forward never ends on a
    stereo row, see `HFDataset`), their frame lengths against the samples.
    As a list of dicts and as a `datasets.Dataset` (one per channel count:
    arrow takes one layout a column)."""
    import datasets as hf_datasets

    rows = _hf_rows()
    stereo, mono = [rows[0], rows[3]], [rows[1], rows[2]]
    for wrap in (list, hf_datasets.Dataset.from_list):
        port = tds.HFDataset(wrap(stereo))
        jax_direct = jds.HFDataset(wrap(stereo), mel_cfg=JMelConfig())
        jax_direct._resolve_index = lambda i: i
        for i, row in enumerate(stereo):
            sec = np.shape(row["audio"]["array"])[-1] / 16000
            assert port.get_frame_len(i) == pytest.approx(sec * 24000 / 256, rel=1e-12)
            got, want = port[i], jax_direct[i]
            assert got.text == want.text == row["text"] and _rel(got.mel, want.mel) <= 1e-6
        port, jax_side = tds.HFDataset(wrap(mono)), jds.HFDataset(wrap(mono), mel_cfg=JMelConfig())
        for i in range(2):
            assert port.get_frame_len(i) == pytest.approx(jax_side.get_frame_len(i), rel=1e-12)
            assert port.get_text(i) == jax_side.get_text(i)
            got, want = port[i], jax_side[i]
            assert got.text == want.text and _rel(got.mel, want.mel) <= 1e-6
        assert port.get_text(0) == "hf row 2"  # 0.1 s: skipped forward
    want = tds.NumpyMel()(audio_io.resample(rows[0]["audio"]["array"].mean(axis=0), 16000, 24000))
    np.testing.assert_array_equal(tds.HFDataset(rows)[0].mel, want)


def _arrow_dir(path, rows, durations=True, layout="raw.arrow"):
    import datasets as hf_datasets
    from datasets.arrow_writer import ArrowWriter

    os.makedirs(path, exist_ok=True)
    if layout == "raw/":
        hf_datasets.Dataset.from_list(rows).save_to_disk(os.path.join(path, "raw"))
    else:
        with ArrowWriter(path=os.path.join(path, layout)) as w:
            for r in rows:
                w.write(r)
            w.finalize()
    if durations:
        with open(os.path.join(path, "duration.json"), "w") as f:
            json.dump({"duration": [r["duration"] for r in rows]}, f)


@pytest.mark.parametrize("layout", ["raw.arrow", "raw/"])
def test_load_dataset_custom_and_path_match_jax(corpus, tmp_path, layout):
    root, rows = corpus
    # token lists throughout, as the prep scripts store pinyin (one arrow
    # type a column)
    absolute = [dict(r, audio_path=str(root / r["audio_path"]), text=list(r["text"]))
                for r in rows]
    _arrow_dir(tmp_path / "data" / "mini_pinyin", absolute, layout=layout)
    port = tds.load_dataset("mini", "pinyin", MelConfig(), data_root=str(tmp_path / "data"))
    want = jds.load_dataset("mini", "pinyin", JMelConfig(), data_root=str(tmp_path / "data"))
    by_path = tds.load_dataset(str(tmp_path / "data" / "mini_pinyin"),
                               dataset_type="CustomDatasetPath")
    assert isinstance(port, tds.CustomDataset) and not port.preprocessed_mel
    assert port.durations == want.durations == [r["duration"] for r in rows]
    assert port.get_text(3) == ["ni3", " ", "hao3"] and port.get_text(2) == port.get_text(3)
    for ds in (port, by_path):
        for i in (0, 2, 3):
            assert ds.get_frame_len(i) == want.get_frame_len(i)
            assert ds.get_text(i) == want.get_text(i)
            got, ref = ds[i], want[i]
            assert got.text == ref.text and _rel(got.mel, ref.mel) <= 1e-6
    # the mel layout: mel.arrow rows, preprocessed
    mel_rows = [{"mel_spec": np.full((100, 5 + i), i, np.float32).tolist(), "text": f"m{i}",
                 "duration": 0.05} for i in range(2)]
    _arrow_dir(tmp_path / "mels", mel_rows, durations=False, layout="mel.arrow")
    mel_ds = tds.load_dataset(str(tmp_path / "mels"), dataset_type="CustomDatasetPath",
                              audio_type="mel")
    assert mel_ds.preprocessed_mel and mel_ds.durations is None
    assert mel_ds[1].mel.shape == (6, 100) and mel_ds.get_frame_len(1) == pytest.approx(
        0.05 * 24000 / 256)


def test_load_dataset_hf_type_and_errors(monkeypatch, tmp_path):
    import datasets as hf_datasets

    rows = _hf_rows()[1:3]  # mono (the JAX HFDataset reads these)
    calls = []

    def fake_load(name, split):  # stands in for the hub
        calls.append((name, split))
        return hf_datasets.Dataset.from_list(rows)

    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setattr(hf_datasets, "load_dataset", fake_load)
    port = tds.load_dataset("Emilia_ZH", dataset_type="HFDataset")
    want = jds.load_dataset("Emilia_ZH", dataset_type="HFDataset")
    assert calls == [("Emilia/Emilia", "train.ZH")] * 2
    assert isinstance(port, tds.HFDataset) and len(port) == len(want) == 2
    assert _rel(port[0].mel, want[0].mel) <= 1e-6 and port.get_text(0) == "hf row 2"

    def unreachable(name, split):
        raise ConnectionError("no network")

    monkeypatch.setattr(hf_datasets, "load_dataset", unreachable)
    with pytest.raises(RuntimeError, match="could not be loaded") as err:
        tds.load_dataset("Emilia_ZH", dataset_type="HFDataset")
    assert isinstance(err.value.__cause__, ConnectionError)
    with pytest.raises(ValueError, match="unknown dataset_type"):
        tds.load_dataset("x", dataset_type="Parquet")
    # a directory without duration.json and rows without a duration
    _arrow_dir(tmp_path / "nodur", [{"audio_path": "a.wav", "text": "t", "duration": None}],
               durations=False)
    ds = tds.load_dataset(str(tmp_path / "nodur"), dataset_type="CustomDatasetPath")
    with pytest.raises(KeyError, match="no 'duration'"):
        ds.get_frame_len(0)


def test_dataset_module_imports_without_datasets():
    """The card's machine has neither `datasets` nor `pyarrow`."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['datasets'] = None; sys.modules['pyarrow'] = None\n"
            "import f5tts_tpu_torch.train.dataset as d, f5tts_tpu_torch.train.trainer\n"
            "import f5tts_tpu_torch.train.finetune_cli, f5tts_tpu_torch.train.train_cli\n"
            "import f5tts_tpu_torch.train.lora, f5tts_tpu_torch.train.datasets.common\n"
            "ds = d.CustomDataset([{'mel_spec': [[0.0] * 100] * 3, 'text': 'a', 'duration': 1.0}],"
            " preprocessed_mel=True)\nassert ds[0].mel.shape == (3, 100)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the prep scripts
# ---------------------------------------------------------------------------

def _outputs(d):
    """(raw.arrow rows, duration.json bytes, vocab.txt bytes or None)."""
    import datasets as hf_datasets

    rows = hf_datasets.Dataset.from_file(os.path.join(d, "raw.arrow")).to_list()
    with open(os.path.join(d, "duration.json"), "rb") as f:
        dur = f.read()
    vocab = None
    if os.path.exists(os.path.join(d, "vocab.txt")):
        with open(os.path.join(d, "vocab.txt"), "rb") as f:
            vocab = f.read()
    return rows, dur, vocab


def _same_outputs(tmp_path, jax_prepare, port_prepare, src, *args, **kw):
    jout, tout = tmp_path / "jax_out", tmp_path / "port_out"
    jstats = jax_prepare(str(src), str(jout), *args, **kw)
    tstats = port_prepare(str(src), str(tout), *args, **kw)
    assert tstats == jstats
    want, got = _outputs(jout), _outputs(tout)
    assert got == want
    return got, tstats


def _csv_corpus(root, with_missing=False):
    (root / "wavs").mkdir(parents=True)
    lines = []
    texts = ["sample text number zero", "你好，世界。Hello!", "一起去银行 ok"]
    for i, text in enumerate(texts):
        audio_io.write_wav(str(root / "wavs" / f"utt{i}.wav"), _wav(0.6 + 0.2 * i, 24000, i),
                           24000)
        lines.append(f"wavs/utt{i}.wav|{text}")
    if with_missing:
        lines.append("wavs/missing.wav|ghost row")
    (root / "metadata.csv").write_text("audio_file|text\n" + "\n".join(lines), encoding="utf-8")
    return root


@pytest.mark.parametrize("pretrained_vocab", [True, False])
def test_prepare_csv_wavs_matches_jax(tmp_path, pretrained_vocab):
    from f5tts_tpu.train.datasets.prepare_csv_wavs import prepare as jprep
    from f5tts_tpu_torch.train.datasets.prepare_csv_wavs import prepare as tprep

    src = _csv_corpus(tmp_path / "in", with_missing=True)
    (rows, _, vocab), stats = _same_outputs(tmp_path, jprep, tprep, src,
                                            use_pretrained_vocab=pretrained_vocab, workers=2)
    assert stats["samples"] == 3 and stats["skipped"] == 1  # the missing row skipped
    assert isinstance(rows[1]["text"], list) and "hao3" in rows[1]["text"]
    lines = vocab.decode("utf-8").split("\n")
    assert lines[0] == " "
    if pretrained_vocab:
        assert len(lines) - 1 == 2545
    else:  # corpus-derived: small, covers the corpus tokens
        assert len(lines) < 60 and all(ch in lines for ch in "sample") and "hao3" in lines


def test_prepare_ljspeech_matches_jax(tmp_path):
    from f5tts_tpu.train.datasets.prepare_ljspeech import prepare as jprep
    from f5tts_tpu_torch.train.datasets.prepare_ljspeech import prepare as tprep

    lj = tmp_path / "LJSpeech"
    (lj / "wavs").mkdir(parents=True)
    rows = []
    for i in range(3):
        audio_io.write_wav(str(lj / "wavs" / f"LJ00{i}.wav"), _wav(0.5 + 0.1 * i, 22050, i), 22050)
        rows.append(f"LJ00{i}|Raw text {i}|Normalized text, {i}!")
    (lj / "metadata.csv").write_text("\n".join(rows + ["short|line"]), encoding="utf-8")
    (got, dur, vocab), stats = _same_outputs(tmp_path, jprep, tprep, lj, workers=2)
    assert stats["samples"] == 3 and got[2]["text"] == "Normalized text, 2!"
    assert json.loads(dur)["duration"][0] == pytest.approx(0.5, abs=1e-4)


def test_prepare_libritts_matches_jax(tmp_path):
    from f5tts_tpu.train.datasets.prepare_libritts import prepare as jprep
    from f5tts_tpu_torch.train.datasets.prepare_libritts import prepare as tprep

    root = tmp_path / "LibriTTS"
    for j, (subset, spk) in enumerate([("train-clean-100", "19"), ("train-other-500", "27")]):
        d = root / subset / spk / "198"
        d.mkdir(parents=True)
        for k in range(2):
            stem = d / f"{spk}_198_00000{k}_00000{k}"
            audio_io.write_wav(str(stem) + ".wav", _wav(0.4 + 0.1 * k, 24000, j * 2 + k), 24000)
            if k == 0 or j == 0:  # one wav without its transcript
                (d / (stem.name + ".normalized.txt")).write_text(f"  Chapter {j}, line {k}.\n")
    (got, _, _), stats = _same_outputs(tmp_path, jprep, tprep, root,
                                       ("train-clean-100", "train-other-500", "dev-clean"),
                                       workers=2)
    assert stats["samples"] == 3 and got[0]["text"] == "Chapter 0, line 0."


def _jsonl(path, objs):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(json.dumps(o, ensure_ascii=False) for o in objs) + "\nnot json\n",
                    encoding="utf-8")


def test_prepare_emilia_matches_jax(tmp_path):
    from f5tts_tpu.train.datasets.prepare_emilia import prepare as jprep
    from f5tts_tpu_torch.train.datasets.prepare_emilia import prepare as tprep

    root = tmp_path / "Emilia"
    _jsonl(root / "ZH" / "a.jsonl", [
        {"text": "你好世界，今天天气很好。", "duration": 2.5, "wav": "ZH_B00000/x0.mp3"},
        {"text": "这是一个测试", "duration": 0.1, "wav": "ZH_B00000/x1.mp3"},    # too short
        {"text": "有日文い字", "duration": 3.0, "wav": "ZH_B00000/x2.mp3"},       # filtered char
        {"text": "哈" * 30, "duration": 3.0, "wav": "ZH_B00000/x3.mp3"},          # repetition
        {"text": "银行行长", "duration": 1.5, "audio_path": "ZH_B00000/x4.mp3"}])
    _jsonl(root / "EN" / "b.jsonl", [
        {"text": "Hello there, general.", "duration": 4.0, "wav": "EN_B00000/y0.mp3"},
        {"text": "", "duration": 4.0, "wav": "EN_B00000/y1.mp3"}])
    (got, _, vocab), stats = _same_outputs(tmp_path, jprep, tprep, root, ("ZH", "EN"))
    assert stats["samples"] == 3 and stats["filtered"] == 4
    assert isinstance(got[0]["text"], list) and got[2]["text"] == "Hello there, general."
    # max_samples stops each language's walk at the cap
    (capped, _, _), _ = _same_outputs(tmp_path / "cap", jprep, tprep, root, ("ZH", "EN"), 1)
    assert len(capped) == 2


def test_prepare_emilia_v2_matches_jax(tmp_path):
    from f5tts_tpu.train.datasets.prepare_emilia_v2 import prepare as jprep
    from f5tts_tpu_torch.train.datasets.prepare_emilia_v2 import prepare as tprep

    root = tmp_path / "EmiliaV2" / "ZH-B000000"
    root.mkdir(parents=True)
    for i, (text, dur, ext) in enumerate([("你好世界", 2.0, ".wav"), ("plain english", 1.0, ".mp3"),
                                          ("no audio here", 1.0, None), ("太长了", 40.0, ".wav")]):
        (root / f"s{i}.json").write_text(json.dumps({"text": text, "duration": dur}),
                                         encoding="utf-8")
        if ext:
            (root / f"s{i}{ext}").write_bytes(b"\0")
    (root / "broken.json").write_text("{", encoding="utf-8")
    (root / "broken.wav").write_bytes(b"\0")
    (got, _, vocab), stats = _same_outputs(tmp_path, jprep, tprep, root.parent)
    assert stats["samples"] == 2 and stats["filtered"] == 1
    assert isinstance(got[0]["text"], list) and got[1]["text"] == "plain english"


def test_prepare_wenetspeech4tts_matches_jax(tmp_path):
    from f5tts_tpu.train.datasets.prepare_wenetspeech4tts import prepare as jprep
    from f5tts_tpu_torch.train.datasets.prepare_wenetspeech4tts import prepare as tprep

    root = tmp_path / "Wenet"
    for j, tier in enumerate(("WenetSpeech4TTS_Premium", "WenetSpeech4TTS_Standard")):
        d = root / tier / "wavs"
        d.mkdir(parents=True)
        for k, text in enumerate(["今天天气很好\n第二行", "银行在哪里"]):
            audio_io.write_wav(str(d / f"u{k}.wav"), _wav(0.5, 16000, j * 2 + k), 16000)
            (d / f"u{k}.txt").write_text(text, encoding="utf-8")
    for tier, n in (("Premium", 2), ("Standard", 4)):
        (got, _, vocab), stats = _same_outputs(tmp_path / tier, jprep, tprep, root, tier, workers=2)
        assert stats["samples"] == n and isinstance(got[0]["text"], list)
        assert "第二行" not in "".join(got[0]["text"])


def test_repetition_found_and_write_dataset_match_jax(tmp_path):
    from f5tts_tpu.train.datasets import common as jcommon
    from f5tts_tpu_torch.train.datasets import common as tcommon

    for text, length, tol in (("ababababababababababababab", 2, 10), ("a normal sentence", 2, 10),
                              ("abcabcabcabc", 3, 3), ("哈哈哈哈", 1, 3), ("", 2, 10)):
        assert tcommon.repetition_found(text, length, tol) == \
            jcommon.repetition_found(text, length, tol)
    samples = [{"audio_path": "/x/a.wav", "text": ["ni3", " ", "a"], "duration": 1.5},
               {"audio_path": "/x/b.wav", "text": ["b", "\n"], "duration": 2.0}]
    vocab = ["b", " ", "ni3", "\n", "a"]
    assert tcommon.write_dataset(str(tmp_path / "t"), samples, vocab) == \
        jcommon.write_dataset(str(tmp_path / "j"), samples, vocab)
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "j")
    assert _outputs(tmp_path / "t")[2] == b" \na\nb\nni3\n"  # space first, "\n" dropped
    wav = tmp_path / "p.wav"
    audio_io.write_wav(str(wav), _wav(0.75, 16000, 0), 16000)
    assert tcommon.probe_duration(str(wav)) == jcommon.probe_duration(str(wav)) == 0.75


def test_prepare_csv_skips_missing_audio_and_own_vocab(tmp_path):
    """tests/test_datasets_prep.py's missing-audio and own-vocab cases,
    against the port."""
    from f5tts_tpu_torch.train.datasets.prepare_csv_wavs import prepare as tprep

    src = _csv_corpus(tmp_path / "in", with_missing=True)
    stats = tprep(str(src), str(tmp_path / "a"), use_pretrained_vocab=True, workers=2)
    assert stats["samples"] == 3 and stats["skipped"] == 1
    tprep(str(src), str(tmp_path / "b"), use_pretrained_vocab=False, workers=2)
    with open(tmp_path / "b" / "vocab.txt", encoding="utf-8") as f:
        vocab = [line[:-1] for line in f]
    assert vocab[0] == " " and len(vocab) < 60
    for ch in "sample":
        assert ch in vocab
    # the prepared dir loads, and its stored pinyin lists tokenize as the
    # inference path tokenizes the raw text
    from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, list_str_to_idx, load_vocab
    from f5tts_tpu_torch.train.trainer import tokenize

    ds = tds.load_dataset(str(tmp_path / "a"), dataset_type="CustomDatasetPath")
    assert len(ds) == 3 and ds[1].mel.shape[1] == 100 and isinstance(ds[1].text, list)
    vocab = load_vocab(EMILIA_VOCAB)
    np.testing.assert_array_equal(
        tokenize([ds.get_text(1)], "pinyin", vocab),
        list_str_to_idx(convert_char_to_pinyin(["你好，世界。Hello!"]), vocab))
