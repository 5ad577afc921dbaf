"""Port finetune workbench (f5tts_tpu_torch.train.workbench) and epoch
calculator (scripts/count_max_epoch.py) against the JAX package, on the CPU.

Mirrors tests/test_workbench.py with each function run on both sides:
slicer cut positions, RMS frames, written segments, metadata, arrow rows,
vocab files and checkpoints exact; the suggested hyperparameters exact
where both packages compute them the same way (the frame budget follows
each package's own memory model).
"""

import json
import os

import numpy as np
import pytest
import torch

from f5tts_tpu.train import workbench as jwb
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.train import workbench as twb
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 24_000


def _burst_wav(bursts, sil, sr=SR, amp=0.3, seed=0):
    rng = np.random.default_rng(seed)
    parts = []
    for b, s in zip(bursts, sil):
        parts.append(rng.standard_normal(int(b * sr)).astype(np.float32) * amp)
        parts.append(np.zeros(int(s * sr), np.float32))
    return np.concatenate(parts)


SLICER_CASES = [
    # (bursts, silences, slicer kwargs)
    ([3.0, 3.0], [1.5, 0.5], dict(min_length=2000, min_interval=300, hop_size=20,
                                  max_sil_kept=500)),
    ([0.5], [0.1], dict(min_length=2000, min_interval=300, hop_size=20, max_sil_kept=500)),
    ([2.0, 1.0, 2.5, 0.7], [0.2, 0.9, 2.2, 0.4], dict(min_length=1000, min_interval=200,
                                                      hop_size=10, max_sil_kept=300)),
    ([1.5, 2.0], [0.35, 0.6], dict(min_length=500, min_interval=300, hop_size=20,
                                   max_sil_kept=200)),
    ([4.0, 4.0, 4.0], [1.0, 3.0, 0.1], dict()),
]


@pytest.mark.parametrize("case", range(len(SLICER_CASES)))
def test_slicer_cut_positions_match_jax(case):
    bursts, sil, kw = SLICER_CASES[case]
    wav = _burst_wav(bursts, sil, seed=case)
    if case == 3:
        wav = np.concatenate([np.zeros(int(0.5 * SR), np.float32), wav])  # leading silence
    got, want = twb.Slicer(SR, **kw).slice(wav), jwb.Slicer(SR, **kw).slice(wav)
    assert [(s, e) for _, s, e in got] == [(s, e) for _, s, e in want]
    for (a, _, _), (b, _, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    stereo = np.stack([wav, 0.5 * wav])
    got, want = twb.Slicer(SR, **kw).slice(stereo), jwb.Slicer(SR, **kw).slice(stereo)
    assert [(s, e) for _, s, e in got] == [(s, e) for _, s, e in want]
    np.testing.assert_array_equal(twb._rms_frames(wav, 960, 480), jwb._rms_frames(wav, 960, 480))
    with pytest.raises(ValueError):
        twb.Slicer(SR, min_length=100, min_interval=300)
    with pytest.raises(ValueError):
        twb.Slicer(SR, max_sil_kept=5)


def test_slicer_splits_on_silence():
    wav = _burst_wav([3.0, 3.0], [1.5, 0.5])
    chunks = twb.Slicer(SR, min_length=2000, min_interval=300, hop_size=20,
                        max_sil_kept=500).slice(wav)
    assert len(chunks) >= 2
    for chunk, start, end in chunks:
        assert end > start and np.abs(chunk).mean() > 0.01
    assert sum(len(c) for c, _, _ in chunks) <= len(wav)


def test_normalize_chunk_matches_jax():
    for x in (np.array([0.0, 2.0, -2.0], np.float32), np.array([0.0, 0.1, -0.1], np.float32),
              np.zeros(4, np.float32), _burst_wav([0.1], [0.0], amp=0.7)):
        for alpha in (0.5, 0.2):
            np.testing.assert_array_equal(twb.normalize_chunk(x, alpha),
                                          jwb.normalize_chunk(x, alpha))
    assert np.abs(twb.normalize_chunk(np.array([0.0, 2.0, -2.0], np.float32))).max() <= 1.0


def _make_project(root, n_wavs=2, seconds=2.0):
    proj = root / "proj"
    (proj / "dataset").mkdir(parents=True)
    for i in range(n_wavs):
        wav = _burst_wav([seconds, seconds], [0.8, 0.05], seed=i)
        audio_io.write_wav(str(proj / "dataset" / f"in_{i}.wav"), wav, SR)
    audio_io.write_wav(str(proj / "dataset" / "low.wav"), _burst_wav([1.5], [0.1], sr=16000),
                       16000)
    return proj


def test_transcribe_directory_matches_jax(tmp_path):
    tproj, jproj = _make_project(tmp_path / "t"), _make_project(tmp_path / "j")
    calls = []

    def fake_asr(path, language=None):
        calls.append((os.path.basename(path), language))
        if len(calls) == 2:  # the segment's name is then reused by the next one
            raise RuntimeError("asr failed")
        return f"  text of {os.path.basename(path)} "

    files = sorted(str(p) for p in (tproj / "dataset").iterdir())
    got = twb.transcribe_directory(str(tproj), "en", audio_files=files, transcribe_fn=fake_asr)
    port_calls, calls[:] = list(calls), []
    want = jwb.transcribe_directory(str(jproj), "en",
                                    audio_files=[f.replace(str(tproj), str(jproj))
                                                 for f in files], transcribe_fn=fake_asr)
    assert port_calls == calls and len(calls) == 3 and got["segments"] == want["segments"] == 2
    assert got["errors"] == want["errors"] == 1
    with open(got["metadata"], "rb") as f, open(want["metadata"], "rb") as g:
        assert f.read() == g.read()
    assert sorted(os.listdir(got["wavs_dir"])) == sorted(os.listdir(want["wavs_dir"]))
    for name in os.listdir(got["wavs_dir"]):
        with open(os.path.join(got["wavs_dir"], name), "rb") as f, \
                open(os.path.join(want["wavs_dir"], name), "rb") as g:
            assert f.read() == g.read()
    # the glob over <project>/dataset, and no ASR model to fall back on
    again = twb.transcribe_directory(str(tproj), transcribe_fn=lambda p, lang: "hi")
    assert again["segments"] == got["segments"] + 1
    with pytest.raises(NotImplementedError, match="transcribe_fn"):
        twb.transcribe_directory(str(tproj))
    with pytest.raises(FileNotFoundError):
        twb.transcribe_directory(str(tmp_path / "empty"), transcribe_fn=fake_asr)


def _metadata_project(root):
    proj = root / "p2"
    wavs = proj / "wavs"
    wavs.mkdir(parents=True)
    audio_io.write_wav(str(wavs / "good_a.wav"), _burst_wav([2.0], [0.0]), SR)
    audio_io.write_wav(str(wavs / "good_b.wav"), _burst_wav([3.0], [0.0], seed=1), SR)
    audio_io.write_wav(str(wavs / "short.wav"), _burst_wav([0.4], [0.0]), SR)
    with open(proj / "metadata.csv", "w", encoding="utf-8-sig") as f:
        f.write("good_a|hello world\n")
        f.write("good_b|你好，世界\n")
        f.write("short|too short audio\n")
        f.write("good_a|ab\n")
        f.write("missing|where is it\n")
        f.write("malformed line\n")
    return proj


@pytest.mark.parametrize("ch_tokenizer", [False, True])
def test_create_metadata_matches_jax(tmp_path, ch_tokenizer):
    import datasets

    tproj = _metadata_project(tmp_path / "t")
    jproj = _metadata_project(tmp_path / "j")
    got = twb.create_metadata(str(tproj), ch_tokenizer=ch_tokenizer)
    want = jwb.create_metadata(str(jproj), ch_tokenizer=ch_tokenizer)
    rel = lambda x, root: json.loads(json.dumps(x).replace(str(root), "<proj>"))  # noqa: E731
    for field in ("samples", "total_seconds", "min_seconds", "max_seconds", "vocab_size",
                  "new_vocab"):
        assert getattr(got, field) == getattr(want, field), field
    assert rel(got.errors, tproj) == rel(want.errors, jproj)
    assert {e[1] for e in got.errors} == {"duration < 1 sec", "very short text length 3",
                                          "error path"}
    t_rows = datasets.Dataset.from_file(got.arrow_path).to_list()
    j_rows = datasets.Dataset.from_file(want.arrow_path).to_list()
    assert rel(t_rows, tproj) == rel(j_rows, jproj) and len(t_rows) == 2
    assert isinstance(t_rows[1]["text"], list)
    for name in ("duration.json", "vocab.txt"):
        assert (tproj / name).read_bytes() == (jproj / name).read_bytes()
    if not ch_tokenizer:
        assert got.vocab_size == 2545
    with pytest.raises(FileNotFoundError):
        twb.create_metadata(str(tmp_path / "nowhere"))


def test_calculate_train_matches_jax(tmp_path):
    proj = tmp_path / "p3"
    proj.mkdir()
    json.dump({"duration": [4.0] * 30}, open(proj / "duration.json", "w"))
    kw = dict(batch_size_type="sample", finetune=False, hbm_gb=16.0)
    assert twb.calculate_train(str(proj), **kw) == jwb.calculate_train(str(proj), **kw)
    # frames: the port's memory model (an 80 GB card); the rest of the
    # arithmetic as the JAX module's, given the same budget
    got = twb.calculate_train(str(proj), hbm_gb=80.0, num_chips=2)
    budget = int((0.9 * 80.0 - twb.TRAIN_FIXED_GB) / twb.TRAIN_GB_PER_FRAME)
    assert got["batch_size_per_chip"] == budget
    jax_16 = jwb.calculate_train(str(proj), hbm_gb=16.0, num_chips=2)
    jax_budget = jax_16["batch_size_per_chip"]
    assert got["epochs"] == int(1_200_000 / (30 * 4.0 / (budget * 2 * 256 / SR)))
    assert jax_16["epochs"] == int(1_200_000 / (30 * 4.0 / (jax_budget * 2 * 256 / SR)))
    for key in ("max_samples", "num_warmup_updates", "learning_rate", "total_samples"):
        assert got[key] == jax_16[key]
    small = twb.calculate_train(str(proj), hbm_gb=6.0)  # no room: one longest sample
    assert small["batch_size_per_chip"] == int(4.0 * SR / 256)
    with pytest.raises(ValueError):
        twb.calculate_train(str(proj), batch_size_type="tokens", hbm_gb=80.0)


def test_vocab_check_extend_and_paths_match_jax(tmp_path):
    for side, wb in (("t", twb), ("j", jwb)):
        proj = tmp_path / side
        proj.mkdir()
        (proj / "wavs").mkdir()
        (proj / "wavs" / "seg.flac").write_bytes(b"")
        base = tmp_path / f"base_{side}.txt"
        base.write_text("a\nb\nc\n d\nni3\n", encoding="utf-8")
        with open(proj / "metadata.csv", "w", encoding="utf-8-sig") as f:
            f.write("x|abc\ny|abz 你\nbad line\n")
    for tok in ("char", "pinyin"):
        got = twb.vocab_check(str(tmp_path / "t"), tok, str(tmp_path / "base_t.txt"))
        want = jwb.vocab_check(str(tmp_path / "j"), tok, str(tmp_path / "base_j.txt"))
        assert got == want
    assert "z" in got[1] and "a" not in got[1]
    assert twb.vocab_check(str(tmp_path / "t"), "pinyin") == jwb.vocab_check(str(tmp_path / "j"),
                                                                                "pinyin")
    got = twb.vocab_extend(str(tmp_path / "t"), ["z", " q ", "a"], str(tmp_path / "base_t.txt"))
    want = jwb.vocab_extend(str(tmp_path / "j"), ["z", " q ", "a"], str(tmp_path / "base_j.txt"))
    assert {k: v for k, v in got.items() if k != "vocab_path"} == \
        {k: v for k, v in want.items() if k != "vocab_path"}
    t_vocab, j_vocab = (tmp_path / side / "vocab.txt" for side in ("t", "j"))
    assert t_vocab.read_bytes() == j_vocab.read_bytes()
    with pytest.raises(ValueError):
        twb.vocab_extend(str(tmp_path / "t"), [])
    wavs = str(tmp_path / "t" / "wavs")
    for name in ("seg", "seg.wav", "/abs/x.mp3", "other", "dir/y.ogg"):
        assert twb.resolve_audio_path(name, wavs) == jwb.resolve_audio_path(name, wavs)
    assert twb.resolve_audio_path("seg", wavs).endswith("seg.flac")
    for sec in (0, 59.9, 3600, 3725.5, 90061):
        assert twb.format_seconds_to_hms(sec) == jwb.format_seconds_to_hms(sec)


@pytest.mark.parametrize("fmt", [".pt", ".safetensors"])
def test_expand_reference_checkpoint_embeddings_matches_jax(tmp_path, fmt):
    g = torch.Generator().manual_seed(0)
    key = "ema_model.transformer.text_embed.text_embed.weight"
    sd = {key: torch.randn(10, 4, generator=g),
          "ema_model.transformer.other.weight": torch.randn(3, 3, generator=g).bfloat16()}
    src = tmp_path / f"model{fmt}"
    if fmt == ".pt":
        torch.save({"ema_model_state_dict": sd, "step": 7}, src)
    else:
        from safetensors.torch import save_file

        save_file(sd, str(src))
    t_out, j_out = tmp_path / f"t{fmt}", tmp_path / f"j{fmt}"
    assert twb.expand_reference_checkpoint_embeddings(str(src), str(t_out), 5) == 15
    assert jwb.expand_reference_checkpoint_embeddings(str(src), str(j_out), 5) == 15
    if fmt == ".pt":
        got, want = (torch.load(p, weights_only=True) for p in (t_out, j_out))
        assert got["step"] == want["step"] == 7
        got, want = got["ema_model_state_dict"], want["ema_model_state_dict"]
    else:
        from safetensors.torch import load_file

        got, want = load_file(str(t_out)), load_file(str(j_out))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert got[key].shape == (15, 4) and torch.equal(got[key][:10], sd[key])
    if fmt == ".safetensors":
        bare = tmp_path / "bare.safetensors"  # an export without the ema_model. prefix
        from safetensors.torch import save_file

        save_file({"transformer.text_embed.text_embed.weight": sd[key]}, str(bare))
        out = str(tmp_path / "o.safetensors")
        assert twb.expand_reference_checkpoint_embeddings(str(bare), out, 2) == 12


def test_count_max_epoch_matches_jax():
    from f5tts_tpu.scripts import count_max_epoch as jcount
    from f5tts_tpu_torch.scripts import count_max_epoch as tcount

    for kw in (dict(), dict(total_hours=100.0, frames_per_update=38_400, grad_accum=2,
                            total_updates=50_000)):
        assert tcount.analytic(**kw) == jcount.analytic(**kw)
    rng = np.random.default_rng(3)
    frame_lens = [float(x) for x in rng.integers(50, 2000, 500)]
    for kw in (dict(frames_threshold=38_400, max_samples=64),
               dict(frames_threshold=4000, max_samples=8, grad_accum=3, total_updates=1000)):
        assert tcount.precise(frame_lens, **kw) == jcount.precise(frame_lens, **kw)
