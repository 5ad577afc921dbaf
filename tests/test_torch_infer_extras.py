"""The port's front ends beside serving, on the CPU, against the JAX package
and `tests/test_infer_extras.py`: audio I/O and silence handling, the
socket streaming server and client, `infer_stream`, the CLI's config and
voice tags, the `F5TTS` API, the one-call API of `utils_infer` and the
speech-edit CLI.

- `read_wav` / `write_wav` bytes, `split_on_silence`,
  `remove_silence_edges`, `clip_ref_audio` and
  `preprocess_ref_audio_text` equal to the JAX ones on seeded speech and
  silence;
- `infer_stream`'s pieces are `generate_chunk`'s waves cut to chunk_size;
- the socket server streams a text's chunks to the client;
- `split_voice_segments` and `load_config` (TOML + overrides) equal JAX's;
- `F5TTS` raises without a checkpoint, naming the reference's repo and
  file as the JAX `download.checkpoint_spec` does, and runs a tiny preset
  with `ckpt_file="random"`; `infer_process` / `infer_batch_process` /
  `remove_silence_for_generated_wav` and the two CLIs at that preset.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from f5tts_tpu.infer import audio_io as jaudio
from f5tts_tpu.infer import cli as jcli
from f5tts_tpu.infer.download import checkpoint_spec as j_checkpoint_spec
from f5tts_tpu_torch import config as tconfig
from f5tts_tpu_torch.infer import api as tapi
from f5tts_tpu_torch.infer import audio_io as taudio
from f5tts_tpu_torch.infer import cli as tcli
from f5tts_tpu_torch.infer import utils_infer as tui
from tests.test_torch_serve import _pipelines, vocoders  # noqa: F401
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 24000


def speech_and_silence(seed: int = 0, pattern=(1.2, -1.4, 0.6, -0.3, 2.0, -1.1, 0.8)) -> np.ndarray:
    """Voiced bursts (positive seconds) and near-silences (negative) in turn."""
    rng = np.random.default_rng(seed)
    parts = []
    for secs in pattern:
        n = int(abs(secs) * SR)
        t = np.arange(n) / SR
        if secs > 0:
            parts.append(0.3 * np.sin(2 * np.pi * 150 * t) * (0.6 + 0.4 * rng.random(n)))
        else:
            parts.append(1e-4 * rng.standard_normal(n))
    return np.concatenate(parts).astype(np.float32)


def test_wav_io_matches_jax(tmp_path):
    wav = speech_and_silence()
    wav[100] = 1.7  # clipped on write
    paths = [str(tmp_path / f"{name}.wav") for name in ("jax", "port")]
    jaudio.write_wav(paths[0], wav, SR)
    taudio.write_wav(paths[1], wav, SR)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    for path in paths:
        got, want = taudio.read_wav(path), jaudio.read_wav(path)
        assert got[1] == want[1] == SR
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_silence_handling_matches_jax(seed):
    wav = speech_and_silence(seed)
    for args in ((1000, -50.0, 1000), (100, -40.0, 1000), (1000, -50.0, 500), (300, -30.0, 50)):
        got, want = taudio.split_on_silence(wav, SR, *args), jaudio.split_on_silence(wav, SR, *args)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for thresh in (-42.0, -20.0):
        np.testing.assert_array_equal(taudio.remove_silence_edges(wav, SR, thresh),
                                      jaudio.remove_silence_edges(wav, SR, thresh))
    np.testing.assert_array_equal(taudio._frame_dbfs(wav, SR), jaudio._frame_dbfs(wav, SR))
    long = speech_and_silence(seed, (5.0, -1.2, 4.0, -0.2, 6.0, -1.5, 3.0))
    for w in (wav, long):
        for max_ms in (12000, 3000):
            np.testing.assert_array_equal(taudio.clip_ref_audio(w, SR, max_ms),
                                          jaudio.clip_ref_audio(w, SR, max_ms))


def test_preprocess_ref_audio_text_matches_jax(tmp_path):
    from f5tts_tpu.infer.asr import preprocess_ref_audio_text as jprep

    path = str(tmp_path / "ref.wav")
    taudio.write_wav(path, speech_and_silence(2, (4.0, -1.3, 9.0, -0.5)), SR)
    for text in ("some words", "some words.", "一些话。"):
        got = tui.preprocess_ref_audio_text(path, text, show_info=lambda *_: None)
        want = jprep(path, text, show_info=lambda *_: None)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    with pytest.raises(RuntimeError, match="ASR"):
        tui.preprocess_ref_audio_text(path, "  ", show_info=lambda *_: None)


def test_infer_stream_is_generate_chunk_cut(vocoders):  # noqa: F811
    pipe = _pipelines(vocoders, with_jax=False)[0]
    rng = np.random.default_rng(4)
    ref = (rng.standard_normal(20000) * 0.05).astype(np.float32)
    chunks = ["hello there.", "a second chunk of text."]
    kw = dict(seed=3, nfe_step=2)
    pieces = list(pipe.infer_stream(np.repeat(ref, 2), 48000, "ref. ", chunks, chunk_size=1000,
                                    **kw))
    ref24 = taudio.resample(np.repeat(ref, 2), 48000, SR)
    want = [pipe.generate_chunk(ref24, "ref. ", c, **kw)[0] for c in chunks]
    want_pieces = [w[j:j + 1000] for w in want for j in range(0, len(w), 1000)]
    assert len(pieces) == len(want_pieces) and all(sr == SR for _, sr in pieces)
    for (p, _), w in zip(pieces, want_pieces):
        np.testing.assert_array_equal(p, w)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_socket_server_roundtrip(vocoders, tmp_path):  # noqa: F811
    from f5tts_tpu_torch.infer.socket_client import listen_to_f5tts
    from f5tts_tpu_torch.infer.socket_server import TTSStreamingProcessor, start_server

    pipe = _pipelines(vocoders, with_jax=False)[0]
    ref = (np.random.default_rng(0).standard_normal(12000) * 0.05).astype(np.float32)
    proc = TTSStreamingProcessor(pipe, ref, SR, "ref text.", first_chunk_chars=(12, 40))
    port = _free_port()
    saved = str(tmp_path / "server.wav")
    th = threading.Thread(target=start_server, args=("127.0.0.1", port, proc, saved, 1),
                          daemon=True)
    th.start()
    time.sleep(0.3)
    out = str(tmp_path / "client.wav")
    stats = listen_to_f5tts("Hello world. And some more words.", "127.0.0.1", port,
                            out_path=out)
    th.join(timeout=30)
    assert stats["samples"] > 1000
    assert stats["ttfb_s"] is not None and stats["ttfb_s"] <= stats["total_s"] + 1e-9
    want = np.concatenate(list(proc.generate_stream("Hello world. And some more words.")))
    assert stats["samples"] == len(want)
    np.testing.assert_array_equal(taudio.read_wav(out)[0], taudio.read_wav(saved)[0])


def test_split_low_ttfb_whitespace_collapse():
    from f5tts_tpu.infer.socket_server import TTSStreamingProcessor as JProc
    from f5tts_tpu_torch.infer.socket_server import TTSStreamingProcessor

    text = "A b.  C d.\nE f. " + "This is a longer sentence for the tail. " * 3
    procs = []
    for cls in (TTSStreamingProcessor, JProc):
        proc = cls.__new__(cls)
        proc.first_chunk_chars = (12, 40, 80)
        procs.append(proc._split_low_ttfb(text))
    assert procs[0] == procs[1]
    assert len(procs[0][0].encode("utf-8")) <= 12


def test_split_voice_segments_and_cli_config_match_jax(tmp_path):
    text = "Hello there. [town] Hi! [country] Howdy. [missing] x [main]  [town]back"
    assert tcli.split_voice_segments(text) == jcli.split_voice_segments(text)
    assert tcli.split_voice_segments("Hello there. [town] Hi!")[1] == ("town", "Hi!")
    toml = tmp_path / "c.toml"
    toml.write_text(
        'model = "F5TTS_v1_Base"\nref_audio = "a.wav"\nref_text = "hi"\n'
        'gen_text = "x"\nnfe_step = 16\n[voices.town]\nref_audio = "t.wav"\nref_text = "t"\n')
    for argv in (["-c", str(toml), "--nfe_step", "8"], ["-c", str(toml), "--save_chunk"],
                 ["-r", "b.wav", "-t", "y", "--speed", "0.9"]):
        cfg = tcli.load_config(tcli.build_parser().parse_args(argv))
        assert cfg == jcli.load_config(jcli.build_parser().parse_args(argv))
    cfg = tcli.load_config(tcli.build_parser().parse_args(["-c", str(toml), "--nfe_step", "8"]))
    assert cfg["nfe_step"] == 8 and cfg["voices"]["town"]["ref_audio"] == "t.wav"


@pytest.mark.parametrize("model,mel", [("F5TTS_v1_Base", "vocos"), ("F5TTS_Base", "vocos"),
                                       ("F5TTS_Base", "bigvgan"), ("E2TTS_Base", "vocos")])
def test_f5tts_raises_without_a_checkpoint(model, mel):
    assert tapi.checkpoint_spec(model, mel) == j_checkpoint_spec(model, mel)
    repo, filename = j_checkpoint_spec(model, mel)
    err = tapi.missing_checkpoint(model, mel)
    assert repo in str(err) and filename in str(err)
    if mel == "vocos":
        with pytest.raises(RuntimeError, match=filename.replace(".", r"\.")):
            tapi.F5TTS(model=model, device="cpu")


TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)


@pytest.fixture
def tiny_preset(monkeypatch):
    """A tiny DiT preset (2 NFE, a 512-frame cap) in the port's PRESETS."""
    monkeypatch.setitem(tconfig.PRESETS, "TinyDiT", tconfig.ModelConfig(
        name="TinyDiT", arch=tconfig.ModelArch(**TINY),
        sampling=tconfig.SamplingConfig(nfe_steps=2, max_duration=512)))
    return "TinyDiT"


def _ref(tmp_path) -> str:
    path = str(tmp_path / "ref.wav")
    taudio.write_wav(path, speech_and_silence(5, (1.0, -0.2, 0.9)), SR)
    return path


def test_f5tts_and_one_call_api_at_a_tiny_preset(tiny_preset, tmp_path):
    ref = _ref(tmp_path)
    tts = tapi.F5TTS(model=tiny_preset, ckpt_file="random", device="cpu", seed=2)
    out = str(tmp_path / "out.wav")
    wave, sr, mel = tts.infer(ref, "a voice.", "hello there, friend.", file_wave=out,
                              show_info=lambda *_: None)
    assert sr == SR and np.isfinite(wave).all() and mel.shape[0] == 100
    # int16 written truncated from x 32767, read back / 32768
    np.testing.assert_allclose(taudio.read_wav(out)[0], np.clip(wave, -1, 1), atol=2 / 32767)
    wav, ref_sr = taudio.read_wav(ref)
    np.testing.assert_array_equal(
        wave, tts.pipeline.infer(wav, ref_sr, "a voice.", "hello there, friend.", seed=2)[0])
    spec = tmp_path / "spec.png"
    tts.infer(ref, "a voice.", "hi there.", file_spec=str(spec), show_info=lambda *_: None)
    assert spec.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"

    model = tui.load_model(tiny_preset, device="cpu")
    voc = tui.load_vocoder(device="cpu")
    got = tui.infer_process((wav, ref_sr), "a voice.", "hello there, friend.", model, voc,
                            show_info=lambda *_: None, nfe_step=2, seed=1)
    want = model.pipeline(voc).infer(wav, ref_sr, "a voice.", "hello there, friend.", seed=1,
                                     nfe_step=2, speed=1.0, cfg_strength=2.0,
                                     sway_sampling_coef=-1.0, cross_fade_duration=0.15,
                                     target_rms=0.1)
    np.testing.assert_array_equal(got[0], want[0])
    chunks = ["hello there.", "and then some."]
    wave_b, sr_b, mel_b = tui.infer_batch_process(ref, "a voice. ", chunks, model, voc,
                                                  nfe_step=2)
    pipe = model.pipeline(voc)
    parts = [pipe.generate_chunk(wav, "a voice. ", c, nfe_step=2) for c in chunks]
    from f5tts_tpu_torch.infer.pipeline import cross_fade

    np.testing.assert_array_equal(wave_b, cross_fade([p[0] for p in parts], SR, 0.15))
    assert mel_b.shape[1] == sum(p[1].shape[1] for p in parts)
    streamed = list(tui.infer_batch_process(ref, "a voice. ", chunks, model, voc,
                                            streaming=True, chunk_size=4096, nfe_step=2))
    np.testing.assert_array_equal(np.concatenate([p for p, _ in streamed]),
                                  np.concatenate([p[0] for p in parts]))


def test_remove_silence_for_generated_wav_matches_jax(tmp_path):
    from f5tts_tpu.infer.utils_infer import remove_silence_for_generated_wav as jremove

    wav = speech_and_silence(3, (1.0, -2.5, 0.7, -1.5, 0.5))
    paths = [str(tmp_path / f"{n}.wav") for n in ("jax", "port")]
    for path in paths:
        taudio.write_wav(path, wav, SR)
    jremove(paths[0])
    tui.remove_silence_for_generated_wav(paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(paths[1]) < 44 + 2 * len(wav)


def test_cli_and_speech_edit_cli_at_a_tiny_preset(tiny_preset, tmp_path, capsys):
    from f5tts_tpu_torch.infer import speech_edit

    ref = _ref(tmp_path)
    toml = tmp_path / "c.toml"
    toml.write_text(f'model = "{tiny_preset}"\nref_audio = "{ref}"\nref_text = "a voice"\n'
                    'gen_text = "hello there. [two] and a second voice."\n'
                    f'[voices.two]\nref_audio = "{ref}"\nref_text = "another voice"\nspeed = 0.8\n')
    assert tcli.main(["-c", str(toml), "-p", "random", "-o", str(tmp_path), "-w", "cli.wav",
                      "--device", "cpu", "--save_chunk", "--remove_silence"]) == 0
    wav, sr = taudio.read_wav(str(tmp_path / "cli.wav"))
    assert sr == SR and len(wav) > 1000 and np.isfinite(wav).all()
    assert len(os.listdir(tmp_path / "cli")) == 2  # one saved chunk a voice segment
    out = str(tmp_path / "edit.wav")
    speech_edit.main(["--model", tiny_preset, "--ckpt_file", "random", "--audio", ref,
                      "--target_text", "a changed voice", "--parts", "0.3:0.6",
                      "--fix_durations", "0.4", "--nfe_step", "2", "--output", out,
                      "--device", "cpu"])
    edited, _ = taudio.read_wav(out)
    assert np.isfinite(edited).all() and len(edited) > 0.9 * len(taudio.read_wav(ref)[0])
    assert out in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="ASR"):
        tcli.main(["-m", tiny_preset, "-p", "random", "-r", ref, "-t", "hi there.",
                   "-o", str(tmp_path), "--device", "cpu"])
