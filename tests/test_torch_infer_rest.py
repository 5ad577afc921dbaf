"""The port's last serving entry points on the CPU against the JAX package's:
`infer/multistyle.py`, `infer/voice_chat.py`, `infer/viz.py`,
`infer/grpc_server.py` and `infer/asr.py`.

- multistyle: `tests/test_multistyle.py`'s texts and cases through both
  packages (a fake `infer_fn`): the same segments, waves, metadata, ref
  texts, warnings and calls;
- voice_chat: `tests/test_voice_chat.py`'s stubbed turns, the same replies,
  histories and calls;
- viz: the PNG written (matplotlib, skipped without it), byte-equal to
  the JAX one;
- gRPC (skipped without `grpc`): Synthesize, SynthesizeStream and Stats
  over a stub batcher, the bytes equal to the JAX server's;
- asr: `transcribe` raises its "ASR unavailable" RuntimeError offline (the
  model is read from the local cache only), and
  `utils_infer.preprocess_ref_audio_text` transcribes an empty text
  through it, cached, as the JAX one does.
"""

import json
import socket
import sys
import types

import numpy as np
import pytest
import torch

from f5tts_tpu.infer import asr as jasr
from f5tts_tpu.infer import multistyle as jms
from f5tts_tpu.infer import voice_chat as jvc
from f5tts_tpu_torch.infer import asr as tasr
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.infer import multistyle as tms
from f5tts_tpu_torch.infer import utils_infer as tui
from f5tts_tpu_torch.infer import voice_chat as tvc
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PARSE_TEXTS = [
    "{Regular} Hello there. {Angry} Darn you! {Whisper} bye",
    "plain lead-in {Sad} after",
    "{Shouting} one\ntwo {Calm} three",
    '{"name": "Speaker1_Happy", "seed": 7, "speed": 1.5} hi {"name": "Speaker2", "seed": -1, '
    '"speed": 1} yo',
    '{"name": "X"} hello',
    "{not json: here} text",
    "{A}{B} only b",
    "   ",
    "",
]

# (names, audios, ref texts, text) of tests/test_multistyle.py's synthesis cases
SYNTH_CASES = [
    (["Regular", "Angry"], ["r.wav", "a.wav"], ["ref r", ""], "{Regular} one {Angry} two"),
    (["Regular"], ["r.wav"], ["ref"], "{Ghost} boo"),
    (["", "Angry"], ["", "a.wav"], ["", "ra"], "untagged needs Regular"),
    (["Regular"], ["r.wav"], ["ref"], '{"name": "Regular", "seed": 42, "speed": 2.0} a {Regular} b'),
    (["Regular"], ["r.wav"], [""], "{Regular} a {Regular} b"),
    (["Regular"], ["r.wav"], ["ref"], ""),
    (["Regular", "Calm", "Angry"], ["r.wav", "c.wav", "a.wav"], ["r", "", "a"],
     "lead {Calm} calm one {Angry} loud {Calm} calm again {Nope} x"),
]


def test_parse_and_collect_match_jax():
    for text in PARSE_TEXTS:
        got, want = tms.parse_speechtypes_text(text), jms.parse_speechtypes_text(text)
        assert [vars(s) for s in got] == [vars(s) for s in want]
    rows = (["Regular", "", "Angry"], ["a.wav", "b.wav", ""], ["ra", "rb", "rc"])
    got, want = tms.collect_speech_types(*rows), jms.collect_speech_types(*rows)
    assert [(k, vars(v)) for k, v in got.items()] == [(k, vars(v)) for k, v in want.items()]


def _fake_infer(calls):
    def infer_fn(audio, ref_text, text, seed, speed):
        calls.append(dict(audio=audio, ref_text=ref_text, text=text, seed=seed, speed=speed))
        out_ref = ref_text or f"transcribed:{audio}"
        return 24000, np.full(4 + len(text), float(len(calls)), np.float32), out_ref, seed
    return infer_fn


@pytest.mark.parametrize("case", range(len(SYNTH_CASES)))
def test_synthesize_multistyle_matches_jax(case):
    names, audios, refs, text = SYNTH_CASES[case]
    out = []
    for mod in (jms, tms):
        calls = []
        stypes = mod.collect_speech_types(names, audios, refs)
        res = mod.synthesize_multistyle(text, stypes, _fake_infer(calls),
                                        rng=np.random.default_rng(5))
        out.append((res, calls, [(k, vars(v)) for k, v in stypes.items()]))
    (want, wcalls, wtypes), (got, gcalls, gtypes) = out
    assert gcalls == wcalls and gtypes == wtypes
    assert (got.sample_rate, got.ref_texts, got.metadata, got.warnings) == (
        want.sample_rate, want.ref_texts, want.metadata, want.warnings)
    if want.wave is None:
        assert got.wave is None
    else:
        np.testing.assert_array_equal(got.wave, want.wave)
        assert len(got.wave) == sum(4 + len(c["text"]) for c in gcalls)


def _engine(mod):
    calls = {"tts": [], "chat": [], "asr": []}

    def tts(ref_wav, ref_sr, ref_text, gen_text):
        calls["tts"].append((len(ref_wav), ref_sr, ref_text, gen_text))
        return np.full(2400, 0.1, np.float32), 24000

    def chat(messages):
        calls["chat"].append([dict(m) for m in messages])
        return f"reply#{len(calls['chat'])}"

    def asr(wav, sr):
        calls["asr"].append((len(wav), sr))
        return f"transcribed {len(calls['asr'])}"

    return mod.VoiceChatEngine(tts=tts, chat=chat, asr=asr), calls


def test_voice_chat_matches_jax():
    assert tvc.DEFAULT_SYSTEM_PROMPT == jvc.DEFAULT_SYSTEM_PROMPT
    assert tvc.DEFAULT_CHAT_MODELS == jvc.DEFAULT_CHAT_MODELS
    ref = np.zeros(24000, np.float32)
    runs = []
    for mod in (jvc, tvc):
        eng, calls = _engine(mod)
        outs = [eng.respond_to_text("hello", ref, 24000, "a ref.")[:1],
                eng.respond_to_audio(np.zeros(16000, np.float32), 16000, ref, 24000, "a ref.")[:2],
                eng.respond_to_text("again", ref, 24000, "a ref.")[:1]]
        history = list(eng.history)
        eng.reset()
        runs.append((outs, history, calls, eng.history))
    assert runs[1] == runs[0]
    assert len(runs[1][1]) == 6 and runs[1][3] == []
    assert tvc.default_asr() is tasr.transcribe


def test_save_spectrogram_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from f5tts_tpu.infer.viz import save_spectrogram as jsave
    from f5tts_tpu_torch.infer.viz import save_spectrogram

    mel = np.random.default_rng(0).standard_normal((100, 50)).astype(np.float32)
    got, want = tmp_path / "port.png", tmp_path / "jax.png"
    save_spectrogram(mel, str(got))
    jsave(mel, str(want))
    assert got.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and got.stat().st_size > 1000
    assert got.read_bytes() == want.read_bytes()


class _StubStats:
    def snapshot(self):
        return {"success_count": 2, "error_count": 0, "exec_avg_ms": 1.5}


class _StubBatcher:
    """submit(payload) -> a wave from the payload alone; records the payloads."""

    def __init__(self):
        self.payloads = []
        self.stats = _StubStats()

    def submit(self, payload, timeout=120.0):
        self.payloads.append({k: v for k, v in payload.items() if k != "ref_wav"})
        n = 2000 + 37 * len(payload["gen_text"])
        return (0.5 * np.sin(np.arange(n) * 0.01 * (1 + len(payload["ref_wav"]) % 7))
                ).astype(np.float32)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_grpc_round_trip_matches_jax(tmp_path):
    pytest.importorskip("grpc")
    from f5tts_tpu.infer import grpc_server as jgrpc
    from f5tts_tpu_torch.infer import grpc_server as tgrpc

    ref = str(tmp_path / "ref.wav")
    audio_io.write_wav(ref, (np.random.default_rng(0).standard_normal(12000) * 0.05)
                       .astype(np.float32), 16000)
    text = "Hello there. This is a second, rather longer sentence to force another chunk."
    results = []
    for mod in (jgrpc, tgrpc):
        batcher, port = _StubBatcher(), _free_port()
        server = mod.serve(batcher, 24000, "127.0.0.1", port)
        target = f"127.0.0.1:{port}"
        try:
            wav = mod.synthesize(target, ref, "ref.", "hello world", timeout=60, speed=1.1)
            chunks = list(mod.synthesize_stream(target, ref, "ref text", text, timeout=60))
            stats = mod.fetch_stats(target, timeout=30)
        finally:
            server.stop(0)
        results.append((wav, chunks, stats, batcher.payloads))
    assert results[1] == results[0]
    wav, chunks, stats, payloads = results[1]
    assert wav[:4] == b"RIFF" and len(chunks) >= 2 and stats["success_count"] == 2
    assert payloads[1]["fine_bucket"] is True and not any(p["fine_bucket"] for p in payloads[2:])
    assert json.loads(json.dumps(payloads[0]))["speed"] == 1.1


def test_asr_raises_offline_and_feeds_preprocess(tmp_path, monkeypatch):
    monkeypatch.setattr(tasr, "_asr_pipe", None)
    with pytest.raises(RuntimeError, match="ASR unavailable"):  # no card here
        tasr.transcribe(np.zeros(16000, np.float32), 16000)
    monkeypatch.setitem(sys.modules, "transformers", None)  # the card's machine: none
    with pytest.raises(RuntimeError, match=r"ASR unavailable \((ModuleNotFound|Import)Error"):
        tasr.initialize_asr_pipeline(device="cpu")
    built = []
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        pipeline=lambda *a, **kw: built.append((a, kw))))
    pytest.importorskip("huggingface_hub")
    with pytest.raises(RuntimeError, match="ASR unavailable"):  # not in the local cache
        tasr.initialize_asr_pipeline("openai/whisper-large-v3-turbo", device="cpu")
    model_dir = tmp_path / "whisper"
    model_dir.mkdir()
    assert tasr.initialize_asr_pipeline(str(model_dir), device="cpu") is None
    assert built == [(("automatic-speech-recognition",),
                      {"model": str(model_dir), "device": torch.device("cpu")})]
    monkeypatch.setattr(tasr, "_asr_pipe", None)
    monkeypatch.delitem(sys.modules, "transformers")
    path = str(tmp_path / "ref.wav")
    audio_io.write_wav(path, (0.2 * np.sin(np.arange(36000) * 0.05)).astype(np.float32), 24000)
    with pytest.raises(RuntimeError, match="ASR"):
        tui.preprocess_ref_audio_text(path, "  ", show_info=lambda *_: None)

    heard = {"port": [], "jax": []}
    for side, mod in (("port", tasr), ("jax", jasr)):
        monkeypatch.setattr(mod, "transcribe", lambda wav, sr, language=None, side=side: (
            heard[side].append((len(wav), sr, language)) or "heard words"))
    monkeypatch.setattr(tui, "_ref_text_cache", {})
    monkeypatch.setattr(jasr, "_ref_text_cache", {})
    for _ in range(2):  # the second call reads the cache
        got = tui.preprocess_ref_audio_text(path, "", show_info=lambda *_: None, language="en")
        want = jasr.preprocess_ref_audio_text(path, "", show_info=lambda *_: None, language="en")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (24000, "heard words. ")
    assert heard["port"] == heard["jax"] and len(heard["port"]) == 1
