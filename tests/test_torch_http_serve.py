"""The port's HTTP serving (`infer/serve.py`'s handler, `infer/client_http.py`,
`eval/serve_bench.py`) on the CPU, against the JAX package's and
`tests/test_http_serve.py`.

- /tts round trips through `run_sweep`; /tts_stream streams chunked PCM and
  marks only its first text chunk for the fine bucket; each round trip's
  audio equals `generate_batch` on the same request;
- `chunk_text_low_ttfb` equals the JAX one on English, Chinese and
  collapsed-whitespace texts; `_wav_bytes` and `make_payloads` byte for byte;
- `serve_bench.main` on a tiny pipeline: zero errors, no cold shape after
  its warm-up, the JAX bench's keys.
"""

import base64
import dataclasses
import io
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from f5tts_tpu.eval import serve_bench as jbench
from f5tts_tpu.infer import pipeline as jpipe
from f5tts_tpu.infer import serve as jserve
from f5tts_tpu_torch.config import ModelArch, SamplingConfig
from f5tts_tpu_torch.eval import serve_bench as tbench
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.infer import client_http
from f5tts_tpu_torch.infer import pipeline as tpipe
from f5tts_tpu_torch.infer import serve as tserve
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.text import vocab as tvocab
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_serve import _pipelines, vocoders  # noqa: F401
from tests.test_torch_vocos_mel import SMALL_VOCOS
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STREAM_TEXT = "Hello there. This is a second, rather longer sentence to force another chunk."


@pytest.fixture()
def pipe(vocoders):  # noqa: F811
    return _pipelines(vocoders, with_jax=False)[0]


def _server(pipe, max_batch=2, window_s=0.05, stream=True):
    batcher = tserve.DynamicBatcher(pipe, max_batch_size=max_batch, max_queue_delay_s=window_s)
    server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(
        batcher, 24000, pipeline=pipe if stream else None))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return batcher, server, f"http://127.0.0.1:{server.server_address[1]}"


def _close(batcher, server):
    server.shutdown()
    server.server_close()
    batcher.close()


def _ref_file(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "ref.wav")
    audio_io.write_wav(path, (rng.standard_normal(12000) * 0.05).astype(np.float32), 24000)
    return path


def test_http_server_roundtrip(tmp_path, pipe):
    ref = _ref_file(tmp_path)
    batcher, server, url = _server(pipe, stream=False)
    try:
        payload = {"ref_path": ref, "ref_text": "ref.", "gen_text": "hello world"}
        stats = client_http.run_sweep(url, payload, n=3, concurrency=2)
        assert stats["errors"] == 0 and stats["requests"] == 3
        assert stats["audio_seconds"] > 0.5
        assert stats["latency_p99_s"] >= stats["latency_p50_s"]
        # one response against generate_batch on the same request
        import urllib.request

        req = urllib.request.Request(url + "/tts", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
        wav, sr = audio_io.read_wav(ref)
        want = pipe.generate_batch([{"ref_wav": wav, "ref_text": "ref.",
                                     "gen_text": "hello world"}])[0]
        assert body == tserve._wav_bytes(want, 24000)
    finally:
        _close(batcher, server)


def test_http_stream_endpoint(tmp_path, pipe):
    ref = _ref_file(tmp_path, 1)
    batcher, server, url = _server(pipe, window_s=0.001)
    try:
        ttfb, total, n_samples = client_http.send_request_stream(
            url, {"ref_path": ref, "ref_text": "ref.", "gen_text": STREAM_TEXT})
        assert n_samples > 2000 and 0 < ttfb <= total
    finally:
        _close(batcher, server)
    # the stream's samples are its chunks' batches, one after another
    wav, _ = audio_io.read_wav(ref)
    chunks = tpipe.chunk_text_low_ttfb(STREAM_TEXT)
    want = sum(len(pipe.generate_batch([{"ref_wav": wav, "ref_text": "ref. ", "gen_text": c,
                                         "speed": None}])[0]) for c in chunks)
    assert n_samples == want


def test_http_stream_first_chunk_requests_fine_bucket(tmp_path, pipe):
    seen_flags = []
    orig = pipe.generate_batch_async

    def spy(reqs, *a, **kw):
        seen_flags.extend(bool(r.get("fine_bucket")) for r in reqs)
        return orig(reqs, *a, **kw)

    pipe.generate_batch_async = spy
    ref = _ref_file(tmp_path, 1)
    batcher, server, url = _server(pipe, max_batch=1)
    try:
        client_http.send_request_stream(url, {"ref_path": ref, "ref_text": "ref.",
                                              "gen_text": STREAM_TEXT})
    finally:
        _close(batcher, server)
    assert len(seen_flags) >= 2
    assert seen_flags[0] is True and not any(seen_flags[1:])


def test_http_errors_answer_500(tmp_path, pipe):
    import urllib.error
    import urllib.request

    batcher, server, url = _server(pipe)
    try:
        req = urllib.request.Request(url + "/tts", data=json.dumps(
            {"ref_path": str(tmp_path / "missing.wav"), "gen_text": "x"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nothing", timeout=30)
        assert e.value.code == 404
    finally:
        _close(batcher, server)


LOW_TTFB_TEXTS = [
    ("One. Two three four. Five six seven eight nine ten. "
     "Eleven twelve thirteen fourteen fifteen sixteen seventeen. "
     "Another long tail sentence that should pack at the full budget."),
    "我们今天一起去公园散步。然后去银行，再回家吃饭！你好吗？我很好；谢谢。",
    "A b.  C d.\nE f. " + "This is a longer sentence for the tail. " * 3,
    "no punctuation at all in this one",
    "",
]


@pytest.mark.parametrize("text", LOW_TTFB_TEXTS)
@pytest.mark.parametrize("budgets", [(12, 40, 80), (12, 40), (200,)])
def test_chunk_text_low_ttfb_matches_jax(text, budgets):
    assert tpipe.chunk_text_low_ttfb(text, budgets) == jpipe.chunk_text_low_ttfb(text, budgets)
    assert tpipe.chunk_text_low_ttfb(text, budgets, 50) == \
        jpipe.chunk_text_low_ttfb(text, budgets, 50)


def test_wav_bytes_and_payloads_match_jax():
    wave = np.random.default_rng(2).standard_normal(5000).astype(np.float32) * 0.7
    assert tserve._wav_bytes(wave, 24000) == jserve._wav_bytes(wave, 24000)
    for profile in ("long", "ref"):
        assert tbench.make_payloads(11, 24000, profile) == jbench.make_payloads(11, 24000,
                                                                                profile)
    assert (tbench.GEN_SHORT, tbench.GEN_LONG) == (jbench.GEN_SHORT, jbench.GEN_LONG)
    payload = tbench.make_payloads(1, 24000)[0]
    wav, sr = audio_io.read_wav(io.BytesIO(base64.b64decode(payload["ref_audio_b64"])))
    assert sr == 24000 and len(wav) == int(24000 * 3.8)


def test_serve_bench_main_on_a_tiny_pipeline(capsys):
    arch = ModelArch(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32,
                     conv_layers=1, text_num_embeds=2545)
    params = tcfm.BACKBONES["DiT"].init(torch.Generator().manual_seed(0), arch)
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator().manual_seed(1),
                                         tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    pipe = tpipe.InferencePipeline(
        params, tcfm.BACKBONES["DiT"].statics_cls(arch), voc,
        tvocab.load_vocab(tvocab.EMILIA_VOCAB),
        sampling=dataclasses.replace(SamplingConfig(), nfe_steps=2, max_duration=512),
        dtype=torch.float32, device="cpu")
    line = tbench.main(["--requests", "4", "--concurrency", "2", "--profile", "ref",
                        "--stream", "1", "--window_ms", "1", "20"], pipe=pipe)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    extra = line["extra"]
    assert extra["errors"] == 0 and extra["requests"] == 4
    assert [r["window_ms"] for r in extra["window_sweep"]] == [1.0, 20.0]
    for row in extra["window_sweep"]:
        assert row["errors"] == 0 and row["server_stats"]["cold_shape_events"] == []
    assert extra["stream_requests"] == 1 and extra["ttfb_p50_ms"] > 0
    assert line["metric"] == "serve_rtf_concurrency2" and line["unit"] == "rtf"
    # the JAX bench's keys, with the device and the timed streams' stats added
    assert set(extra) == {"window_ms", "rtf", "requests", "errors", "wall_s", "audio_seconds",
                          "latency_avg_ms", "latency_p50_ms", "latency_p99_ms", "server_stats",
                          "stream_requests", "ttfb_p50_ms", "ttfb_p90_ms",
                          "stream_total_p50_ms", "baseline_latency_avg_ms", "window_sweep",
                          "nfe", "max_batch", "quant", "device", "stream_server_stats"}
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}


def test_serve_bench_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.build_pipeline(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--ckpt_file", "random", "--model", "F5TTS_v1_Base"])
