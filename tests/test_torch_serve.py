"""Batched serving of the port (`generate_batch_async`, `serve_generate`,
`finalize_batch`, `DynamicBatcher`, `warmup`, `BatcherStats`) against the
JAX pipeline and `tests/test_serve.py`, on the CPU.

- host preparation exactly: the JAX pipeline's `_fused_serve` and the
  port's `serve_generate` replaced on their instances by spies that record
  their arguments; the int16 panel, the RMS scales, reference lengths, ids,
  min(totals, n_bucket), the time grid, the n bucket, the seed and the meta
  equal, for 1, 2, 3 and 5 requests, low-RMS references, speed and
  fix_duration, the pinyin and the char tokenizer;
- the serve body: `generate_batch` end to end with the noise the JAX
  `cfm_sample` draws from PRNGKey(seed) fed to the port, against the JAX
  `generate_batch` (its `_fused_serve`), for the DiT and the MMDiT, int16
  within 1e-3 of the peak + 1 LSB over live samples;
- a shorter batch after a longer one in the same key equals fresh bodies;
- the batcher, the warm-up buckets, the stats, power-of-two padding and the
  fine first-chunk gate, as the JAX tests hold them.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import SamplingConfig as JSampling
from f5tts_tpu.infer import pipeline as jpipe
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.text import pinyin as jpin
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch.config import SamplingConfig
from f5tts_tpu_torch.convert import vocos_params_from_jax
from f5tts_tpu_torch.infer import pipeline as tpipe
from f5tts_tpu_torch.infer import serve as tserve
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.text import pinyin as tpin
from f5tts_tpu_torch.text import vocab as tvocab
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import jx, np_params, small_dit
from tests.test_torch_mmdit import small_mmdit
from tests.test_torch_pipeline import VOCAB
from tests.test_torch_unett import small_unett
from tests.test_torch_vocos_mel import SMALL_VOCOS
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = {"DiT": small_dit, "UNetT": small_unett, "MMDiT": small_mmdit}
HOP = 256


@pytest.fixture(autouse=True)
def bundled_pinyin(monkeypatch):
    """Both tokenizers on their bundled tables (pypinyin pinned absent)."""
    for mod in (jpin, tpin):
        monkeypatch.setattr(mod, "_pypinyin", lambda: None)
        monkeypatch.setattr(mod, "_pinyin_dict", None)
        monkeypatch.setattr(mod, "_pinyin_words", None)
    monkeypatch.delenv("F5TTS_PINYIN_DICT", raising=False)


@pytest.fixture(scope="module")
def vocoders():
    jvcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jvcfg), 4)
    return (jvocos.Vocos(jx(vtree), jvcfg),
            tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**SMALL_VOCOS),
                         device="cpu"))


def _pipelines(vocoders, backbone="DiT", tokenizer="char", bucket_size=128, nfe=2,
               max_duration=512, with_jax=True):
    """(port pipeline on the CPU in f32, JAX pipeline in f32 on XLA or
    None), the same numpy-seeded weights."""
    jarch, tarch, tree, tp = SMALL[backbone](seed=3)
    vocab = VOCAB if tokenizer == "char" else tvocab.load_vocab(tvocab.EMILIA_VOCAB)
    port = tpipe.InferencePipeline(
        tp, tcfm.BACKBONES[backbone].statics_cls(tarch), vocoders[1], vocab,
        sampling=SamplingConfig(nfe_steps=nfe, max_duration=max_duration), tokenizer=tokenizer,
        dtype=torch.float32, device="cpu", backbone=backbone, bucket_size=bucket_size)
    if not with_jax:
        return port, None
    jbd = jcfm.BACKBONES[backbone]
    jp = jpipe.InferencePipeline(
        jx(tree), jbd.statics_cls(jarch), vocoders[0], vocab,
        sampling=JSampling(nfe_steps=nfe, max_duration=max_duration), tokenizer=tokenizer,
        dtype=jnp.float32, backend="xla", bucket_size=bucket_size, backbone=jbd)
    return port, jp


def _requests(n: int, seed: int, texts, extra=None) -> list[dict]:
    """n requests: reference lengths 0.4-1.7 s, every other one low-RMS
    (0.02 < 0.1, scaled up), the others loud (clipped at +-1 here and there)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        amp = 0.02 if i % 2 == 0 else 0.35
        wav = (rng.standard_normal(int(rng.integers(9000, 40000))) * amp).astype(np.float32)
        out.append({"ref_wav": wav, "ref_text": "a quiet voice. ",
                    "gen_text": texts[i % len(texts)], **(extra or {}).get(i, {})})
    return out


def _spy_jax(jp, calls):
    def spy(params, wav_i16, up, down, ref_lens, text, totals, t_grid, cfg, key, *, n_bucket):
        calls.append({"wav_i16": wav_i16, "up_scale": up, "down_scale": down,
                      "ref_lens": ref_lens, "text": text, "totals": totals, "t_grid": t_grid,
                      "cfg": cfg, "n_bucket": n_bucket,
                      "seed": np.asarray(jax.random.key_data(key))})
        return np.zeros((wav_i16.shape[0], (n_bucket - 1) * HOP), np.int16)
    jp._fused_serve = spy


def _spy_port(port, calls):
    def spy(wav_i16, up, down, ref_lens, text, totals, t_grid, cfg, n_bucket, y0=None, seed=0):
        calls.append({"wav_i16": wav_i16, "up_scale": up, "down_scale": down,
                      "ref_lens": ref_lens, "text": text, "totals": totals, "t_grid": t_grid,
                      "cfg": cfg, "n_bucket": n_bucket,
                      "seed": np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))})
        return tpipe.ServeHandle(torch.zeros(wav_i16.shape[0], (n_bucket - 1) * HOP,
                                             dtype=torch.int16))
    port.serve_generate = spy


CHAR_TEXTS = ["hello there.", "a much longer target text, to be spoken slowly.", "ok!"]
PINYIN_TEXTS = ["我们今天一起去公园散步。", "hello there, 不是吗?", "一天"]
PREP_CASES = [
    ("char", 1, {}),
    ("char", 2, {1: {"speed": 0.7}}),
    ("char", 3, {0: {"fix_duration": 2.2}, 2: {"speed": 1.3}}),
    ("pinyin", 5, {3: {"fix_duration": 1.0}}),
    ("pinyin", 2, {}),
]


@pytest.mark.parametrize("tokenizer,n,extra", PREP_CASES)
def test_host_preparation_matches_jax(vocoders, tokenizer, n, extra):
    port, jp = _pipelines(vocoders, tokenizer=tokenizer)
    texts = CHAR_TEXTS if tokenizer == "char" else PINYIN_TEXTS
    reqs = _requests(n, n, texts, extra)
    jcalls, tcalls = [], []
    _spy_jax(jp, jcalls)
    _spy_port(port, tcalls)
    for rep in range(2):  # the second time, the shape is warm on both sides
        kw = dict(seed=7 + rep, nfe_step=3, cfg_strength=1.5, sway_sampling_coef=-0.5)
        jh, jmeta = jp.generate_batch_async(reqs, **kw)
        th, tmeta = port.generate_batch_async(reqs, **kw)
        want, got = jcalls[-1], tcalls[-1]
        assert len(jcalls) == len(tcalls) == rep + 1
        for name in ("wav_i16", "up_scale", "down_scale", "ref_lens", "text", "totals",
                     "t_grid"):
            w, g = np.asarray(want[name]), np.asarray(got[name])
            assert w.shape == g.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert np.asarray(got["wav_i16"]).dtype == np.int16
        assert float(want["cfg"]) == got["cfg"] and want["n_bucket"] == got["n_bucket"]
        np.testing.assert_array_equal(got["seed"], want["seed"])
        assert list(tmeta[0]) == list(jmeta[0])
        np.testing.assert_array_equal(np.asarray(tmeta[1]), np.asarray(jmeta[1]))
        assert tmeta[2:] == jmeta[2:] and tmeta[3] == (rep == 0)
        jw, tw = jp.finalize_batch((jh, jmeta)), port.finalize_batch((th, tmeta))
        assert [len(w) for w in tw] == [len(w) for w in jw] and len(tw) == n
    assert port.seen_serve_shapes == jp.seen_serve_shapes
    assert port._finalized_serve_shapes == jp._finalized_serve_shapes


def _jax_noise_port(port, jp):
    """Wrap the port's serve_generate to feed it the noise the JAX
    `_fused_serve` draws from PRNGKey(seed) (`cfm.make_noise`, shared panel
    at max_duration rows)."""
    orig = port.serve_generate

    def with_jax_noise(wav_i16, up, down, ref_lens, text, totals, t_grid, cfg, n_bucket,
                       y0=None, seed=0):
        noise = jcfm.make_noise(jax.random.PRNGKey(seed), wav_i16.shape[0], n_bucket, 100,
                                jnp.asarray(totals), noise_max_len=jp.sampling.max_duration)
        return orig(wav_i16, up, down, ref_lens, text, totals, t_grid, cfg, n_bucket,
                    y0=np.array(noise), seed=seed)
    port.serve_generate = with_jax_noise


@pytest.mark.parametrize("backbone", ["DiT", "MMDiT"])
def test_generate_batch_matches_jax_serve(vocoders, backbone):
    port, jp = _pipelines(vocoders, backbone=backbone, nfe=3)
    _jax_noise_port(port, jp)
    reqs = _requests(3, 11, CHAR_TEXTS, {1: {"speed": 0.8}})
    kw = dict(seed=5, cfg_strength=2.0)
    want = jp.generate_batch(reqs, **kw)
    got = port.generate_batch(reqs, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        # int16 within 1e-3 of the peak + 1 LSB over the live samples
        d = np.abs(np.round(g * 32767) - np.round(w * 32767))
        assert d.max() <= 1e-3 * np.abs(w * 32767).max() + 1, (backbone, d.max())
    assert list(port.serve_graphs) == [(4, *next(iter(jp.seen_serve_shapes))[1:], 3)]


def test_shorter_batch_in_a_key_leaves_no_stale_rows(vocoders):
    port, _ = _pipelines(vocoders, with_jax=False)
    rng = np.random.default_rng(3)
    grid = tpipe.make_time_grid(2, sway_sampling_coef=-1.0)

    def batch(lens, totals, text_len):
        wav = np.zeros((2, 32768), np.int16)
        for i, L in enumerate(lens):
            wav[i, :L * HOP] = (rng.standard_normal(L * HOP) * 3000).astype(np.int16)
        text = np.full((2, 64), -1, np.int32)
        for i, t in enumerate(text_len):
            text[i, :t] = rng.integers(0, 32, t)
        return (wav, np.asarray([1.5, 1.0], np.float32), np.asarray([0.6, 1.0], np.float32),
                np.asarray(lens, np.int32), text, np.asarray(totals, np.int32), grid)

    long = batch([100, 90], [256, 250], [60, 64])
    short = batch([20, 40], [130, 90], [10, 30])
    outs = [port.serve_generate(*args, 2.0, 256, seed=4).wav for args in (long, short)]
    assert len(port.serve_graphs) == 1
    for args, out in zip((long, short), outs):
        inp = {name: torch.from_numpy(np.asarray(v)) for name, v in zip(
            ("wav_i16", "up_scale", "down_scale", "ref_lens", "text", "totals"), args[:6])}
        inp["t_grid"] = grid
        inp["cfg_strength"] = torch.tensor(2.0)
        inp["y0"] = tcfm.make_noise(torch.Generator().manual_seed(4), 2, 256, 100,
                                    inp["totals"], 512)
        torch.testing.assert_close(out, port._serve_body(inp)[1], atol=0, rtol=0)
    assert not torch.equal(outs[0][:, 90 * HOP:], outs[1][:, 90 * HOP:])


# -- the batcher and the serving layer, as tests/test_serve.py holds the JAX one


def _req(seed, text="hello there"):
    rng = np.random.default_rng(seed)
    return {"ref_wav": (rng.standard_normal(12000) * 0.05).astype(np.float32),
            "ref_text": "ref. ", "gen_text": text}


@pytest.fixture()
def pipe(vocoders):
    return _pipelines(vocoders, with_jax=False)[0]


@pytest.fixture()
def pipe256(vocoders):
    return _pipelines(vocoders, bucket_size=256, with_jax=False)[0]


def test_generate_batch_shapes(pipe):
    waves = pipe.generate_batch([_req(0), _req(1, "a much longer target text here")])
    assert len(waves) == 2 and all(np.isfinite(w).all() for w in waves)
    assert len(waves[1]) > len(waves[0])


def test_dynamic_batcher_groups_requests(pipe):
    calls = []
    orig = pipe.generate_batch_async

    def spy(reqs, *a, **kw):
        calls.append(len(reqs))
        return orig(reqs, *a, **kw)

    pipe.generate_batch_async = spy
    batcher = tserve.DynamicBatcher(pipe, max_batch_size=4, max_queue_delay_s=0.5)
    try:
        results = [None] * 3

        def worker(i):
            results[i] = batcher.submit(_req(i))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None and len(r) > 0 for r in results)
        assert max(calls) > 1
        # each batched row is the request served alone (same n bucket: the
        # batch's longest total; the wav and text buckets agree here)
        alone = pipe.generate_batch([_req(0)])[0]
        np.testing.assert_allclose(results[0], alone, atol=1e-4)
    finally:
        batcher.close()


@pytest.mark.parametrize("stage", ["dispatch", "finalize"])
def test_dynamic_batcher_propagates_errors(pipe, stage):
    def boom(*a, **kw):
        raise ValueError(f"bad {stage}")

    if stage == "dispatch":
        pipe.generate_batch_async = boom
    else:
        pipe.finalize_batch = boom
    batcher = tserve.DynamicBatcher(pipe, max_batch_size=2, max_queue_delay_s=0.01)
    try:
        with pytest.raises(RuntimeError, match=f"bad {stage}"):
            batcher.submit(_req(0), timeout=30)
        assert batcher.stats.snapshot()["error_count"] == 1
    finally:
        batcher.close()


@pytest.mark.parametrize("backbone,want", [("DiT", [256, 512]), ("UNetT", [255, 511])])
def test_warmup_captures_requested_buckets(vocoders, backbone, want):
    """warmup maps sizes to the widths the pipeline selects (the UNetT's
    128k - 1), pins fix_duration so each batch lands in its bucket, and
    leaves those shapes warm."""
    from f5tts_tpu.utils import duration_bucket as j_duration_bucket

    port, _ = _pipelines(vocoders, backbone=backbone, with_jax=False)
    assert tserve.warmup_buckets(port, [256, 512]) == want
    extra = port.bdef.seq_extra_tokens
    assert want == sorted({j_duration_bucket(f - extra, 128, 512, extra) for f in (256, 512)})
    rows = tserve.warmup(port, [256, 512], [1, 2])
    assert [(r["bucket"], r["batch"]) for r in rows] == [(w, b) for w in want for b in (1, 2)]
    assert sorted((k[3], k[0]) for k in port.serve_graphs) == [(w, b) for w in want
                                                               for b in (1, 2)]
    reqs = [{"ref_wav": np.zeros(48000, np.float32), "ref_text": "warm up. ",
             "gen_text": "w " * int(want[1] * 0.1), "fix_duration": want[1] * HOP / 24000}]
    assert port.generate_batch_async(reqs)[1][2:4] == (want[1], False)


def test_batcher_stats_and_http_stats_endpoint(pipe):
    import json
    import urllib.request
    from http.server import ThreadingHTTPServer

    batcher = tserve.DynamicBatcher(pipe, max_batch_size=4, max_queue_delay_s=0.2)
    try:
        results = [None, None]

        def call(i):
            results[i] = batcher.submit(_req(i))

        for _ in range(2):
            ts = [threading.Thread(target=call, args=(i,)) for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if _ == 0:
                s = batcher.stats.snapshot()
                assert s["success_count"] == 2 and s["error_count"] == 0
                assert s["batch_count"] == 1 and s["batch_occupancy"] == {"2": 1}
                assert s["queue_delay_avg_ms"] is not None and s["exec_avg_ms"] > 0
                assert len(s["compile_shapes"]) == 1 and s["cold_shape_events"]
                assert "COLD" in batcher.stats.summary()
        s2 = batcher.stats.snapshot()
        assert len(s2["cold_shape_events"]) == len(s["cold_shape_events"])
        assert s2["compile_shapes"]["b2_n256"] == 2

        server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(batcher, pipe.sr))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/stats",
                                        timeout=10) as r:
                body = json.loads(r.read())
            assert body["success_count"] == 4 and body["batch_occupancy"]["2"] == 2
        finally:
            server.shutdown()
            server.server_close()
    finally:
        batcher.close()


def test_batcher_stats_snapshot_matches_jax():
    from f5tts_tpu.infer import serve as jserve

    snaps = []
    for mod in (jserve, tserve):
        stats = mod.BatcherStats()
        reqs = [mod._Request({}) for _ in range(3)]
        for i, r in enumerate(reqs):
            r.t_enqueue = 10.0 + 0.001 * i
        stats.record_dispatch(reqs, 10.01)
        stats.record_shape(3, 256, cold=True)
        stats.record_shape(2, 512)
        stats.record_done(3, 0.25, True)
        stats.record_done(1, 0.5, False)
        snaps.append((stats.snapshot(), stats.summary()))
    assert snaps[0][0] == snaps[1][0]
    assert "COLD" in snaps[0][1] and "COLD" in snaps[1][1]


def test_batch_size_bucketing_pads_to_power_of_two(pipe):
    waves = pipe.generate_batch([_req(0), _req(1), _req(2, "some other text")])
    assert len(waves) == 3 and all(len(w) > 0 and np.isfinite(w).all() for w in waves)
    assert any(k[0] == 4 for k in pipe.seen_serve_shapes)
    assert not any(k[0] == 3 for k in pipe.seen_serve_shapes)
    pending = pipe.generate_batch_async([_req(i) for i in range(4)])
    assert pending[1][3] is False
    assert len(pipe.finalize_batch(pending)) == 4
    # the padded rows repeat the last request: its row equals the real one
    np.testing.assert_array_equal(waves[2], pipe.generate_batch(
        [_req(0), _req(1), _req(2, "some other text")])[2])


def test_fine_bucket_gated_on_warm_shape(pipe256):
    req = dict(_req(0), fix_duration=300 * 256 / 24000, fine_bucket=True)
    h, meta = pipe256.generate_batch_async([req])
    assert meta[2] == 512, "a cold fine shape falls back to the coarse bucket"
    assert all(np.isfinite(w).all() for w in pipe256.finalize_batch((h, meta)))
    pipe256.generate_batch([dict(req, fine_bucket=False)], bucket_size=128)
    h2, meta2 = pipe256.generate_batch_async([req])
    assert meta2[2] == 384, "a warm fine shape engages"
    pipe256.finalize_batch((h2, meta2))
    h3, meta3 = pipe256.generate_batch_async([req], bucket_size=256)
    assert meta3[2] == 512  # an explicit bucket_size bypasses the gate
    pipe256.finalize_batch((h3, meta3))


def test_fine_gate_requires_finalize_not_dispatch(pipe256):
    req = dict(_req(0), fix_duration=300 * 256 / 24000, fine_bucket=True)
    h, meta = pipe256.generate_batch_async([dict(req, fine_bucket=False)], bucket_size=128)
    assert meta[4] in pipe256.seen_serve_shapes
    h2, meta2 = pipe256.generate_batch_async([req])
    assert meta2[2] == 512, "an unfinalized fine shape keeps the gate shut"
    pipe256.finalize_batch((h, meta))
    h3, meta3 = pipe256.generate_batch_async([req])
    assert meta3[2] == 384
    pipe256.finalize_batch((h2, meta2))
    pipe256.finalize_batch((h3, meta3))


def test_fine_bucket_autowarm_background(pipe256):
    pipe256.fine_autowarm = True
    req = dict(_req(0), fix_duration=300 * 256 / 24000, fine_bucket=True)
    h, meta = pipe256.generate_batch_async([req], nfe_step=3)
    assert meta[2] == 512
    pipe256.finalize_batch((h, meta))
    deadline = time.time() + 120
    got = None
    while time.time() < deadline:
        h2, meta2 = pipe256.generate_batch_async([req], nfe_step=3)
        pipe256.finalize_batch((h2, meta2))
        got = meta2[2]
        if got == 384:
            break
        time.sleep(0.2)
    assert got == 384, f"the autowarm never engaged (last bucket {got})"
    # the warm-up ran at the request's NFE: the fine graph key is (.., 384, 3)
    assert any(k[3] == 384 and k[4] == 3 for k in pipe256.serve_graphs)


def test_device_lock_exclusive_waits_for_shared():
    lock = tpipe.DeviceLock()
    order = []
    release = threading.Event()

    def reader():
        with lock.shared():
            order.append("shared in")
            release.wait(5)
            order.append("shared out")

    def writer():
        with lock.exclusive():
            order.append("exclusive")

    r = threading.Thread(target=reader)
    r.start()
    while not order:
        time.sleep(0.01)
    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.1)
    late = threading.Thread(target=reader)  # a new shared holder waits for the writer
    late.start()
    time.sleep(0.1)
    assert order == ["shared in"]
    release.set()
    for t in (r, w, late):
        t.join(5)
    assert order[:3] == ["shared in", "shared out", "exclusive"]
    assert order[3:] == ["shared in", "shared out"]
