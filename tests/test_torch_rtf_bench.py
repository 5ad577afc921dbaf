"""The port's RTF bench (f5tts_tpu_torch.eval.rtf_bench) against the JAX
package's (f5tts_tpu.eval.rtf_bench) on the CPU.

- `percentile_stats` equals the JAX one on the same samples;
- `bench_sampler(device="cpu", fused=False)` at a tiny preset (added to
  both packages' `PRESETS` for the test) returns the JAX bench's keys and
  its shape fields (the UNetT's bucket one frame short for its time token);
- `bench_sampler(device="cpu")` also runs the fused path (the pipeline's
  static buffers), and `bench_line` gives the root bench.py's keys;
- int8 (`quantization="int8"`, the port's W8A8 params) gives the JAX int8
  bench's keys, and `bench_line` carries `"quant": "int8"`; an unknown
  quantization raises.
The times themselves mean nothing here: the card gives them.
"""

import numpy as np
import pytest

from f5tts_tpu import config as jconfig
from f5tts_tpu.eval import rtf_bench as jbench
from f5tts_tpu_torch import config as tconfig
from f5tts_tpu_torch.eval import rtf_bench as tbench
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64, conv_layers=1)


@pytest.fixture
def tiny_presets(monkeypatch):
    monkeypatch.setenv("F5TTS_COMPILE_CACHE", "0")  # the JAX bench writes no cache
    for name, backbone in (("TinyDiT", "DiT"), ("TinyUNetT", "UNetT")):
        monkeypatch.setitem(jconfig.PRESETS, name, jconfig.ModelConfig(
            name=name, backbone=backbone, arch=jconfig.ModelArch(**TINY)))
        monkeypatch.setitem(tconfig.PRESETS, name, tconfig.ModelConfig(
            name=name, backbone=backbone, arch=tconfig.ModelArch(**TINY)))


def test_percentile_stats_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 5, 37):
        samples = list(rng.exponential(0.2, n))
        assert tbench.percentile_stats(samples) == jbench.percentile_stats(samples)


def _keys(d: dict) -> set:
    return {k if not isinstance(v, dict) else (k, frozenset(v)) for k, v in d.items()}


@pytest.mark.parametrize("model,frames", [("TinyDiT", 64), ("TinyUNetT", 63)])
def test_bench_sampler_keys_match_jax(tiny_presets, model, frames):
    kw = dict(nfe=2, seq_frames=64, prompt_frames=16, batch=1, runs=2, fused=False)
    want = jbench.bench_sampler(model, **kw)
    got = tbench.bench_sampler(model, device="cpu", **kw)
    assert _keys(got) == _keys(want)
    for k in ("model", "nfe", "batch", "seq_frames", "audio_seconds_per_batch", "quantization"):
        assert got[k] == want[k], k
    assert got["seq_frames"] == frames
    assert got["device"] == "cpu" and got["backend"] == "plain"
    assert got["total_s"] > 0 and got["rtf"] == got["total_s"] / got["audio_seconds_per_batch"]


def test_bench_sampler_fused_and_bench_line(tiny_presets):
    got = tbench.bench_sampler("TinyDiT", nfe=2, seq_frames=64, prompt_frames=16, runs=5,
                               device="cpu")
    assert {"fused_total_s", "fused_rtf", "fused_audio_seconds_per_s"} <= set(got)
    assert set(got["fused_latency"]) == set(got["latency"])
    line = tbench.bench_line(got)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "rtf_tinydit_2nfe_bs1" and line["unit"] == "rtf"
    assert line["value"] == round(got["fused_latency"]["p50_s"] / got["audio_seconds_per_batch"], 5)
    assert tbench.bench_line(dict(got, model="F5TTS_v1_Base", nfe=16))["metric"] == \
        "rtf_f5ttsv1base_16nfe_bs1"


def test_int8_raises_until_ported(tiny_presets):
    """int8 was not ported and raised; it runs now: its keys and shape fields
    against the JAX int8 bench, its bench line's quant. An unknown
    quantization still raises."""
    kw = dict(nfe=2, seq_frames=64, prompt_frames=16, batch=1, runs=2, quantization="int8")
    want = jbench.bench_sampler("TinyDiT", fused=False, **kw)
    got = tbench.bench_sampler("TinyDiT", device="cpu", **kw)
    fused = {"fused_total_s", "fused_rtf", "fused_audio_seconds_per_s", "fused_latency"}
    assert _keys({k: v for k, v in got.items() if k not in fused}) == _keys(want)
    for k in ("model", "nfe", "batch", "seq_frames", "audio_seconds_per_batch", "quantization"):
        assert got[k] == want[k], k
    assert got["quantization"] == "int8"
    assert tbench.bench_line(got)["extra"]["quant"] == "int8"
    with pytest.raises(ValueError, match="unknown quantization"):
        tbench.bench_sampler(quantization="fp4", device="cpu")
