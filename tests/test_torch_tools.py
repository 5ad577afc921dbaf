"""The port's tools on the CPU: profiling (f5tts_tpu_torch.profiling), the
FLOP counter (scripts/count_params_gflops.py, and the operators' FLOP
formulas), the parity gate (scripts/parity_check.py) and the TF32 hold of
the f32 modules (f5tts_tpu_torch.precision).

- `StageTimer.report()` and `summarize_trace` against the JAX package's on
  the same stages and the same synthetic nested trace events (the JAX
  function reads XLA device events, the port's CUDA kernel events);
- `analyze`'s parameter count against the JAX `analyze` on a tiny preset
  added to both `PRESETS`; each operator's FLOP formula against what
  `FlopCounterMode` counts for its plain version;
- parity_check's legs as tests/test_parity_full.py and
  tests/test_parity_gate.py run the JAX script's: the int8 A/B, the vocoder
  decode, the metric smoke, the --full wiring, the digestion audit on a
  reference-format checkpoint (and its failure on an unread tensor), the
  golden written and compared, the mirror golden; `build_fixed_inputs`
  equal to the JAX script's draws;
- `precision.full_f32`: a vocoder's convolution sees TF32 off while the
  global flags are on, and the flags are the caller's again afterwards;
  nesting; a second thread waits while one is inside.
"""

import dataclasses
import gzip
import inspect
import json
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from f5tts_tpu import profiling as jprof
from f5tts_tpu.config import PRESETS as J_PRESETS
from f5tts_tpu.scripts import count_params_gflops as jcount
from f5tts_tpu.scripts import parity_check as jparity
from f5tts_tpu_torch import precision
from f5tts_tpu_torch import profiling as tprof
from f5tts_tpu_torch.compat.torch_import import to_vocos_reference_keys, write_safetensors
from f5tts_tpu_torch.config import PRESETS as T_PRESETS
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.ops import adaln_norm as tnorm
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops import grouped_conv as tgc
from f5tts_tpu_torch.scripts import count_params_gflops as tcount
from f5tts_tpu_torch.scripts import parity_check as tparity
from f5tts_tpu_torch.train.checkpoint import to_reference_keys
from f5tts_tpu_torch.vocoder.bigvgan import BigVGAN, BigVGANConfig, init_bigvgan
from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig, init_vocos
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.test_torch_export import _operator_cases
from tests.test_torch_vocos_mel import SMALL_VOCOS

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=24, conv_layers=1)


@pytest.fixture
def tiny_preset(monkeypatch):
    """A tiny F5TTS_v1_Base-shaped preset "Tiny" in both packages' PRESETS."""
    for presets in (J_PRESETS, T_PRESETS):
        base = presets["F5TTS_v1_Base"]
        monkeypatch.setitem(presets, "Tiny", dataclasses.replace(
            base, arch=dataclasses.replace(base.arch, **TINY)))
    return "Tiny"


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_stage_timer_reports_as_the_jax_one():
    timers = (jprof.StageTimer(), tprof.StageTimer())
    for timer in timers:
        for name in ("prep", "sampler", "prep", "vocoder"):
            with timer.stage(name, sync=name == "vocoder"):
                time.sleep(0.001)
    jrep, trep = (t.report() for t in timers)
    assert list(jrep) == list(trep) == ["prep", "sampler", "vocoder"]
    for name in jrep:
        assert set(jrep[name]) == set(trep[name]) == {"total_s", "count", "avg_ms"}
        assert jrep[name]["count"] == trep[name]["count"]
        assert trep[name]["avg_ms"] >= 1.0
    timers[1].reset()
    assert timers[1].report() == {}


# (name, ts us, dur us, track): parents enclose children on their track
NESTED = [("loop", 0, 100, 0), ("gemm", 5, 20, 0), ("norm", 30, 10, 0), ("gemm", 45, 30, 0),
          ("inner", 50, 10, 0), ("attn", 120, 40, 0), ("attn", 0, 15, 1), ("conv", 20, 5, 1),
          ("conv", 30, 5, 1), ("norm", 40, 2, 1)]


def _write_trace(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_trace_matches_jax_on_nested_events(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(), tdir.mkdir()
    _write_trace(jdir / "host.trace.json.gz", [
        {"ph": "X", "name": n, "ts": ts, "dur": d, "pid": 1, "tid": t,
         "args": {"device_duration_ps": d * 10 ** 6}} for n, ts, d, t in NESTED])
    _write_trace(tdir / "1.2.pt.trace.json.gz", [
        {"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 7 + t,
         "args": {"correlation": i}} for i, (n, ts, d, t) in enumerate(NESTED)])
    want = jprof.summarize_trace(str(jdir), key="op")
    got = tprof.summarize_trace(str(tdir), key="op")
    assert [(k, c) for k, _, c in got] == [(k, c) for k, _, c in want]
    # the port rounds ms to 4 places (scripts.common.device_time_by_class)
    np.testing.assert_allclose([ms for _, ms, _ in got], [ms for _, ms, _ in want], atol=1e-4)
    assert {k for k, _, _ in got} == {"gemm", "norm", "inner", "attn", "conv"}  # leaves only


def test_summarize_trace_by_source_names_the_launching_operator(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "f5tts::adaln_norm", "ts": 0, "dur": 50, "pid": 9,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty_like", "ts": 2, "dur": 3, "pid": 9,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
         "pid": 9, "tid": 1, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 60, "dur": 20, "pid": 9, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 65, "dur": 5,
         "pid": 9, "tid": 1, "args": {"correlation": 12}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 90, "dur": 5,
         "pid": 9, "tid": 1, "args": {"correlation": 13}},
        {"ph": "X", "cat": "kernel", "name": "void norm_rows_kernel<AdaLNEpi, 8>(int, float)",
         "ts": 20, "dur": 4, "pid": 0, "tid": 7, "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x64", "ts": 70, "dur": 6, "pid": 0,
         "tid": 7, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "void fused_qkv_rope_attn_kernel<1>(float)",
         "ts": 100, "dur": 9, "pid": 0, "tid": 7, "args": {"correlation": 13}},
    ]
    _write_trace(tmp_path / "1.1.pt.trace.json.gz", events)
    rows = tprof.summarize_trace(str(tmp_path), key="source")
    assert [(k, c) for k, _, c in rows] == [("fused_qkv_rope_attn_kernel<1>", 1),
                                            ("aten::mm", 1), ("f5tts::adaln_norm", 1)]
    by_op = tprof.summarize_trace(str(tmp_path), key="op")
    assert [k for k, _, _ in by_op] == ["fused_qkv_rope_attn_kernel<1>", "nvjet_tst_128x64",
                                        "norm_rows_kernel<AdaLNEpi, 8>"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(4, 64, 128)
    with tprof.device_trace(str(tmp_path)) as logdir:
        with tprof.annotate("norm"):
            tnorm.adaln_norm(x, torch.zeros(4, 128), torch.zeros(4, 128))
    paths = list(tmp_path.glob("*.pt.trace.json.gz"))
    assert logdir == str(tmp_path) and len(paths) == 1
    with gzip.open(paths[0], "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "f5tts::adaln_norm" in names and "norm" in names
    assert tprof.summarize_trace(str(tmp_path)) == []  # no kernel on the CPU


# ---------------------------------------------------------------------------
# the FLOP counter
# ---------------------------------------------------------------------------

def test_analyze_params_equal_the_jax_count(tiny_preset):
    got = tcount.analyze(tiny_preset, secs=1.0, vocab=100, device="cpu")
    want = jcount.analyze(tiny_preset, secs=1.0, vocab=100)
    assert set(got) == set(want) == {"model", "params", "params_M", "gflops_fwd", "frames"}
    assert (got["params"], got["frames"], got["model"]) == (want["params"], want["frames"],
                                                           want["model"])
    # one forward of 93 frames: the projections' 2 x multiply-adds, the
    # attention's 4 b h n^2 d, the grouped convs' 2 b n c (c / g) k. Tiny's
    # 2 heads of 32 take the head layout and its 4 channels a group XLA's
    # conv, as the JAX package's gates send them
    n_params, flops, frames = tcount.count(tiny_preset, secs=1.0, vocab=100, device="cpu")
    assert frames == 93 and n_params == got["params"]
    assert flops["f5tts.flash_attention"] == 2 * 4 * 2 * frames ** 2 * 32
    assert flops["aten.convolution"] == 2 * 2 * frames * 64 * 4 * 31  # two convs
    assert flops["f5tts.adaln_norm"] == 0
    assert got["gflops_fwd"] == pytest.approx(sum(flops.values()) / 1e9)
    assert tcount.attention_flops(flops) == flops["f5tts.flash_attention"]


def test_count_main_prints_the_reference_beside(tiny_preset, capsys):
    row = tcount.main(["--model", tiny_preset, "--secs", "1", "--vocab", "100",
                       "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["params"] == row["params"]
    assert "reference" not in row  # no published numbers for this preset
    assert tcount.REFERENCE["F5TTS_v1_Base"][1:] == (335.8, 363.4)
    assert tcount.REFERENCE["E2TTS_Base"][1:] == (333.2, 622.1)


PLAIN = {
    "adaln_norm": tnorm.adaln_norm_ref,
    "rms_norm": tnorm.rms_norm_ref,
    "conv_pos_embedding": tgc.conv_pos_embedding_ref,
    "grouped_conv1d": tgc.grouped_conv1d_ref,
    "fused_qkv_rope_attention": tatt.fused_qkv_rope_attention_ref,
    "fused_qkv_rope_attention_lse": lambda *a: tatt.fused_qkv_rope_attention_ref(*a, True),
    "fused_qkv_rope_attention_bias": tatt.fused_qkv_rope_attention_bias_ref,
    "fused_qkv_rope_attention_bias_lse": lambda *a: tatt.fused_qkv_rope_attention_bias_ref(
        *a, True),
    "flash_attention": tatt.flash_attention_fwd_ref,
    "flash_attention_lse": lambda *a: tatt.flash_attention_fwd_ref(*a, True),
    "masked_flash_attention": tatt.mha_reference_masked,
}


@pytest.mark.parametrize("case", range(len(_operator_cases())))
def test_flop_formula_equals_the_count_of_the_plain_version(case):
    from f5tts_tpu_torch.ops._operators import OPERATORS

    name, args = _operator_cases()[case]
    counts = []
    for fn in (OPERATORS[name], PLAIN[name]):
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args)
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1], name
    assert (counts[0] > 0) == ("norm" not in name), name


# ---------------------------------------------------------------------------
# parity_check
# ---------------------------------------------------------------------------

def test_build_fixed_inputs_are_the_jax_scripts_draws():
    arch = T_PRESETS["F5TTS_v1_Base"].arch
    got = tparity.build_fixed_inputs(arch, n=128, nt=16, b=2, seed=3)
    want = jparity.build_fixed_inputs(arch, n=128, nt=16, b=2, seed=3)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(w))


def _tiny_dit(seed: int = 0):
    arch = dataclasses.replace(T_PRESETS["F5TTS_v1_Base"].arch, **TINY, text_num_embeds=40)
    gen = torch.Generator().manual_seed(seed)
    return arch, tdit.activate_zero_init(tdit.init_dit(gen, arch), gen)


def test_leg_int8_ab_synthetic():
    arch, params = _tiny_dit()
    status, detail = tparity.leg_int8_ab(params, tdit.DiTStatics(arch, "cpu"), nfe=4, n=128,
                                         device="cpu")
    assert status == "OK", detail
    assert "rel-L2" in detail and "SNR" in detail


def test_leg_vocoder_decode_vocos_synthetic(tmp_path):
    cfg = VocosConfig(**SMALL_VOCOS)
    path = tmp_path / "vocos.pt"
    torch.save(to_vocos_reference_keys(init_vocos(torch.Generator().manual_seed(0), cfg)),
               str(path))
    outs = {"nfe16": np.random.default_rng(0).standard_normal((1, 128, 100)).astype(np.float32)}
    status, detail = tparity.leg_vocoder_decode(outs, "vocos", str(path), voc_cfg=cfg,
                                                device="cpu")
    assert status == "OK", detail


def test_leg_metric_smoke_skips_without_weights(tmp_path):
    t = np.arange(24000, dtype=np.float32) / 24000
    wav = (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    rows = tparity.leg_metric_smoke(wav, 24000, str(tmp_path), device="cpu")
    names = {r[0]: r[1] for r in rows}
    assert names["sim"] == names["utmos"] == "SKIP"
    assert names["wer-asr"] in ("SKIP", "OK")
    assert all(r[1] != "FAIL" for r in rows)


def test_leg_metric_smoke_scores_with_synthetic_utmos(tmp_path):
    from f5tts_tpu_torch.eval.utmos22 import UTMOS22Strong

    torch.manual_seed(0)
    model = UTMOS22Strong()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.02)
    ck = tmp_path / "utmos.pt"
    torch.save(model.state_dict(), str(ck))
    t = np.arange(24000, dtype=np.float32) / 24000
    wav = (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    rows = tparity.leg_metric_smoke(wav, 24000, str(tmp_path), utmos_ckpt=str(ck), device="cpu")
    names = {r[0]: (r[1], r[2]) for r in rows}
    assert names["utmos"][0] == "OK", names["utmos"]


def test_full_flag_wiring():
    src = inspect.getsource(tparity.main)
    for flag in ("--full", "--vocos_ckpt", "--bigvgan_ckpt", "--ecapa_ckpt", "--utmos_ckpt",
                 "--smooth", "--ckpt", "--model", "--vocab", "--nfe", "--golden",
                 "--write-golden", "--mirror-golden", "--workdir", "--device"):
        assert f'"{flag}"' in src
    assert "args.mirror_golden = True" in src


def _checkpoint(tmp_path, params, extra=None):
    sd = {k: torch.from_numpy(v) for k, v in to_reference_keys(params).items()}
    # the non-weight buffers a real checkpoint carries
    sd["mel_spec.mel_stft.mel_scale.fb"] = torch.zeros(513, 100)
    sd["transformer.rotary_embed.freqs"] = torch.zeros(16)
    sd.update(extra or {})
    path = tmp_path / "model.safetensors"
    write_safetensors(sd, str(path))
    return str(path)


def test_main_audit_golden_and_full_on_a_written_checkpoint(tiny_preset, tmp_path, capsys):
    _, params = _tiny_dit()
    ckpt = _checkpoint(tmp_path, dict(params, text_embed=dict(
        params["text_embed"], embed={"w": torch.randn(2546, 24)})))
    base = ["--ckpt", ckpt, "--model", tiny_preset, "--device", "cpu", "--nfe", "2", "4"]
    golden = str(tmp_path / "golden.npz")
    tparity.main(base + ["--write-golden", golden])
    assert sorted(np.load(golden).files) == ["nfe2", "nfe4"]
    with pytest.raises(SystemExit) as e:
        tparity.main(base + ["--golden", golden])
    assert e.value.code == 0
    vocos = tmp_path / "vocos.pt"
    torch.save(to_vocos_reference_keys(init_vocos(torch.Generator().manual_seed(1))), str(vocos))
    tparity.main(base + ["--full", "--vocos_ckpt", str(vocos), "--workdir", str(tmp_path),
                         "--mirror-n", "64", "--mirror-nfe", "2"])
    out = capsys.readouterr().out
    assert "digestion audit OK" in out and "mirror golden (DiT, n=64, nfe=2)" in out
    assert "vocoder-vocos    OK" in out and "int8-ab          OK" in out


def test_main_fails_on_an_unread_tensor(tiny_preset, tmp_path, capsys):
    _, params = _tiny_dit()
    ckpt = _checkpoint(tmp_path, dict(params, text_embed=dict(
        params["text_embed"], embed={"w": torch.randn(2546, 24)})),
        {"transformer.some_new_module.weight": torch.zeros(4, 4)})
    with pytest.raises(SystemExit) as e:
        tparity.main(["--ckpt", ckpt, "--model", tiny_preset, "--device", "cpu"])
    assert e.value.code == 2
    assert "transformer.some_new_module.weight" in capsys.readouterr().out


def test_mirror_golden_holds_the_port_to_the_mirror():
    arch, params = _tiny_dit(3)
    assert tparity.run_mirror_golden(params, tdit.DiTStatics(arch, "cpu"), "DiT", n=64,
                                     nfe=3, atol=1e-4, rtol=1e-4) == 0


# ---------------------------------------------------------------------------
# the TF32 hold
# ---------------------------------------------------------------------------

@pytest.fixture
def tf32_on():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("vocoder", ["vocos", "bigvgan"])
def test_vocoder_convolutions_see_tf32_off(vocoder, tf32_on, monkeypatch):
    seen = []
    for name in ("conv1d", "conv_transpose1d"):
        real = getattr(F, name)

        def spy(*args, _real=real, **kwargs):
            seen.append(_flags())
            return _real(*args, **kwargs)

        monkeypatch.setattr(F, name, spy)
    if vocoder == "vocos":
        voc = Vocos(init_vocos(torch.Generator().manual_seed(0), VocosConfig(**SMALL_VOCOS)),
                    VocosConfig(**SMALL_VOCOS), device="cpu")
    else:
        cfg = BigVGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                            upsample_initial_channel=32)
        voc = BigVGAN(init_bigvgan(torch.Generator().manual_seed(0), cfg), cfg, device="cpu")
    wav = voc(torch.randn(1, 100, 16))
    assert torch.isfinite(wav).all() and seen
    assert set(seen) == {(False, False)}
    assert _flags() == (True, True)  # the caller's flags again


def test_full_f32_nests_and_restores(tf32_on):
    with precision.full_f32():
        assert _flags() == (False, False)
        with precision.full_f32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    torch.backends.cudnn.allow_tf32 = False  # a caller's own setting survives too
    with precision.full_f32():
        pass
    assert _flags() == (False, True)


def test_full_f32_holds_a_second_thread_until_the_first_leaves(tf32_on):
    inside, release, order = threading.Event(), threading.Event(), []

    def first():
        with precision.full_f32():
            order.append("first in")
            inside.set()
            release.wait(10)
            order.append("first out")

    def second():
        inside.wait(10)
        with precision.full_f32():
            order.append(("second in", _flags()))

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    inside.wait(10)
    time.sleep(0.05)
    assert order == ["first in"]  # the second waits on the lock
    release.set()
    for t in threads:
        t.join(10)
    assert order == ["first in", "first out", ("second in", (False, False))]
    assert _flags() == (True, True)


# ---------------------------------------------------------------------------
# the operators' call cost
# ---------------------------------------------------------------------------

def test_op_call_cost_three_ways_agree_on_the_cpu():
    from f5tts_tpu_torch.scripts import op_call_cost

    costs = op_call_cost.call_costs(torch.device("cpu"), iters=2, rounds=1, b=1, n=16, dim=64,
                                    heads=2)
    assert set(costs) == set(op_call_cost.NAMES)
    for ways in costs.values():
        assert set(ways) == {"direct", "operator", "custom_op"}
        assert all(v["wall_us"] >= v["host_us"] > 0 for v in ways.values())
