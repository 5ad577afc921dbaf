"""Seeded models, requests, training text, the scorers' seeded weights and
trace helpers shared by chip_smoke.py, the profiling scripts and tests.

Any preset of `config.PRESETS` (text_num_embeds 2545, as the JAX package's
bench.py; other arch fields may be overridden, e.g. qk_norm) and Vocos or
BigVGAN with random weights from fixed seeds; the zero-initialised AdaLN, norm_out,
proj_out and GRN leaves are randomised so the backbone is no identity (the
UNetT has none), and so are qk-norm's RMSNorm weights (1 + 0.1 N(0, 1)). No
checkpoint is read.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from f5tts_tpu_torch.config import PRESETS, ModelArch
from f5tts_tpu_torch.models import dit
from f5tts_tpu_torch.models.cfm import BACKBONES
from f5tts_tpu_torch.vocoder.bigvgan import BigVGANConfig, init_bigvgan
from f5tts_tpu_torch.vocoder.vocos import VocosConfig, init_vocos

REF_TEXT = "Some call me nature, others call me mother nature."
REQUESTS = [
    "I have been here for billions of years, and I will be here long after you are gone.",
    ("The river keeps its course through the valley, carrying the snow of the mountains down "
     "to the sea, while the forests grow slowly on either bank."),
    "Every morning the light returns, and the birds begin again.",
]
# char vocabulary: space (index 0) and printable ASCII
VOCAB = {c: i for i, c in enumerate(" " + "".join(chr(i) for i in range(33, 127)))}
# MMDiT's synthetic training text: one id per 6 mel frames (~16 ids a second
# at 93.75 frames a second, about Emilia's rate), so the text stream's share
# of the joint sequence is a real one
MMDIT_FRAMES_PER_ID = 6


def synthetic_text_ids(rng, lens, model: str, width: int = 256) -> np.ndarray:
    """[b, nt] int32 ids in [1, 2545) for training rows of `lens` frames:
    MMDiT_Base rows carry ceil(len / MMDIT_FRAMES_PER_ID) ids, -1 padded;
    the other models `width` ids a row, as the JAX train_bench draws them."""
    if PRESETS[model].backbone != "MMDiT":
        return rng.integers(1, 2545, (len(lens), width)).astype(np.int32)
    counts = [-(-int(t) // MMDIT_FRAMES_PER_ID) for t in lens]
    ids = np.full((len(lens), max(counts)), -1, np.int32)
    for i, c in enumerate(counts):
        ids[i, :c] = rng.integers(1, 2545, c)
    return ids


QK_NORM_LEAVES = ("q_norm", "k_norm", "c_q_norm", "c_k_norm")


def base_models(seed: int = 0, model: str = "F5TTS_v1_Base", vocoder: str = "vocos",
                **arch_overrides) -> tuple[ModelArch, dict, dict]:
    """(arch, backbone params, vocoder params) of the preset `model` with
    `arch_overrides` (e.g. qk_norm="rms_norm", depth=2), f32 on the CPU; its
    backbone is `PRESETS[model].backbone`. `vocoder` "vocos" or "bigvgan"
    (the full-size v2 24 kHz 100-band generator, `BigVGANConfig()`)."""
    cfg = PRESETS[model]
    arch = dataclasses.replace(cfg.arch, text_num_embeds=2545, **arch_overrides)
    gen = torch.Generator().manual_seed(seed)
    params = dit.activate_zero_init(BACKBONES[cfg.backbone].init(gen, arch), gen)

    def randomise_qk_norm(tree):
        if isinstance(tree, dict):
            return {k: ({"w": 1.0 + 0.1 * torch.randn(v["w"].shape, generator=gen)}
                        if k in QK_NORM_LEAVES else randomise_qk_norm(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [randomise_qk_norm(v) for v in tree]
        return tree

    params = randomise_qk_norm(params)
    vgen = torch.Generator().manual_seed(seed + 1)
    if vocoder == "bigvgan":
        return arch, params, init_bigvgan(vgen, BigVGANConfig())
    if vocoder != "vocos":
        raise ValueError(f"unknown vocoder {vocoder!r} (vocos | bigvgan)")
    return arch, params, init_vocos(vgen, VocosConfig())


def seeded_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """Numpy-drawn f32 values for every floating tensor of `module`'s state
    dict, in its order (the integer ones as they are): matrices and conv
    kernels N(0, 1 / fan_in), 1-D weights (norms) 1 + 0.1 N(0, 1), running
    variances 1 + 0.5 |N(0, 1)|, every other vector 0.05 N(0, 1). The
    scorers' random weights (`eval/ecapa_tdnn.py`, `eval/utmos22.py`)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            out[name] = t.clone()
            continue
        z = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        if t.dim() >= 2:
            z *= np.float32(1.0 / np.sqrt(max(t[0].numel(), 1)))
        elif name.endswith("running_var"):
            z = 1.0 + 0.5 * np.abs(z)
        elif name.endswith("weight"):
            z = 1.0 + 0.1 * z
        else:
            z *= np.float32(0.05)
        out[name] = torch.from_numpy(z.astype(np.float32))
    return out


def synthetic_ref_wav(seconds: float = 2.7, sr: int = 24000) -> np.ndarray:
    """A seeded voiced-like reference: harmonics of a wobbling pitch + noise."""
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 3.0 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 8))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t) ** 2)
    wav = 0.05 * wav / np.abs(wav).max() + 0.003 * rng.standard_normal(t.shape)
    return wav.astype(np.float32)


def time_ms(fn, reps: int = 10, iters: int = 15) -> float:
    """Median device time of one fn() call: fn is captured `reps` times in one
    CUDA graph, and each replay is timed with CUDA events (no host launch
    overhead inside the window)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (device busy time)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


# K2's kernel as a trace names it: the LENGTH + MISH mode of K10's template,
# 32 output channels a block (64 with -DGC_CPE_NP=64)
K2_NAMES = ("grouped_conv1d_kernel<64, 32, true>", "grouped_conv1d_kernel<64, 64, true>")


def device_time_by_class(prof, classes, top: int = 0) -> dict:
    """From a torch.profiler trace: device busy ms (union of kernel
    intervals), kernel count and {class: {ms, launches}} by the first class
    whose keys occur in the kernel's name ("other" when none does); with
    `top`, also the `top` kernel names that took the most time."""
    import torch

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class: dict[str, dict] = {}
    by_name: dict[str, dict] = {}
    for e in kernels:
        cls = next((c for c, keys in classes if any(k in e.name for k in keys)), "other")
        for table, key in ((by_class, cls), (by_name, e.name[:120])):
            c = table.setdefault(key, {"ms": 0.0, "launches": 0})
            c["ms"] += (e.time_range.end - e.time_range.start) / 1e3
            c["launches"] += 1
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3

    def ranked(table, n=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1]["ms"])[:n]
        return {k: {"ms": round(v["ms"], 4), "launches": v["launches"]} for k, v in rows}

    out = {"device_busy_ms": busy_ms, "device_kernels": len(kernels), "by_class": ranked(by_class)}
    if top:
        out["top_kernels"] = ranked(by_name, top)
    return out


def gpu_name_and_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
