"""Zero-shot inference pipeline (counterpart of f5tts_tpu/infer/pipeline.py).

(ref wav, ref text, gen text) -> waveform: resample, RMS-normalise the
reference, log-mel (the vocos or the bigvgan mel, `mel_cfg`), chunk the
text to a speech-rate budget, estimate each chunk's duration, pad to a
bucket, run `cfm_sample` (the backbone, DiT, UNetT or MMDiT, and its
kernels) and the vocoder (any callable: Vocos, BigVGAN), restore the RMS
and cross-fade the chunks. Single requests only: batching, streaming and
the low-TTFB path are not ported yet. The text goes through the pinyin
tokenizer by default
(`text.pinyin`, with a vocab such as `text.vocab.EMILIA_VOCAB`), as in the
JAX package; `quantization="int8"` runs the backbone's per-token
projections as int8 W8A8 (`ops.quant`: K12, the int8 product, K13).

`fused_generate` is the counterpart of the JAX pipeline's `_fused_generate`
(sampler + vocoder under one jit, one executable per shape; Euler, as
there): on a CUDA device the sampler and the vocoder run as one CUDA graph
per key (batch, n bucket, text bucket, NFE), captured at the first request
that needs it, after one eager warm-up pass on a side stream, and replayed
from then on.
The graph reads its inputs from static buffers that every request
overwrites in full (cond, text ids, lens, duration, time grid, CFG
strength, noise) and writes mel and wav into static outputs that are
copied out before the call returns. The noise is drawn outside the graph
from the request's generator. A failed capture raises. On the CPU (the
tests) the same buffers feed the body directly.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import MelConfig, SamplingConfig
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops.mel import MelFrontend
from f5tts_tpu_torch.ops.quant import quantize_dit_params
from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.text.vocab import list_str_to_idx, list_str_to_tensor
from f5tts_tpu_torch.utils import duration_bucket, make_time_grid, resolve_device

SENTENCE_SPLIT_RE = re.compile(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])")


def chunk_text(text: str, max_chars: int = 135) -> list[str]:
    """Split on sentence punctuation, pack to a UTF-8 byte budget."""
    chunks: list[str] = []
    current = ""
    for sentence in SENTENCE_SPLIT_RE.split(text):
        if not sentence:
            continue
        joiner = " " if len(sentence[-1].encode("utf-8")) == 1 else ""
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += sentence + joiner
        else:
            if current:
                chunks.append(current.strip())
            current = sentence + joiner
    if current:
        chunks.append(current.strip())
    return chunks


def max_chars_for_ref(ref_text: str, ref_audio_secs: float, speed: float = 1.0) -> int:
    return int(len(ref_text.encode("utf-8")) / max(ref_audio_secs, 1e-6)
               * (22 - ref_audio_secs) * speed)


def estimate_duration_frames(ref_frames: int, ref_text: str, gen_text: str,
                             speed: float = 1.0, fix_duration_secs: Optional[float] = None,
                             sample_rate: int = 24000, hop: int = 256) -> int:
    if fix_duration_secs is not None:
        return int(fix_duration_secs * sample_rate / hop)
    if len(gen_text.encode("utf-8")) < 10:
        speed = 0.3
    ref_bytes = max(len(ref_text.encode("utf-8")), 1)
    gen_bytes = len(gen_text.encode("utf-8"))
    return ref_frames + int(ref_frames / ref_bytes * gen_bytes / speed)


def cross_fade(waves: list[np.ndarray], sr: int, duration: float = 0.15) -> np.ndarray:
    if not waves:
        return np.zeros(0, np.float32)
    if duration <= 0:
        return np.concatenate(waves)
    out = waves[0]
    for nxt in waves[1:]:
        n = min(int(duration * sr), len(out), len(nxt))
        if n <= 0:
            out = np.concatenate([out, nxt])
            continue
        fade_out = np.linspace(1.0, 0.0, n, dtype=np.float32)
        fade_in = np.linspace(0.0, 1.0, n, dtype=np.float32)
        out = np.concatenate([out[:-n], out[-n:] * fade_out + nxt[:n] * fade_in, nxt[n:]])
    return out


@dataclass
class GraphEntry:
    """One key's static buffers and, on a CUDA device, its captured graph:
    `counts` are the kernel launches the capture recorded (each replay
    makes them again), `pool_bytes` the device memory its pool holds."""

    inputs: dict
    graph: Optional[torch.cuda.CUDAGraph] = None
    mel: Optional[torch.Tensor] = None
    wav: Optional[torch.Tensor] = None
    counts: dict = field(default_factory=dict)
    replays: int = 0
    capture_s: float = 0.0
    pool_bytes: int = 0


@dataclass
class InferencePipeline:
    """Zero-shot voice cloning on one device (the card unless `device` says
    otherwise). `backbone` names the model family (`ModelConfig.backbone`:
    "DiT", "UNetT" or "MMDiT"); `statics` carries its arch. At load the
    params are cast to `dtype` and their q/k/v projections fused, so
    attention takes the flat-QKV kernels, and with `quantization="int8"`
    the block projections are then quantized (`quantize_dit_params`), in
    the JAX package's order. `tokenizer` "pinyin" and "char" look tokens up
    in `vocab_char_map`."""

    params: dict
    statics: object                     # the backbone's statics (its .arch is read)
    vocoder: object                     # callable mel [b, d, t] -> wav [b, n]
    vocab_char_map: Optional[dict] = None
    mel_cfg: MelConfig = field(default_factory=MelConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    tokenizer: str = "pinyin"           # "pinyin" | "char" | "byte"
    dtype: torch.dtype = torch.bfloat16
    bucket_size: int = 256
    device: Optional[object] = None
    backbone: str = "DiT"
    quantization: str = "none"          # "none" | "int8" (W8A8 block projections)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tokenizer not in ("pinyin", "char", "byte"):
            raise ValueError(f"unknown tokenizer {self.tokenizer!r} (pinyin | char | byte)")
        if self.quantization not in ("none", "int8"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
        self.mel = MelFrontend(self.mel_cfg, device=self.device)
        self.hop = self.mel_cfg.hop_length
        self.sr = self.mel_cfg.target_sample_rate
        self.bdef = cfm.BACKBONES[self.backbone]
        self.statics = self.bdef.statics_cls(self.statics.arch, self.device)
        self.params = fuse_backbone_qkv(tree_cast(self.params, self.dtype, self.device))
        if self.quantization == "int8":
            self.params = quantize_dit_params(self.params)
        self.graphs: dict[tuple, GraphEntry] = {}  # (batch, n, nt, nfe) -> entry

    def ref_mel(self, wav: np.ndarray) -> np.ndarray:
        """ref wav -> mel [t, n_mels]. The wav is zero-padded to a 128-frame
        bucket first and the frames past the clip cut off, as in the JAX
        package: len // hop + 1 frames of the vocos mel, len // hop of the
        bigvgan one."""
        true_frames = self.mel_cfg.frames_for_samples(len(wav))
        bucket = max(-(-len(wav) // (128 * self.hop)) * 128 * self.hop, 128 * self.hop)
        if bucket > len(wav):
            wav = np.pad(wav, (0, bucket - len(wav)))
        mel = self.mel.frames_to_mel_bnd(torch.from_numpy(np.asarray(wav, np.float32))[None])
        return mel[0, :true_frames].cpu().numpy()

    def tokenize(self, texts: list[str]) -> np.ndarray:
        if self.tokenizer == "pinyin":
            ids = list_str_to_idx(convert_char_to_pinyin(texts), self.vocab_char_map)
        elif self.tokenizer == "char":
            ids = list_str_to_idx(texts, self.vocab_char_map)
        else:
            ids = list_str_to_tensor(texts)
        nt = ids.shape[1]
        nt_bucket = max(((nt + 63) // 64) * 64, 64)
        return np.pad(ids, ((0, 0), (0, nt_bucket - nt)), constant_values=-1)

    # -- the one-dispatch generate ------------------------------------------

    def _body(self, inp: dict) -> tuple[torch.Tensor, torch.Tensor]:
        mel = cfm.cfm_sample(self.params, self.statics, inp["cond"], inp["text"], inp["lens"],
                             inp["duration"], inp["t_grid"], y0=inp["y0"],
                             cfg_strength=inp["cfg_strength"], dtype=self.dtype,
                             backbone=self.bdef)
        return mel, self.vocoder(mel.transpose(1, 2))

    def _capture(self, entry: GraphEntry) -> None:
        """Warm up on a side stream (cuBLAS handles, cuFFT plans, the
        kernels' attributes), then capture the body into a graph with its
        own memory pool."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body(entry.inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with _build.capture_counts() as counts, torch.cuda.graph(graph):
            entry.mel, entry.wav = self._body(entry.inputs)
        torch.cuda.synchronize(self.device)
        entry.graph, entry.counts = graph, counts
        entry.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        entry.capture_s = time.perf_counter() - t0

    def fused_generate(self, cond: torch.Tensor, text: torch.Tensor, lens: torch.Tensor,
                       duration: torch.Tensor, t_grid: torch.Tensor, y0: torch.Tensor,
                       cfg_strength: float) -> tuple[torch.Tensor, torch.Tensor]:
        """(mel [b, n, d], wav [b, (n-1)*hop]) of `cfm_sample` + the vocoder
        on these inputs (any device; y0 is the noise), on a CUDA device as
        one replay of the graph of key (b, n, nt, nfe). The results are
        copies, not the graph's buffers."""
        b, n, _ = cond.shape
        key = (b, n, text.shape[1], t_grid.shape[0] - 1)
        entry = self.graphs.get(key)
        if entry is None:
            entry = GraphEntry({
                name: torch.empty(t.shape, dtype=dt, device=self.device) for name, t, dt in (
                    ("cond", cond, torch.float32), ("text", text, text.dtype),
                    ("lens", lens, torch.int32), ("duration", duration, torch.int32),
                    ("t_grid", t_grid, torch.float32), ("y0", y0, torch.float32))})
            entry.inputs["cfg_strength"] = torch.empty((), device=self.device)
        for name, value in (("cond", cond), ("text", text), ("lens", lens),
                            ("duration", duration), ("t_grid", t_grid), ("y0", y0)):
            entry.inputs[name].copy_(value)
        entry.inputs["cfg_strength"].fill_(cfg_strength)
        if self.device.type == "cuda" and entry.graph is None:
            self._capture(entry)  # raises when the capture fails; the key is not kept
        self.graphs[key] = entry
        if entry.graph is None:  # the CPU: the body reads the static buffers
            return self._body(entry.inputs)
        entry.graph.replay()
        entry.replays += 1
        return entry.mel.clone(), entry.wav.clone()

    # -- one chunk -------------------------------------------------------------

    def prepare_chunk(self, ref_wav: np.ndarray, ref_text: str, gen_text: str,
                      seed: int = 0, speed: Optional[float] = None,
                      fix_duration: Optional[float] = None, nfe_step: Optional[int] = None,
                      cfg_strength: Optional[float] = None, sway_sampling_coef="default",
                      target_rms: Optional[float] = None) -> dict:
        """The host side of one chunk: the reference mel at the request's
        RMS, text ids, duration, bucket, time grid and the seed's noise.
        Returns `fused_generate`'s arguments under their names, and
        `ref_frames` and `total` (ints)."""
        s = self.sampling
        rms_target = s.target_rms if target_rms is None else target_rms
        speed = s.speed if speed is None else speed
        nfe = s.nfe_steps if nfe_step is None else nfe_step
        cfg_strength = s.cfg_strength if cfg_strength is None else cfg_strength
        sway = s.sway_sampling_coef if sway_sampling_coef == "default" else sway_sampling_coef

        ref_rms = audio_io.rms(ref_wav)
        if 0 < ref_rms < rms_target:
            ref_wav = ref_wav * (rms_target / ref_rms)
        ref_mel = self.ref_mel(ref_wav)
        ref_frames = ref_mel.shape[0]

        total = estimate_duration_frames(ref_frames, ref_text, gen_text, speed,
                                         fix_duration, self.sr, self.hop)
        text_ids = self.tokenize([ref_text + gen_text])
        text_lens = int((text_ids != -1).sum())
        total = int(cfm.compute_duration(torch.tensor([text_lens]), torch.tensor([ref_frames]),
                                         torch.tensor([total]), s.max_duration)[0])
        n_bucket = duration_bucket(total, self.bucket_size, s.max_duration,
                                   self.bdef.seq_extra_tokens)
        cond = np.zeros((1, n_bucket, self.mel_cfg.n_mel_channels), np.float32)
        cond[0, :ref_frames] = ref_mel

        dev = self.device
        duration = torch.tensor([total], dtype=torch.int32, device=dev)
        y0 = cfm.make_noise(torch.Generator(device=dev).manual_seed(seed), 1, n_bucket,
                            self.mel_cfg.n_mel_channels, duration, s.max_duration)
        return {"cond": torch.from_numpy(cond).to(dev), "text": torch.from_numpy(text_ids).to(dev),
                "lens": torch.tensor([ref_frames], dtype=torch.int32, device=dev),
                "duration": duration,
                "t_grid": make_time_grid(nfe, sway_sampling_coef=sway, use_epss=s.use_epss),
                "y0": y0, "cfg_strength": cfg_strength, "ref_frames": ref_frames, "total": total}

    def generate_chunk(self, ref_wav: np.ndarray, ref_text: str, gen_text: str,
                       seed: int = 0, speed: Optional[float] = None,
                       fix_duration: Optional[float] = None, nfe_step: Optional[int] = None,
                       cfg_strength: Optional[float] = None,
                       sway_sampling_coef="default",
                       target_rms: Optional[float] = None) -> tuple[np.ndarray, np.ndarray]:
        """Returns (wave [n], generated mel [d, t]) for one text chunk."""
        rms_target = self.sampling.target_rms if target_rms is None else target_rms
        req = self.prepare_chunk(ref_wav, ref_text, gen_text, seed, speed, fix_duration,
                                 nfe_step, cfg_strength, sway_sampling_coef, rms_target)
        ref_frames, total = req.pop("ref_frames"), req.pop("total")
        mel, wave_full = self.fused_generate(**req)
        wave_full = wave_full.cpu().numpy()
        gen_mel = mel[0, ref_frames:total].transpose(0, 1).cpu().numpy()
        wave = wave_full[0, ref_frames * self.hop: min(total * self.hop, wave_full.shape[1])]
        ref_rms = audio_io.rms(ref_wav)
        if 0 < ref_rms < rms_target:
            wave = wave * (ref_rms / rms_target)
        return wave.astype(np.float32), gen_mel

    def infer(self, ref_wav: np.ndarray, ref_sr: int, ref_text: str, gen_text: str,
              seed: int = 0, speed: Optional[float] = None,
              fix_duration: Optional[float] = None, nfe_step: Optional[int] = None,
              cfg_strength: Optional[float] = None, sway_sampling_coef="default",
              cross_fade_duration: Optional[float] = None,
              target_rms: Optional[float] = None) -> tuple[np.ndarray, int, np.ndarray]:
        """Full pipeline: chunk the text, generate each chunk, cross-fade.
        Returns (wave, sample_rate, mel [d, t])."""
        s = self.sampling
        xf = s.cross_fade_duration if cross_fade_duration is None else cross_fade_duration
        speed_v = s.speed if speed is None else speed
        ref_wav = audio_io.resample(ref_wav, ref_sr, self.sr)
        if not ref_text.endswith(". ") and not ref_text.endswith("。"):
            ref_text = ref_text + " " if ref_text.endswith(".") else ref_text + ". "
        if len(ref_text[-1].encode("utf-8")) == 1 and not ref_text.endswith(" "):
            ref_text = ref_text + " "
        ref_secs = len(ref_wav) / self.sr
        chunks = chunk_text(gen_text, max_chars=max(max_chars_for_ref(ref_text, ref_secs, speed_v), 16))
        if not chunks:
            return np.zeros(0, np.float32), self.sr, np.zeros((self.mel_cfg.n_mel_channels, 0))
        waves, mels = [], []
        for chunk in chunks:
            w, mspec = self.generate_chunk(
                ref_wav, ref_text, chunk, seed=seed, speed=speed, fix_duration=fix_duration,
                nfe_step=nfe_step, cfg_strength=cfg_strength,
                sway_sampling_coef=sway_sampling_coef, target_rms=target_rms)
            waves.append(w)
            mels.append(mspec)
        return cross_fade(waves, self.sr, xf), self.sr, np.concatenate(mels, axis=1)
