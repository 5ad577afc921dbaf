"""Zero-shot inference pipeline (counterpart of f5tts_tpu/infer/pipeline.py).

(ref wav, ref text, gen text) -> waveform: resample, RMS-normalise the
reference, log-mel (the vocos or the bigvgan mel, `mel_cfg`), chunk the
text to a speech-rate budget, estimate each chunk's duration, pad to a
bucket, run `cfm_sample` (the backbone, DiT, UNetT or MMDiT, and its
kernels) and the vocoder (any callable: Vocos, BigVGAN), restore the RMS
and cross-fade the chunks. The text goes through the pinyin tokenizer by
default (`text.pinyin`, with a vocab such as `text.vocab.EMILIA_VOCAB`), as
in the JAX package; `quantization="int8"` runs the backbone's per-token
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

Serving (the counterpart of `_serve` and `generate_batch_async`):
`serve_generate` runs int16 wav -> mel of the whole panel -> cond ->
`cfm_sample` -> vocoder -> int16 as one CUDA graph per key (batch, wav
bucket, text bucket, n bucket, NFE). `generate_batch_async` pads a request
list to a power of two, prepares it on the host exactly as the JAX
pipeline does, and returns once the replay and a non-blocking copy of the
int16 panel into pinned host memory are enqueued; `finalize_batch` waits
on that copy's event and slices each request's samples. The low-TTFB path
(`chunk_text_low_ttfb`, the fine first-chunk bucket and its background
warm-up) and `infer_stream` come across as they are.

Threads: `DynamicBatcher` dispatches from one thread and finalizes from
another, and a fine-bucket warm-up captures from a third. One dispatch at a
time enqueues (fills a key's static buffers, replays, copies out); the
pipeline's `device_lock` is taken shared around every other CUDA call of
these paths (a finalize's wait, a request's reference mel) and exclusive
around a capture, so no thread makes a CUDA call while a graph is being
captured (under the default global capture mode such a call fails or
invalidates the capture).
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Generator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.config import MelConfig, SamplingConfig
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops.mel import MelFrontend
from f5tts_tpu_torch.ops.quant import quantize_dit_params
from f5tts_tpu_torch.precision import full_f32
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


def chunk_text_low_ttfb(text: str, first_chunk_chars: tuple = (12, 40, 80),
                        max_chars: int = 135) -> list[str]:
    """Low-TTFB chunking: the leading chunks take small, growing UTF-8 byte
    budgets so the first audio comes back quickly, the later ones
    `max_chars`. Packs chunk_text's sentence list directly."""
    sentences = [s for s in SENTENCE_SPLIT_RE.split(text) if s]
    budgets = iter(first_chunk_chars)
    chunks: list[str] = []
    cur, cur_budget = "", next(budgets, max_chars)
    for s in sentences:
        joiner = " " if len(s[-1].encode("utf-8")) == 1 else ""
        if cur and len(cur.encode("utf-8")) + len(s.encode("utf-8")) > cur_budget:
            chunks.append(cur.strip())
            cur, cur_budget = "", next(budgets, max_chars)
        cur += s + joiner
    if cur.strip():
        chunks.append(cur.strip())
    return [c for c in chunks if c]


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


class DeviceLock:
    """A shared / exclusive lock: `shared()` around CUDA calls that may run
    side by side, `exclusive()` around a capture. A waiting capture holds
    back new shared holders. Not reentrant: a thread never nests them."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._exclusive or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


@dataclass
class ServeHandle:
    """What `serve_generate` returns: the int16 panel [b, samples] (on a
    CUDA device a pinned host tensor the copy-out is still writing) and the
    event recorded after that copy (None on the CPU)."""

    wav: Optional[torch.Tensor]
    event: Optional[object] = None


# the serve graph's static inputs and their dtypes
SERVE_INPUTS = (("wav_i16", torch.int16), ("up_scale", torch.float32),
                ("down_scale", torch.float32), ("ref_lens", torch.int32), ("text", None),
                ("totals", torch.int32), ("t_grid", torch.float32), ("y0", torch.float32))


@dataclass
class InferencePipeline:
    """Zero-shot voice cloning on one device (the card unless `device` says
    otherwise). `backbone` names the model family (`ModelConfig.backbone`:
    "DiT", "UNetT" or "MMDiT"); `statics` carries its arch. At load the
    params are cast to `dtype` and their q/k/v projections fused, so
    attention takes the flat-QKV kernels, and with `quantization="int8"`
    the block projections are then quantized (`quantize_dit_params`), in
    the JAX package's order. `tokenizer` "pinyin" and "char" look tokens up
    in `vocab_char_map`. With `fine_autowarm` a stream's first chunk whose
    fine bucket has no finished batch yet warms it in a background thread
    (`generate_batch_async`)."""

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
    fine_autowarm: bool = False         # warm cold fine first-chunk buckets in the background

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
        # (batch, wav bucket, nt, n, nfe) -> entry of the serve graph
        self.serve_graphs: dict[tuple, GraphEntry] = {}
        self.device_lock = DeviceLock()
        self._dispatch = threading.RLock()  # one enqueue at a time
        # serving's shape tracking, as in the JAX pipeline: every (batch, wav
        # bucket, nt, n) dispatched, and those whose finalize has completed
        # (the fine first-chunk gate keys on the latter), and the fine
        # warm-ups in flight
        self.seen_serve_shapes: set = set()
        self._finalized_serve_shapes: set = set()
        self._fine_warms_inflight: set = set()

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

    def _capture(self, entry: GraphEntry, body) -> None:
        """Warm up on a side stream (cuBLAS handles, cuFFT plans, the
        kernels' attributes), then capture `body` (inputs -> (mel, wav))
        into a graph with its own memory pool, both in full f32 (the
        vocoder's convolutions, whatever the caller's TF32 flags). The
        caller holds `device_lock` exclusively."""
        with full_f32():
            t0 = time.perf_counter()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                body(entry.inputs)
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            with _build.capture_counts() as counts, torch.cuda.graph(graph):
                entry.mel, entry.wav = body(entry.inputs)
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
        values = {"cond": cond, "text": text, "lens": lens, "duration": duration,
                  "t_grid": t_grid, "y0": y0}
        dtypes = {"cond": torch.float32, "text": text.dtype, "lens": torch.int32,
                  "duration": torch.int32, "t_grid": torch.float32, "y0": torch.float32}
        specs = {name: (tuple(values[name].shape), dt) for name, dt in dtypes.items()}
        with self._enqueue(self.graphs, key, specs) as (entry, capture):
            staged = self._fill(entry, values, cfg_strength)
            if capture:
                self._capture(entry, self._body)  # raises when it fails; the key is not kept
            self.graphs[key] = entry
            if entry.graph is None:  # the CPU: the body reads the static buffers
                return self._body(entry.inputs)
            entry.graph.replay()
            entry.replays += 1
            out = entry.mel.clone(), entry.wav.clone()
            del staged
            return out

    @contextlib.contextmanager
    def _enqueue(self, graphs: dict, key: tuple, specs: dict):
        """One enqueue on the graph of `key` in `graphs`: holds the dispatch
        lock, and the device lock exclusive when the enqueue must capture (a
        CUDA device and no graph yet for the key), else shared. Yields the
        key's entry (its static inputs, `specs` {name: (shape, dtype)},
        allocated at its first use) and whether to capture."""
        with self._dispatch:
            entry = graphs.get(key)
            capture = self.device.type == "cuda" and (entry is None or entry.graph is None)
            with self.device_lock.exclusive() if capture else self.device_lock.shared():
                if entry is None:
                    entry = GraphEntry({name: torch.empty(shape, dtype=dt, device=self.device)
                                        for name, (shape, dt) in specs.items()})
                    entry.inputs["cfg_strength"] = torch.empty((), device=self.device)
                yield entry, capture

    def _fill(self, entry: GraphEntry, values: dict, cfg_strength) -> list:
        """Overwrite `entry`'s static inputs with `values` (tensors or
        arrays) and the CFG strength. On a CUDA device host values go
        through pinned memory with non-blocking copies, so a fill does not
        wait for the work before it; returns the pinned staging tensors,
        which the caller drops while it holds the device lock."""
        staged = []
        for name, value in values.items():
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
                staged.append(t)
            entry.inputs[name].copy_(t, non_blocking=True)
        entry.inputs["cfg_strength"].fill_(cfg_strength)
        return staged

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
        with self.device_lock.shared():
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
        with self.device_lock.shared():
            duration = torch.tensor([total], dtype=torch.int32, device=dev)
            y0 = cfm.make_noise(torch.Generator(device=dev).manual_seed(seed), 1, n_bucket,
                                self.mel_cfg.n_mel_channels, duration, s.max_duration)
            return {"cond": torch.from_numpy(cond).to(dev),
                    "text": torch.from_numpy(text_ids).to(dev),
                    "lens": torch.tensor([ref_frames], dtype=torch.int32, device=dev),
                    "duration": duration,
                    "t_grid": make_time_grid(nfe, sway_sampling_coef=sway, use_epss=s.use_epss),
                    "y0": y0, "cfg_strength": cfg_strength, "ref_frames": ref_frames,
                    "total": total}

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
        with self.device_lock.shared():
            wave_full = wave_full.cpu().numpy()
            gen_mel = mel[0, ref_frames:total].transpose(0, 1).cpu().numpy()
            del mel, req
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

    def infer_stream(self, ref_wav: np.ndarray, ref_sr: int, ref_text: str,
                     gen_text_chunks: list[str], chunk_size: int = 2048,
                     **kw) -> Generator[tuple[np.ndarray, int], None, None]:
        """Streaming: each text chunk's wave (`generate_chunk`, keywords as
        there) in pieces of `chunk_size` samples, with the sample rate."""
        ref_wav = audio_io.resample(ref_wav, ref_sr, self.sr)
        for gen_text in gen_text_chunks:
            wave, _ = self.generate_chunk(ref_wav, ref_text, gen_text, **kw)
            for j in range(0, len(wave), chunk_size):
                yield wave[j: j + chunk_size], self.sr

    # -- serving: the one-dispatch batch ----------------------------------------

    def _serve_body(self, inp: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """int16 panel -> (mel [b, n, d], int16 wav [b, samples]): the mel of
        the whole shared panel at each row's RMS scale, padded or cut to the
        n bucket, cond zeroed from each row's reference length on, the
        sampler, the vocoder, the RMS restored, clipped to +-32767 and
        truncated toward zero (XLA's convert)."""
        wav = inp["wav_i16"].float() / 32767.0 * inp["up_scale"][:, None]
        mel = self.mel.frames_to_mel_bnd(wav)
        n = inp["y0"].shape[1]
        mel = F.pad(mel, (0, 0, 0, n - mel.shape[1])) if mel.shape[1] < n else mel[:, :n]
        row = torch.arange(n, device=mel.device)[None, :]
        cond = torch.where((row < inp["ref_lens"][:, None])[:, :, None], mel, 0.0)
        out = cfm.cfm_sample(self.params, self.statics, cond, inp["text"], inp["ref_lens"],
                             inp["totals"], inp["t_grid"], y0=inp["y0"],
                             cfg_strength=inp["cfg_strength"], dtype=self.dtype,
                             backbone=self.bdef)
        waves = self.vocoder(out.transpose(1, 2)) * inp["down_scale"][:, None]
        return out, torch.clamp(waves * 32767.0, -32767, 32767).to(torch.int16)

    def serve_generate(self, wav_i16, up_scale, down_scale, ref_lens, text, totals,
                       t_grid, cfg_strength: float, n_bucket: int, y0=None,
                       seed: int = 0) -> ServeHandle:
        """The serve body on these inputs (arrays or tensors: wav_i16 [b,
        wav bucket] int16, up / down scales [b] f32, ref_lens [b], text ids
        [b, nt], totals [b] already <= n_bucket, t_grid [nfe+1]). The noise
        is `y0` [b, n_bucket, d] when given, else one panel from
        `torch.Generator(device).manual_seed(seed)` as `cfm.make_noise` draws
        it, written into the static y0 outside the graph. On a CUDA device one
        replay of the graph of key (b, wav bucket, nt, n_bucket, nfe), its
        int16 output copied without blocking into pinned host memory; the
        handle's event follows that copy."""
        b, wav_bucket = wav_i16.shape
        nt, nfe, d = text.shape[1], t_grid.shape[0] - 1, self.mel_cfg.n_mel_channels
        key = (b, wav_bucket, nt, n_bucket, nfe)
        values = {"wav_i16": wav_i16, "up_scale": up_scale, "down_scale": down_scale,
                  "ref_lens": ref_lens, "text": text, "totals": totals, "t_grid": t_grid}
        if y0 is not None:
            values["y0"] = y0
        text_dtype = (text.dtype if isinstance(text, torch.Tensor)
                      else torch.from_numpy(np.asarray(text[:0])).dtype)
        shapes = {name: tuple(v.shape) for name, v in values.items()}
        shapes["y0"] = (b, n_bucket, d)
        specs = {name: (shapes[name], dt or text_dtype) for name, dt in SERVE_INPUTS}
        with self._enqueue(self.serve_graphs, key, specs) as (entry, capture):
            staged = self._fill(entry, values, cfg_strength)
            if y0 is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                entry.inputs["y0"].copy_(cfm.make_noise(gen, b, n_bucket, d, entry.inputs["totals"],
                                                        self.sampling.max_duration))
            if capture:
                self._capture(entry, self._serve_body)  # raises when it fails; the key is not kept
            self.serve_graphs[key] = entry
            if entry.graph is None:  # the CPU: the body reads the static buffers
                return ServeHandle(self._serve_body(entry.inputs)[1])
            entry.graph.replay()
            entry.replays += 1
            host = torch.empty(tuple(entry.wav.shape), dtype=torch.int16, pin_memory=True)
            host.copy_(entry.wav, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            del staged
            return ServeHandle(host, event)

    def generate_batch(self, requests: list[dict], seed: int = 0,
                       nfe_step: Optional[int] = None, cfg_strength: Optional[float] = None,
                       sway_sampling_coef="default",
                       bucket_size: Optional[int] = None) -> list[np.ndarray]:
        """Batched generation: dispatch, then wait for the results."""
        return self.finalize_batch(self.generate_batch_async(
            requests, seed, nfe_step, cfg_strength, sway_sampling_coef,
            bucket_size=bucket_size))

    def generate_batch_async(self, requests: list[dict], seed: int = 0,
                             nfe_step: Optional[int] = None,
                             cfg_strength: Optional[float] = None,
                             sway_sampling_coef="default",
                             bucket_size: Optional[int] = None):
        """The serving hot path. `requests`: [{"ref_wav": [n] f32 at the
        pipeline's rate, "ref_text", "gen_text", optional "speed",
        "fix_duration", "fine_bucket"}]. The list is padded to the next power
        of two by repeating its last request (padded rows are dropped in
        `finalize_batch`), each row gets its RMS up / down scale, the
        references go into one int16 panel at a shared 128-frame bucket, the
        texts into one id panel at a 64-id bucket; durations come from the
        true token counts, and the n bucket from the longest
        (`bucket_size` overrides the pipeline's). When every real request
        asks for "fine_bucket" (a stream's first chunk), the batch takes the
        half-granularity bucket, max(bucket_size / 2, 128), but only if that
        shape has finished a batch before; else, with `fine_autowarm`, a
        background thread warms it (one `generate_batch` at the fine bucket
        and this request's NFE). Returns (handle, (ref_lens, totals,
        n_bucket, shape_is_cold, shape_key)) once the work is enqueued; cold
        means no graph was captured for the key (on the CPU: the key is
        new)."""
        s = self.sampling
        nfe = s.nfe_steps if nfe_step is None else nfe_step
        cfg_v = s.cfg_strength if cfg_strength is None else cfg_strength
        sway = s.sway_sampling_coef if sway_sampling_coef == "default" else sway_sampling_coef

        n_real = len(requests)
        b = 1 << (n_real - 1).bit_length() if n_real > 1 else 1
        requests = list(requests) + [requests[-1]] * (b - n_real)
        ref_lens, totals, texts, wav_lens = [], [], [], []
        up_scale = np.ones((b,), np.float32)
        down_scale = np.ones((b,), np.float32)
        for i, r in enumerate(requests):
            wav = r["ref_wav"]
            rms_v = audio_io.rms(wav)
            if 0 < rms_v < s.target_rms:
                up_scale[i] = s.target_rms / rms_v
                down_scale[i] = rms_v / s.target_rms
            wav_lens.append(len(wav))
            t = self.mel_cfg.frames_for_samples(len(wav))
            ref_lens.append(t)
            totals.append(estimate_duration_frames(
                t, r["ref_text"], r["gen_text"], r.get("speed") or s.speed,
                r.get("fix_duration"), self.sr, self.hop))
            texts.append(r["ref_text"] + r["gen_text"])

        unit = 128 * self.hop
        wav_bucket = max(((max(wav_lens) + unit - 1) // unit) * unit, unit)
        wav_i16 = np.zeros((b, wav_bucket), np.int16)
        for i, r in enumerate(requests):
            w = np.clip(r["ref_wav"], -1.0, 1.0)
            wav_i16[i, :wav_lens[i]] = (w * 32767.0).astype(np.int16)

        text_ids = self.tokenize(texts)
        text_lens = (text_ids != -1).sum(axis=1)
        totals = cfm.compute_duration(torch.from_numpy(text_lens), torch.tensor(ref_lens),
                                      torch.tensor(totals), s.max_duration).numpy().astype(np.int32)
        bs = bucket_size or self.bucket_size
        n_bucket = duration_bucket(int(totals.max()), bs, s.max_duration,
                                   self.bdef.seq_extra_tokens)
        text_width = int(text_ids.shape[1])

        if bucket_size is None and all(r.get("fine_bucket") for r in requests[:n_real]):
            fine_bs = max(bs // 2, 128)
            n_fine = duration_bucket(int(totals.max()), fine_bs, s.max_duration,
                                     self.bdef.seq_extra_tokens)
            fine_key = (b, wav_bucket, text_width, int(n_fine))
            if n_fine < n_bucket:
                if fine_key in self._finalized_serve_shapes:
                    n_bucket = n_fine
                elif self.fine_autowarm and fine_key not in self._fine_warms_inflight:
                    self._fine_warms_inflight.add(fine_key)
                    warm_reqs = [dict(r) for r in requests[:n_real]]

                    def _warm():
                        # a finished generate_batch puts the fine shape into
                        # _finalized_serve_shapes, which opens the gate; a
                        # failed one can be retried
                        try:
                            self.generate_batch(warm_reqs, nfe_step=nfe, bucket_size=fine_bs)
                        except Exception:
                            pass
                        finally:
                            self._fine_warms_inflight.discard(fine_key)

                    threading.Thread(target=_warm, daemon=True).start()

        shape_key = (b, wav_bucket, text_width, int(n_bucket))
        if self.device.type == "cuda":
            shape_is_cold = shape_key + (nfe,) not in self.serve_graphs
        else:
            shape_is_cold = shape_key not in self.seen_serve_shapes
        self.seen_serve_shapes.add(shape_key)
        t_grid = make_time_grid(nfe, sway_sampling_coef=sway, use_epss=s.use_epss)
        handle = self.serve_generate(wav_i16, up_scale, down_scale, np.asarray(ref_lens, np.int32),
                                     text_ids, np.minimum(totals, n_bucket), t_grid, cfg_v,
                                     n_bucket, seed=seed)
        return handle, (ref_lens[:n_real], totals[:n_real], n_bucket, shape_is_cold, shape_key)

    def finalize_batch(self, pending) -> list[np.ndarray]:
        """Wait for a `generate_batch_async` dispatch and slice each real
        request's samples, [ref_len * hop, min(total, n_bucket) * hop), as f32
        in [-1, 1]. The shape then counts as warm for the fine gate."""
        handle, meta = pending
        ref_lens, totals, n_bucket = meta[:3]
        with self.device_lock.shared():
            if handle.event is not None:
                handle.event.synchronize()
            waves_all = handle.wav.numpy()
            if len(meta) > 4:
                self._finalized_serve_shapes.add(meta[4])
            results = []
            for i in range(len(ref_lens)):
                lo = ref_lens[i] * self.hop
                hi = min(min(int(totals[i]), n_bucket) * self.hop, waves_all.shape[1])
                results.append(waves_all[i, lo:hi].astype(np.float32) / 32767.0)
            del waves_all
            handle.wav = handle.event = None  # the pinned buffer and event go under the lock
        return results
