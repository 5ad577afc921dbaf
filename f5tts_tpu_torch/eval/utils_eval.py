"""Evaluation utilities: test-set metainfo, bucketed prompt batches, WER and
SIM (counterpart of f5tts_tpu/eval/utils_eval.py; the reference's
src/f5_tts/eval/utils_eval.py).

- `get_seedtts_testset_metainfo` ("utt|prompt_text|prompt_wav|gt_text
  [|gt_wav]") and `get_librispeech_test_clean_metainfo` (the tab-separated
  cross-sentence .lst);
- `get_inference_prompt`: a duration estimate a prompt from the byte ratio
  of its texts, 200 duration buckets over [3 s, 40 s], a batch flushed when
  its bucket holds `infer_batch_size` prompts, the batch order shuffled by
  `random.Random(seed)`; mels by the numpy `NumpyMel`, as the JAX package
  computes them;
- `normalize_for_wer` / `compute_wer`: the reference's jiwer pipeline
  (punctuation removed, en lowercased, zh scored a character at a time)
  with a word-level edit distance, so WER needs no jiwer;
- `run_asr_wer` (funasr for zh, faster-whisper for en, imported when
  called; without them it raises) and `run_asr_wer_pooled`;
- `run_sim`: the cosine of WavLM-large + ECAPA-TDNN speaker embeddings at
  16 kHz (`eval/ecapa_tdnn.py`, the port's own WavLM), on the card unless
  `device` names another.
"""

from __future__ import annotations

import os
import random
import string

import numpy as np

from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.train.dataset import NumpyMel


def get_seedtts_testset_metainfo(metalst: str) -> list[tuple]:
    """(utt, prompt_text, prompt_wav, gt_text, gt_wav) a line; relative
    paths are taken from the list's directory, a missing gt_wav is
    wavs/<utt>.wav there."""
    metainfo = []
    with open(metalst, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) == 5:
                utt, prompt_text, prompt_wav, gt_text, gt_wav = parts
            elif len(parts) == 4:
                utt, prompt_text, prompt_wav, gt_text = parts
                gt_wav = os.path.join(os.path.dirname(metalst), "wavs", utt + ".wav")
            else:
                continue
            if not os.path.isabs(prompt_wav):
                prompt_wav = os.path.join(os.path.dirname(metalst), prompt_wav)
            metainfo.append((utt, prompt_text, prompt_wav, gt_text, gt_wav))
    return metainfo


def get_librispeech_test_clean_metainfo(metalst: str, librispeech_path: str) -> list[tuple]:
    """(gen_utt, ref_text, ref_flac, " " + gen_text, gen_flac) a line of the
    LibriSpeech-PC cross-sentence list."""
    metainfo = []
    with open(metalst, encoding="utf-8") as f:
        for line in f:
            ref_utt, _ref_dur, ref_txt, gen_utt, _gen_dur, gen_txt = line.strip().split("\t")
            ref_spk, ref_chap, _ = ref_utt.split("-")
            ref_wav = os.path.join(librispeech_path, ref_spk, ref_chap, ref_utt + ".flac")
            gen_spk, gen_chap, _ = gen_utt.split("-")
            gen_wav = os.path.join(librispeech_path, gen_spk, gen_chap, gen_utt + ".flac")
            metainfo.append((gen_utt, ref_txt, ref_wav, " " + gen_txt, gen_wav))
    return metainfo


def get_inference_prompt(metainfo: list[tuple], speed: float = 1.0, tokenizer: str = "pinyin",
                         mel_cfg: MelConfig = MelConfig(), target_rms: float = 0.1,
                         use_truth_duration: bool = False, infer_batch_size: int = 1,
                         num_buckets: int = 200, min_secs: float = 3.0, max_secs: float = 40.0,
                         seed: int = 666) -> list[dict]:
    """Prompts grouped by estimated total duration: a bucket's prompts are
    flushed as one batch when it holds `infer_batch_size` of them, the rest
    at the end; the batch order is shuffled with `random.Random(seed)`.
    A batch: utts, ref_rms [b], ref_mels [b, t, n_mels] (zero-padded),
    ref_mel_lens [b], total_mel_lens [b], texts (token lists)."""
    sr, hop = mel_cfg.target_sample_rate, mel_cfg.hop_length
    min_tokens = int(min_secs * sr) // hop
    max_tokens = int(max_secs * sr) // hop
    tokens_per_bucket = (max_tokens - min_tokens) / num_buckets

    mel_fn = NumpyMel(mel_cfg)
    keys = ("utts", "ref_rms", "ref_mels", "ref_mel_lens", "total_mel_lens", "texts")
    buckets = [{k: [] for k in keys} for _ in range(num_buckets)]
    batches: list[dict] = []

    def flush(bk):
        if not bk["utts"]:
            return
        max_len = max(m.shape[0] for m in bk["ref_mels"])
        mels = np.zeros((len(bk["ref_mels"]), max_len, mel_cfg.n_mel_channels), np.float32)
        for i, mm in enumerate(bk["ref_mels"]):
            mels[i, : mm.shape[0]] = mm
        batches.append({
            "utts": list(bk["utts"]),
            "ref_rms": np.asarray(bk["ref_rms"], np.float32),
            "ref_mels": mels,
            "ref_mel_lens": np.asarray(bk["ref_mel_lens"], np.int32),
            "total_mel_lens": np.asarray(bk["total_mel_lens"], np.int32),
            "texts": list(bk["texts"]),
        })
        for v in bk.values():
            v.clear()

    for utt, prompt_text, prompt_wav, gt_text, gt_wav in metainfo:
        wav, sr_in = audio_io.read_wav(prompt_wav)
        ref_rms = audio_io.rms(wav)
        if 0 < ref_rms < target_rms:
            wav = wav * (target_rms / ref_rms)
        wav = audio_io.resample(wav, sr_in, sr)

        if len(prompt_text[-1].encode("utf-8")) == 1:
            prompt_text = prompt_text + " "
        text = prompt_text + gt_text
        text_tokens = convert_char_to_pinyin([text])[0] if tokenizer == "pinyin" else list(text)

        ref_mel = mel_fn(wav)
        ref_mel_len = ref_mel.shape[0]
        if use_truth_duration:
            gt_wav_data, gt_sr = audio_io.read_wav(gt_wav)
            total_mel_len = ref_mel_len + int(len(gt_wav_data) / gt_sr * sr / hop / speed)
        else:
            ref_bytes = len(prompt_text.encode("utf-8"))
            gen_bytes = len(gt_text.encode("utf-8"))
            total_mel_len = ref_mel_len + int(ref_mel_len / max(ref_bytes, 1) * gen_bytes / speed)

        bucket = max(0, min(num_buckets - 1,
                            int((total_mel_len - min_tokens) / max(tokens_per_bucket, 1e-9))))
        bk = buckets[bucket]
        for k, v in zip(keys, (utt, ref_rms, ref_mel, ref_mel_len, total_mel_len, text_tokens)):
            bk[k].append(v)
        if len(bk["utts"]) >= infer_batch_size:
            flush(bk)

    for bk in buckets:
        flush(bk)
    random.Random(seed).shuffle(batches)
    return batches


# zhon.hanzi.punctuation (the CJK / fullwidth set the reference unions with
# string.punctuation), carried as data so no zhon is needed
_ZH_PUNCT = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､　"
    "、〃〈〉《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏﹑﹔"
    "·！？｡。"
)
_PUNCT = _ZH_PUNCT + string.punctuation


def normalize_for_wer(text: str, lang: str = "en") -> list[str]:
    """The tokens jiwer would align after the reference's normalisation:
    every punctuation character removed ("don't" -> "dont",
    "state-of-the-art" -> "stateoftheart"), one "  " -> " " pass, zh split
    a character at a time with its case kept, en lowercased."""
    for ch in _PUNCT:
        text = text.replace(ch, "")
    text = text.replace("  ", " ")
    if lang == "zh":
        text = " ".join(text)
    elif lang == "en":
        text = text.lower()
    return text.split()


def _edit_distance(ref: list[str], hyp: list[str]) -> int:
    dp = list(range(len(hyp) + 1))
    for i in range(1, len(ref) + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, len(hyp) + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (0 if ref[i - 1] == hyp[j - 1] else 1))
            prev = cur
    return dp[-1]


def compute_wer(truth: str, hypothesis: str, lang: str = "en") -> float:
    """(substitutions + deletions + insertions) / reference words; may
    exceed 1."""
    ref = normalize_for_wer(truth, lang)
    hyp = normalize_for_wer(hypothesis, lang)
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def run_asr_wer(lang: str, wav_truth_pairs: list[tuple], device=None,
                asr_fn=None) -> list[dict]:
    """Transcribe each generated wav and score its WER: zh through funasr's
    paraformer-zh, en through faster-whisper large-v3 on `device` (the card
    when None) (the reference's protocol), each imported here; without it
    this raises RuntimeError. `asr_fn` (path -> transcript) takes the
    backend's place."""
    asr = asr_fn
    if asr is not None:
        pass
    elif lang == "zh":
        try:
            from funasr import AutoModel
        except ImportError as e:
            raise RuntimeError("funasr is required for zh WER (reference protocol)") from e
        model = AutoModel(model="paraformer-zh", disable_update=True)

        def asr(path):
            return model.generate(input=path)[0]["text"]
    elif lang == "en":
        try:
            from faster_whisper import WhisperModel
        except ImportError as e:
            raise RuntimeError("faster-whisper is required for en WER (reference protocol)") from e
        model = WhisperModel("large-v3", device=str(device or "cuda"), compute_type="float16")

        def asr(path):
            segments, _ = model.transcribe(path, beam_size=5, language="en")
            return " ".join(s.text for s in segments)
    else:
        raise ValueError(lang)

    results = []
    for wav_path, truth in wav_truth_pairs:
        hypo = asr(wav_path)
        results.append({"wav": wav_path, "truth": truth, "hypo": hypo,
                        "wer": compute_wer(truth, hypo, lang)})
    return results


def _asr_wer_worker(args):
    lang, chunk, device = args
    return run_asr_wer(lang, chunk, device)


def run_asr_wer_pooled(lang: str, wav_truth_pairs: list[tuple], n_procs: int | None = None,
                       device=None) -> list[dict]:
    """`run_asr_wer` fanned out over `n_procs` spawned processes (one ASR
    model each; default the host's cores less one, at most 8)."""
    import multiprocessing as mp

    n = n_procs or max(1, min((os.cpu_count() or 2) - 1, 8))
    if n <= 1 or len(wav_truth_pairs) < 2:
        return run_asr_wer(lang, wav_truth_pairs, device)
    chunks = [c for c in (wav_truth_pairs[i::n] for i in range(n)) if c]
    with mp.get_context("spawn").Pool(len(chunks)) as pool:
        parts = pool.map(_asr_wer_worker, [(lang, c, device) for c in chunks])
    return [r for part in parts for r in part]


def run_sim(wav_pairs: list[tuple], ckpt_path: str, device=None) -> list[dict]:
    """Speaker similarity of each (generated, reference) wav pair: the
    cosine of their ECAPA-TDNN embeddings over WavLM-large at 16 kHz, f32,
    on `device` (the card when None). The checkpoint
    (`wavlm_large_finetune.pth`, the UniSpeech layout) is loaded with strict
    accounting: below 99% of its tensors consumed it raises, so SIM never
    scores with random weights."""
    import torch

    from f5tts_tpu_torch.eval.ecapa_tdnn import ECAPA_TDNN_SMALL, load_reference_checkpoint
    from f5tts_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    model = ECAPA_TDNN_SMALL(feat_dim=1024, feat_type="wavlm_large")
    load_reference_checkpoint(model, ckpt_path)
    model = model.to(dev).eval()

    results = []
    with torch.no_grad():
        for gen_path, gt_path in wav_pairs:
            emb = []
            for p in (gen_path, gt_path):
                wav, sr = audio_io.read_wav(p)
                wav = audio_io.resample(wav, sr, 16000)
                e = model(torch.from_numpy(wav)[None].to(dev))
                emb.append(torch.nn.functional.normalize(e, dim=-1))
            sim = float((emb[0] * emb[1]).sum())
            results.append({"gen": gen_path, "gt": gt_path, "sim": sim})
    return results
