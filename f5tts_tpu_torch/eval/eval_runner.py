"""The WER / SIM test-set scorers' runner (counterpart of
f5tts_tpu/eval/eval_runner.py; the reference's eval_seedtts_testset.py and
eval_librispeech_test_clean.py).

Builds (generated wav, reference wav, truth text) triples for the
utterances on disk, shards them over worker processes, scores each shard
with `utils_eval.run_asr_wer` or `run_sim` on the `device` given (the card
when None), and writes `_{task}_results.jsonl` with a mean line into the
generated wavs' directory. The pool takes the spawn context: a forked
child cannot use CUDA.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os

import numpy as np

from f5tts_tpu_torch.eval import utils_eval


def build_seedtts_test_set(metalst: str, gen_wav_dir: str) -> list[tuple]:
    """(gen_wav, prompt_wav, gt_text) for each utterance with a generated wav."""
    triples = []
    for utt, _prompt_text, prompt_wav, gt_text, _gt_wav in (
            utils_eval.get_seedtts_testset_metainfo(metalst)):
        gen_wav = os.path.join(gen_wav_dir, utt + ".wav")
        if os.path.exists(gen_wav):
            triples.append((gen_wav, prompt_wav, gt_text))
    return triples


def build_librispeech_test_set(metalst: str, gen_wav_dir: str, librispeech_path: str,
                               eval_ground_truth: bool = False) -> list[tuple]:
    """(gen_wav, ref_flac, gen_text) a line; the real target utterance with
    `eval_ground_truth`; a missing generated wav raises."""
    triples = []
    for gen_utt, _ref_txt, ref_wav, gen_txt, gt_wav in (
            utils_eval.get_librispeech_test_clean_metainfo(metalst, librispeech_path)):
        if eval_ground_truth:
            gen_wav = gt_wav
        else:
            gen_wav = os.path.join(gen_wav_dir, gen_utt + ".wav")
            if not os.path.exists(gen_wav):
                raise FileNotFoundError(f"Generated wav not found: {gen_utt}")
        triples.append((gen_wav, ref_wav, gen_txt.strip()))
    return triples


def _wer_job(args):
    lang, shard, device = args
    return utils_eval.run_asr_wer(lang, [(g, t) for g, _r, t in shard], device=device)


def _sim_job(args):
    shard, ckpt, device = args
    return utils_eval.run_sim([(g, r) for g, r, _t in shard], ckpt, device=device)


def _shard(items: list, n: int) -> list[list]:
    per = len(items) // n + 1
    return [items[i * per: (i + 1) * per] for i in range(n) if items[i * per: (i + 1) * per]]


def score_test_set(eval_task: str, triples: list[tuple], gen_wav_dir: str, lang: str = "en",
                   workers: int = 1, device=None, sim_ckpt: str = "") -> float:
    """Score `triples` ("wer" or "sim") over `workers` processes, write
    `{gen_wav_dir}/_{task}_results.jsonl` and return the mean (5 places)."""
    shards = _shard(triples, max(workers, 1))
    if eval_task == "wer":
        jobs = [(lang, s, device) for s in shards]
        fn = _wer_job
    elif eval_task == "sim":
        jobs = [(s, sim_ckpt, device) for s in shards]
        fn = _sim_job
    else:
        raise ValueError(f"Unknown eval task: {eval_task}")

    if len(jobs) <= 1:
        results = [fn(j) for j in jobs]
    else:
        with mp.get_context("spawn").Pool(processes=len(jobs)) as pool:
            results = pool.map(fn, jobs)

    full = [r for shard_result in results for r in shard_result]
    values = [r[eval_task] for r in full]
    mean = round(float(np.mean(values)), 5) if values else float("nan")

    result_path = os.path.join(gen_wav_dir, f"_{eval_task}_results.jsonl")
    with open(result_path, "w", encoding="utf-8") as f:
        for line in full:
            f.write(json.dumps(line, ensure_ascii=False) + "\n")
        f.write(f"\n{eval_task.upper()}: {mean}\n")

    print(f"\nTotal {len(values)} samples")
    print(f"{eval_task.upper()}: {mean}")
    print(f"{eval_task.upper()} results saved to {result_path}")
    return mean
