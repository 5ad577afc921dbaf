"""Seed-TTS test-set scorer (WER / speaker SIM), the command line over
`eval_runner` (counterpart of f5tts_tpu/eval/eval_seedtts_testset.py).

Scores the wavs `eval_infer_batch` wrote against the Seed-TTS meta.lst and
writes `_{task}_results.jsonl` with the mean into their directory. WER:
zh through funasr's paraformer-zh, en through faster-whisper large-v3
(neither ships with the port: without them it raises); SIM needs the
WavLM-large ECAPA checkpoint (`--sim_ckpt`). Runs on the card unless
`--device` names another.

    python -m f5tts_tpu_torch.eval.eval_seedtts_testset -e sim -l en -g results/... \\
        -m meta.lst --sim_ckpt wavlm_large_finetune.pth
"""

from __future__ import annotations

import argparse

from f5tts_tpu_torch.eval.eval_runner import build_seedtts_test_set, score_test_set


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-e", "--eval_task", default="wer", choices=["wer", "sim"])
    ap.add_argument("-l", "--lang", default="en", choices=["zh", "en"])
    ap.add_argument("-g", "--gen_wav_dir", required=True)
    ap.add_argument("-m", "--metalst", required=True, help="the Seed-TTS test set's meta.lst")
    ap.add_argument("-n", "--workers", type=int, default=1, help="scoring processes")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--sim_ckpt", default="",
                    help="WavLM-large ECAPA finetuned checkpoint (.pth) for SIM")
    args = ap.parse_args(argv)

    triples = build_seedtts_test_set(args.metalst, args.gen_wav_dir)
    score_test_set(args.eval_task, triples, args.gen_wav_dir, lang=args.lang,
                   workers=args.workers, device=args.device, sim_ckpt=args.sim_ckpt)


if __name__ == "__main__":
    main()
