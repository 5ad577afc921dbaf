"""LibriSpeech test-clean cross-sentence scorer (WER / SIM), the command
line over `eval_runner` (counterpart of
f5tts_tpu/eval/eval_librispeech_test_clean.py).

Pairs each generated utterance with its reference speaker clip in the
LibriSpeech test-clean tree, scores WER (faster-whisper large-v3, which
does not ship with the port: without it this raises) or SIM (WavLM ECAPA,
`--sim_ckpt`), and writes `_{task}_results.jsonl` with the mean.
`--eval_ground_truth` scores the real target utterances instead. Runs on
the card unless `--device` names another.
"""

from __future__ import annotations

import argparse

from f5tts_tpu_torch.eval.eval_runner import build_librispeech_test_set, score_test_set


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-e", "--eval_task", default="wer", choices=["wer", "sim"])
    ap.add_argument("-g", "--gen_wav_dir", required=True)
    ap.add_argument("-m", "--metalst", required=True,
                    help="librispeech_pc_test_clean_cross_sentence.lst")
    ap.add_argument("-p", "--librispeech_test_clean_path", required=True)
    ap.add_argument("-n", "--workers", type=int, default=1)
    ap.add_argument("--eval_ground_truth", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--sim_ckpt", default="")
    args = ap.parse_args(argv)

    triples = build_librispeech_test_set(args.metalst, args.gen_wav_dir,
                                         args.librispeech_test_clean_path,
                                         eval_ground_truth=args.eval_ground_truth)
    score_test_set(args.eval_task, triples, args.gen_wav_dir, lang="en",
                   workers=args.workers, device=args.device, sim_ckpt=args.sim_ckpt)


if __name__ == "__main__":
    main()
