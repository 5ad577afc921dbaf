"""Batched test-set generation for evaluation (counterpart of
f5tts_tpu/eval/eval_infer_batch.py; the reference's
src/f5_tts/eval/eval_infer_batch.py).

`generate_batches` runs each prompt batch of `utils_eval.get_inference_prompt`
through one eager `cfm_sample` at the batch's duration bucket
(`sample_batch`: noise from a `torch.Generator` seeded with `seed` for
every batch), then the vocoder on each utterance's own frames [ref_len,
total_len), the reference's RMS restored, and writes <utt>.wav for the
WER / SIM / UTMOS scorers. On the
card the sampler launches the port's kernels (K3 / K1 / K2 for the DiT) as
`cfm_sample` does; the graphed `fused_generate` vocodes the whole bucket and
is not used here.

`main` shards the prompt list over torchrun's processes (`RANK` /
`WORLD_SIZE`); one process sees the whole list.

    python -m f5tts_tpu_torch.eval.eval_infer_batch -s 0 -n F5TTS_v1_Base \\
        --ckpt_file model_1250000.safetensors -t seedtts_test_en --metalst meta.lst
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.eval.utils_eval import (get_inference_prompt,
                                             get_librispeech_test_clean_metainfo,
                                             get_seedtts_testset_metainfo)
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.text.vocab import list_str_to_idx
from f5tts_tpu_torch.utils import duration_bucket, make_time_grid, resolve_device


def sample_batch(params: dict, statics, vocab_char_map: dict, batch: dict, nfe_step: int = 32,
                 cfg_strength: float = 2.0, sway_sampling_coef: float = -1.0, seed: int = 0,
                 mel_cfg: MelConfig = MelConfig(), dtype=torch.bfloat16, bucket_size: int = 256,
                 max_duration: int = 4096, backbone=None, device=None) -> tuple:
    """One prompt batch through `cfm_sample` at its duration bucket, the
    noise from a `torch.Generator` seeded with `seed`: (mel [b, n, d] on
    the device, n). Arguments as `generate_batches`'."""
    dev = resolve_device(device)
    bdef = backbone or cfm.DIT
    ref_mels = batch["ref_mels"]                          # [b, t, d]
    total_lens = batch["total_mel_lens"]
    n_bucket = duration_bucket(int(total_lens.max()), bucket_size, max_duration,
                               bdef.seq_extra_tokens)
    cond = np.zeros((ref_mels.shape[0], n_bucket, mel_cfg.n_mel_channels), np.float32)
    t_avail = min(ref_mels.shape[1], n_bucket)
    cond[:, :t_avail] = ref_mels[:, :t_avail]
    text_ids = list_str_to_idx(batch["texts"], vocab_char_map)
    mel = cfm.cfm_sample(
        params, statics, torch.from_numpy(cond).to(dev), torch.from_numpy(text_ids).to(dev),
        torch.from_numpy(batch["ref_mel_lens"]).to(dev),
        torch.from_numpy(np.minimum(total_lens, n_bucket).astype(np.int32)).to(dev),
        make_time_grid(nfe_step, sway_sampling_coef=sway_sampling_coef),
        generator=torch.Generator(device=dev).manual_seed(seed), cfg_strength=cfg_strength,
        dtype=dtype, backbone=bdef)
    return mel, n_bucket


def generate_batches(params: dict, statics, vocoder, vocab_char_map: dict,
                     prompt_batches: list[dict], out_dir: str, nfe_step: int = 32,
                     cfg_strength: float = 2.0, sway_sampling_coef: float = -1.0, seed: int = 0,
                     target_rms: float = 0.1, mel_cfg: MelConfig = MelConfig(),
                     dtype=torch.bfloat16, bucket_size: int = 256, max_duration: int = 4096,
                     backbone=None, device=None) -> dict:
    """Generate and write every utterance of `prompt_batches` into
    `out_dir`. `params` are the backbone's with fused QKV on `device` (the
    card when None), as `InferencePipeline.params` holds them; `backbone` a
    `cfm.BackboneDef` (the DiT when None). Returns utterances,
    audio_seconds, wall_seconds and rtf."""
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.time()
    n_utts = 0
    audio_secs = 0.0

    for batch in prompt_batches:
        out, n_bucket = sample_batch(params, statics, vocab_char_map, batch, nfe_step,
                                     cfg_strength, sway_sampling_coef, seed, mel_cfg, dtype,
                                     bucket_size, max_duration, backbone, device)
        for i, utt in enumerate(batch["utts"]):
            ref_len = int(batch["ref_mel_lens"][i])
            tot_len = min(int(batch["total_mel_lens"][i]), n_bucket)
            with torch.no_grad():
                wav = vocoder(out[i:i + 1, ref_len:tot_len].transpose(1, 2))
            wav = wav[0].float().cpu().numpy()
            rms_v = float(batch["ref_rms"][i])
            if 0 < rms_v < target_rms:
                wav = wav * (rms_v / target_rms)
            audio_io.write_wav(os.path.join(out_dir, f"{utt}.wav"), wav,
                               mel_cfg.target_sample_rate)
            n_utts += 1
            audio_secs += len(wav) / mel_cfg.target_sample_rate

    wall = time.time() - t_start
    return {"utterances": n_utts, "audio_seconds": audio_secs,
            "wall_seconds": wall, "rtf": wall / max(audio_secs, 1e-9)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("-n", "--expname", default="F5TTS_v1_Base")
    p.add_argument("-c", "--ckptstep", type=int, default=1250000)
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("-nfe", "--nfestep", type=int, default=32)
    p.add_argument("-o", "--odemethod", default="euler")
    p.add_argument("-ss", "--swaysampling", type=float, default=-1.0)
    p.add_argument("-t", "--testset", required=True,
                   choices=["seedtts_test_zh", "seedtts_test_en", "ls_pc_test_clean"])
    p.add_argument("--metalst", required=True)
    p.add_argument("--librispeech_path", default="")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--batch_frames", type=int, default=1)
    p.add_argument("--device", default=None, help="default: the card (cuda:LOCAL_RANK)")
    args = p.parse_args(argv)

    if args.testset == "ls_pc_test_clean":
        metainfo = get_librispeech_test_clean_metainfo(args.metalst, args.librispeech_path)
    else:
        metainfo = get_seedtts_testset_metainfo(args.metalst)
    # one shard a process under torchrun (the reference: split_between_processes)
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    metainfo = metainfo[rank::world]

    from f5tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.expname, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                seed=args.seed, device=args.device)
    prompts = get_inference_prompt(metainfo, tokenizer=tts.config.tokenizer,
                                   infer_batch_size=args.batch_frames)
    out_dir = os.path.join(args.output_dir, f"{args.expname}_{args.ckptstep}", args.testset,
                           f"seed{args.seed}_{args.odemethod}_nfe{args.nfestep}")
    pipe = tts.pipeline
    stats = generate_batches(
        pipe.params, pipe.statics, pipe.vocoder, pipe.vocab_char_map, prompts, out_dir,
        nfe_step=args.nfestep, sway_sampling_coef=args.swaysampling, seed=args.seed,
        dtype=pipe.dtype, bucket_size=pipe.bucket_size,
        max_duration=pipe.sampling.max_duration, backbone=pipe.bdef, device=pipe.device)
    print(stats)


if __name__ == "__main__":
    main()
