"""Finetuning from a pretrained checkpoint, in full or with style-LoRA
(counterpart of f5tts_tpu/train/finetune_cli.py).

- The model is a preset (`--exp_name`) with the dataset's vocab size. A
  reference checkpoint (.pt / .pth / .safetensors / .bin) is converted with
  its own vocab (the rows of `transformer.text_embed.text_embed.weight`
  less the filler) and its text embedding grown to the new vocab, the new
  rows zero (`expand_text_embedding`, the workbench's vocab extension); a
  checkpoint directory of this package loads its EMA weights. Without
  `--pretrain` the port's own init (seed 0) is used.
- `--finetune_mode full` trains through `Trainer`; `--finetune_mode lora`
  (or `--lora`) trains rank-r adapters only (`train.lora`), with the JAX
  loop's sampler seed 666, a print every 10 updates and the adapters
  pickled as `lora_<update>.pkl` every `--save_per_updates` and at
  `--max_updates`. Tokenization follows `Trainer.tokenize`: the JAX loop
  converts pinyin token lists again (and so fails on the prep scripts'
  output); the port looks them up as they are.
- `main` parses and loads (`setup`, `load_dataset`); `finetune(args,
  params, dataset, vocab)` runs the training and needs no `datasets`.
- Runs on the card in bf16 unless `--device cpu` is given (f32).

Usage:
    python -m f5tts_tpu_torch.train.finetune_cli --exp_name F5TTS_v1_Base \
        --pretrain ckpt.safetensors --dataset_name my_dataset --finetune_mode lora
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

EXP_NAMES = ("F5TTS_v1_Base", "F5TTS_Base", "F5TTS_v1_Small", "F5TTS_Small", "E2TTS_Base",
             "E2TTS_Small")
TEXT_EMBED_KEY = "transformer.text_embed.text_embed.weight"


def expand_text_embedding(params: dict, new_vocab_size: int) -> dict:
    """Grow the text embedding to new_vocab_size + 1 rows (the filler), the
    new rows zero (reference finetune_gradio.py:974 expand_model_embeddings)."""
    emb = params["text_embed"]["embed"]["w"]
    old, need = emb.shape[0], new_vocab_size + 1
    if need <= old:
        return params
    grown = torch.cat([emb, torch.zeros((need - old, emb.shape[1]), dtype=emb.dtype,
                                        device=emb.device)], 0)
    params = dict(params)
    params["text_embed"] = dict(params["text_embed"])
    params["text_embed"]["embed"] = {"w": grown}
    return params


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--exp_name", default="F5TTS_v1_Base", choices=list(EXP_NAMES))
    p.add_argument("--pretrain", default="", help=".pt/.safetensors or a checkpoint dir")
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--tokenizer", default="pinyin", choices=["pinyin", "char", "byte", "custom"])
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--batch_size_per_gpu", type=int, default=3200)
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_warmup_updates", type=int, default=300)
    p.add_argument("--save_per_updates", type=int, default=10000)
    p.add_argument("--last_per_updates", type=int, default=5000)
    p.add_argument("--keep_last_n_checkpoints", type=int, default=-1)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--finetune_mode", default="full", choices=["full", "lora"])
    p.add_argument("--lora", action="store_true", help="shorthand for --finetune_mode lora")
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--logger", default="tensorboard")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.lora:
        args.finetune_mode = "lora"
    return args


def load_pretrained(path: str, arch, vocab_size: int, backbone: str = "DiT") -> dict:
    """The backbone params of a reference checkpoint file (its vocab grown to
    `vocab_size`) or a checkpoint directory's EMA weights, f32 on the CPU."""
    if path.endswith((".pt", ".pth", ".safetensors", ".bin")):
        from f5tts_tpu_torch.compat import convert_backbone_state_dict, load_torch_checkpoint

        sd = load_torch_checkpoint(path)
        load_arch = dataclasses.replace(arch, text_num_embeds=sd[TEXT_EMBED_KEY].shape[0] - 1)
        return expand_text_embedding(convert_backbone_state_dict(sd, load_arch, backbone),
                                     vocab_size)
    from f5tts_tpu_torch.train.checkpoint import load_params

    return load_params(path, use_ema=True)


def setup(args):
    """(vocab map, vocab size, model config, arch, backbone def, params) as
    the JAX main builds them."""
    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.text.vocab import get_tokenizer

    mcfg = PRESETS[args.exp_name]
    tok_target = args.tokenizer_path if args.tokenizer == "custom" else args.dataset_name
    vocab_char_map, vocab_size = get_tokenizer(tok_target, args.tokenizer,
                                               data_root=args.data_root)
    arch = dataclasses.replace(mcfg.arch, text_num_embeds=vocab_size)
    backbone = BACKBONES[mcfg.backbone]
    if args.pretrain:
        params = load_pretrained(args.pretrain, arch, vocab_size, mcfg.backbone)
    else:
        params = backbone.init(torch.Generator().manual_seed(0), arch)
    return vocab_char_map, vocab_size, mcfg, arch, backbone, params


def train_config(args):
    from f5tts_tpu_torch.config import TrainConfig

    return TrainConfig(
        dataset_name=args.dataset_name, batch_size_per_device=args.batch_size_per_gpu,
        max_samples=args.max_samples, epochs=args.epochs, learning_rate=args.learning_rate,
        num_warmup_updates=args.num_warmup_updates,
        grad_accumulation_steps=args.grad_accumulation_steps, max_grad_norm=args.max_grad_norm,
        save_per_updates=args.save_per_updates,
        keep_last_n_checkpoints=args.keep_last_n_checkpoints,
        last_per_updates=args.last_per_updates, save_dir=save_dir_of(args), logger=args.logger)


def save_dir_of(args) -> str:
    return args.save_dir or f"ckpts/{args.exp_name}_{args.dataset_name}"


def finetune(args, params: dict, dataset, vocab_char_map, *, device=None, vocoder=None,
             log_samples: bool = False, sample_fn=None, on_update=None) -> dict:
    """Finetune `params` on `dataset` as `args` (`parse_args`) say. Full
    mode: {"trainer", "metrics"}; LoRA mode: {"lora", "opt_state", "step",
    "metrics"}. `vocoder` with `log_samples` writes the trainer's milestone
    samples; `on_update(update, metrics)` follows each update."""
    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.utils import resolve_device

    mcfg = PRESETS[args.exp_name]
    backbone = BACKBONES[mcfg.backbone]
    vocab_size = 256 if vocab_char_map is None else len(vocab_char_map)  # get_tokenizer's
    arch = dataclasses.replace(mcfg.arch, text_num_embeds=vocab_size)
    dev = resolve_device(device if device is not None else args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if args.finetune_mode == "lora":
        return _finetune_lora(args, params, dataset, vocab_char_map, backbone, arch, dev, dtype,
                              on_update)
    from f5tts_tpu_torch.train.trainer import Trainer

    tcfg = dataclasses.replace(train_config(args), log_samples=log_samples)
    trainer = Trainer(params, backbone.statics_cls(arch), tcfg, backbone=backbone,
                      vocab_char_map=vocab_char_map, tokenizer=args.tokenizer, dtype=dtype,
                      device=dev, logger=args.logger, vocoder=vocoder, sample_fn=sample_fn)
    metrics = trainer.train(dataset, resumable_with_seed=666, max_updates=args.max_updates,
                            on_update=on_update)
    return {"trainer": trainer, "metrics": metrics}


def _finetune_lora(args, params, dataset, vocab_char_map, backbone, arch, dev, dtype,
                   on_update) -> dict:
    from f5tts_tpu_torch.models.modules import tree_cast
    from f5tts_tpu_torch.train.dataset import DynamicBatchSampler, collate
    from f5tts_tpu_torch.train.lora import (AdamWHParams, LoRAConfig, init_lora,
                                            init_lora_opt_state, make_lora_train_step, save_lora)
    from f5tts_tpu_torch.train.trainer import tokenize

    save_dir = save_dir_of(args)
    base = tree_cast(params, torch.float32, dev)
    lcfg = LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), base, lcfg)
    opt = init_lora_opt_state(lora)
    step = make_lora_train_step(base, backbone.statics_cls(arch, dev),
                                AdamWHParams(args.learning_rate, args.max_grad_norm), lcfg,
                                dtype=dtype, backbone=backbone)
    frame_lens = [dataset.get_frame_len(i) for i in range(len(dataset))]
    sampler = DynamicBatchSampler(frame_lens, args.batch_size_per_gpu, args.max_samples,
                                  random_seed=666)
    gen = torch.Generator(device=dev).manual_seed(666)
    update, metrics = 0, {}
    os.makedirs(save_dir, exist_ok=True)
    for epoch in range(args.epochs):
        sampler.set_epoch(epoch)
        for batch_idx in sampler:
            batch = collate([dataset[i] for i in batch_idx])
            ids = tokenize(batch["text"], args.tokenizer, vocab_char_map)
            lora, opt, metrics = step(lora, opt, torch.from_numpy(batch["mel"]).to(dev),
                                      torch.from_numpy(ids).to(dev),
                                      torch.from_numpy(batch["mel_lengths"]).to(dev),
                                      generator=gen)
            update += 1
            if on_update is not None:
                on_update(update, metrics)
            if update % 10 == 0:
                print(f"update {update} loss {float(metrics['loss']):.4f}")
            done = bool(args.max_updates) and update >= args.max_updates
            if update % args.save_per_updates == 0 or done:
                save_lora(lora, os.path.join(save_dir, f"lora_{update}.pkl"))
            if done:
                print("done (lora):", update)
                return {"lora": lora, "opt_state": opt, "step": step, "metrics": metrics}
    print("done (lora):", update)
    return {"lora": lora, "opt_state": opt, "step": step, "metrics": metrics}


def main(argv=None) -> dict:
    from f5tts_tpu_torch.train.dataset import load_dataset

    args = parse_args(argv)
    vocab_char_map, _, mcfg, _, _, params = setup(args)
    dataset = load_dataset(args.dataset_name, args.tokenizer, mcfg.mel_spec,
                           data_root=args.data_root)
    out = finetune(args, params, dataset, vocab_char_map)
    if "trainer" in out:
        print("done:", out["metrics"])
    return out


if __name__ == "__main__":
    main()
