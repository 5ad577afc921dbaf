"""Trainer: the training loop on one device (counterpart of
f5tts_tpu/train/trainer.py:40-384).

- DynamicBatchSampler frame-budget batches (`batch_size_per_device` frames,
  at most `max_samples` rows), collated and padded to 64-frame buckets.
- Gradient accumulation over `grad_accumulation_steps` micro-batches (summed,
  then divided), one optimizer update at the boundary.
- Deterministic mid-epoch resume (skip_first_batches semantics): the sampler
  is rebuilt with the same seed and the batches the restored update count
  already consumed are skipped. Each micro-batch draws its CFM noise from a
  generator seeded by (seed, micro-batch index), so a resumed run draws what
  an uninterrupted one would.
- Checkpoints: a milestone every `save_per_updates`, a heartbeat every
  `last_per_updates` and at the end (`CheckpointManager`).
- Tokenizers "char" (vocab map, the default here), "pinyin" (the JAX
  trainer's default: `text.pinyin` on strings, token lists looked up as they
  are) and "byte" (UTF-8).
- Any backbone of `cfm.BACKBONES` (`backbone=`, the DiT by default): its
  statics are rebuilt on the device by its `statics_cls`.
- Logging as the JAX trainer's (:150-167, :363): `logger` (or
  `train_cfg.logger`) "tensorboard" writes the logged metrics (loss,
  grad_norm, updates_per_s) as scalars with a `torch.utils.tensorboard`
  SummaryWriter in `log_dir`, "wandb" logs them to wandb; where the package
  does not import, nothing is written, as in the JAX trainer.
- `bf16_state=True` stores AdamW's mu / nu and the EMA in bf16 (the update
  computes in f32; `train.step.init_train_state`), as the JAX trainer's
  `bf16_state`; checkpoints keep the stored dtypes, so a resume restores
  the state bit for bit. The JAX trainer's buffer donation
  (`F5TTS_DONATE_STATE`) is an XLA matter with no counterpart here: the
  port's update already runs in place.
Not ported yet: multi-device and multi-host data parallelism, ZeRO-1,
`log_samples` (raises: it needs a sampler and a vocoder in the trainer;
ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import CFMConfig, TrainConfig
from f5tts_tpu_torch.models.cfm import DIT, BackboneDef
from f5tts_tpu_torch.models.modules import tree_leaves
from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.text.vocab import list_str_to_idx, list_str_to_tensor
from f5tts_tpu_torch.train.checkpoint import CheckpointManager
from f5tts_tpu_torch.train.dataset import DynamicBatchSampler, collate
from f5tts_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step
from f5tts_tpu_torch.utils import resolve_device


class Trainer:
    def __init__(self, params: dict, statics, train_cfg: TrainConfig,
                 cfm_cfg: CFMConfig = CFMConfig(), backbone: BackboneDef = DIT,
                 vocab_char_map: Optional[dict] = None, tokenizer: str = "char",
                 total_updates: Optional[int] = None, dtype=torch.bfloat16, device=None,
                 logger: Optional[str] = None, log_dir: str = "runs", bf16_state: bool = False):
        """`statics`: the backbone's statics (`backbone.statics_cls`); only
        its `.arch` is read. `logger` overrides `train_cfg.logger`."""
        if tokenizer not in ("pinyin", "char", "byte"):
            raise ValueError(f"unknown tokenizer {tokenizer!r} (pinyin | char | byte)")
        if tokenizer != "byte" and vocab_char_map is None:
            raise ValueError(f"the {tokenizer} tokenizer needs a vocab_char_map")
        if train_cfg.log_samples:
            raise NotImplementedError("log_samples is not ported: it needs a sampler and a "
                                      "vocoder in the trainer (ROADMAP.md queue 1 item 13)")
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.vocab_char_map = vocab_char_map
        self.backbone = backbone
        self.statics = backbone.statics_cls(statics.arch, self.device)
        warmup = train_cfg.num_warmup_updates
        self.hp = make_optimizer(train_cfg.learning_rate, warmup, total_updates or warmup * 10,
                                 train_cfg.max_grad_norm)
        sdt = torch.bfloat16 if bf16_state else None
        self.state = init_train_state(params, self.device, moment_dtype=sdt, ema_dtype=sdt)
        self.step_fn = make_train_step(
            self.statics, self.hp, cfm_cfg, ema_decay=train_cfg.ema_decay,
            ema_update_every=train_cfg.ema_update_every,
            ema_update_after_step=train_cfg.ema_update_after_step, dtype=dtype,
            backbone=backbone)
        self.accum = max(train_cfg.grad_accumulation_steps, 1)
        self.ckpt = CheckpointManager(train_cfg.save_dir, train_cfg.keep_last_n_checkpoints)
        self.writer = None
        logger = logger if logger is not None else train_cfg.logger
        if logger == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self.writer = None
        elif logger == "wandb":
            try:
                import wandb

                wandb.init(project="CFM-TTS", dir=log_dir)
                self.writer = "wandb"
            except Exception:
                self.writer = None

    def _log(self, metrics: dict, step: int) -> None:
        if self.writer == "wandb":
            import wandb

            wandb.log(metrics, step=step)
        elif self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, v, step)
            self.writer.flush()

    def tokenize(self, texts: list) -> np.ndarray:
        if self.tokenizer == "pinyin":
            # prepared datasets store pinyin token lists already; converting
            # them again would split 'ni3' into its characters
            if texts and isinstance(texts[0], (list, tuple)):
                return list_str_to_idx(texts, self.vocab_char_map)
            return list_str_to_idx(convert_char_to_pinyin(texts), self.vocab_char_map)
        if self.tokenizer == "char":
            return list_str_to_idx(texts, self.vocab_char_map)
        return list_str_to_tensor(texts)

    def maybe_resume(self) -> int:
        restored = self.ckpt.restore(device=self.device)
        if restored is None:
            return 0
        self.state = restored
        return restored.step

    def _generator(self, seed: int, micro_index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed * 1_000_003 + micro_index)

    def train(self, dataset, resumable_with_seed: Optional[int] = 666,
              max_updates: Optional[int] = None, log_every: int = 10,
              on_update: Optional[Callable[[int, dict], None]] = None) -> dict:
        """Train until `epochs` or `max_updates`; returns the last logged
        metrics (floats). `on_update(update, metrics)` is called after each
        optimizer update with the metrics as device tensors."""
        cfg = self.cfg
        start_update = self.maybe_resume()
        seed = resumable_with_seed or 0
        frame_lens = [dataset.get_frame_len(i) for i in range(len(dataset))]
        sampler = DynamicBatchSampler(frame_lens, frames_threshold=cfg.batch_size_per_device,
                                      max_samples=cfg.max_samples, random_seed=resumable_with_seed)
        updates_per_epoch = max(len(sampler) // self.accum, 1)
        start_epoch = start_update // updates_per_epoch
        skip_batches = (start_update % updates_per_epoch) * self.accum

        update = start_update
        t0 = time.time()
        last_metrics: dict = {}
        accum_grads, accum_loss, accum_count = None, 0.0, 0
        for epoch in range(start_epoch, cfg.epochs):
            sampler.set_epoch(epoch)
            for bi, batch_idx in enumerate(sampler):
                if epoch == start_epoch and bi < skip_batches:
                    continue
                batch = collate([dataset[i] for i in batch_idx])
                mel = torch.from_numpy(batch["mel"]).to(self.device)
                text = torch.from_numpy(self.tokenize(batch["text"])).to(self.device)
                lens = torch.from_numpy(batch["mel_lengths"]).to(self.device)
                gen = self._generator(seed, update * self.accum + accum_count)
                loss, grads = self.step_fn.grad_step(self.state.params, mel, text, lens,
                                                     generator=gen)
                if self.accum > 1:
                    if accum_grads is None:
                        accum_grads = grads
                    else:
                        torch._foreach_add_(tree_leaves(accum_grads), tree_leaves(grads))
                    accum_loss = accum_loss + loss
                    accum_count += 1
                    if accum_count < self.accum:
                        continue
                    torch._foreach_div_(tree_leaves(accum_grads), float(self.accum))
                    loss, grads = accum_loss / self.accum, accum_grads
                    accum_grads, accum_loss, accum_count = None, 0.0, 0
                self.state, metrics = self.step_fn.apply_step(self.state, loss, grads)
                update = self.state.step
                if on_update is not None:
                    on_update(update, metrics)

                if update % log_every == 0:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    last_metrics["updates_per_s"] = log_every / max(time.time() - t0, 1e-9)
                    t0 = time.time()
                    self._log(last_metrics, update)

                if update % cfg.save_per_updates == 0:
                    self.ckpt.save(self.state)
                elif update % cfg.last_per_updates == 0:
                    self.ckpt.save(self.state, heartbeat=True)

                if max_updates is not None and update >= max_updates:
                    self.ckpt.save(self.state, heartbeat=True)
                    return last_metrics
        self.ckpt.save(self.state, heartbeat=True)
        return last_metrics

