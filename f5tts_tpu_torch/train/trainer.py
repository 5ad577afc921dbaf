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
- Tokenizers "pinyin" (the default, as the JAX trainer's: `text.pinyin` on
  strings, token lists looked up as they are), "char" and "custom" (vocab
  map) and "byte" (UTF-8). The JAX trainer byte-encodes under "custom"
  (its `tokenize` knows only pinyin and char), which ignores the custom
  vocab `finetune_cli --tokenizer custom` loads; the port looks it up.
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
- At each milestone `sample_fn(ema_params, update)` is called, and with
  `log_samples` and a `vocoder` (mel [b, d, t] -> wav [b, l]) the first row
  of the latest batch is cloned with the EMA weights, as the JAX trainer's
  `_log_sample` does: the doubled text, 32 Euler steps with sway -1, CFG 2,
  noise from a generator seeded by the update on the trainer's device;
  `update_<n>_gen.wav` / `update_<n>_ref.wav` under `save_dir/samples`.
  Known difference: JAX samples in f32 through its XLA path; the port's
  kernels take bf16 only, so on the card the sample runs in the trainer's
  dtype (bf16, through K3 / K1 / K2), on the CPU in f32 (plain versions).
- Multi-GPU (`mesh=parallel.mesh.make_mesh(data, model)`, as the JAX
  trainer's `mesh` / `zero1`): the state is sharded
  (`parallel.mesh.shard_train_state`: TP slices over "model", with `zero1`
  mu / nu / EMA flat shards over "data"); warm-up is
  `num_warmup_updates` x data and the frame budget
  `batch_size_per_device` x data (per device, as the reference's); a
  batch's rows are cut to a multiple of data; at data > 1 each rank loads
  only its rows, padded to the width the sampler's estimates agree on
  (`train.multihost`), tokenizes the whole batch and keeps its rows, and
  draws its rows of the global batch's noise. Only rank 0 logs, writes
  checkpoints (gathered: the single-device trainer's file, so a run
  resumes at any mesh) and runs the milestone sample (on the gathered
  EMA).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import CFMConfig, TrainConfig
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models.cfm import DIT, BackboneDef
from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.text.vocab import list_str_to_idx, list_str_to_tensor
from f5tts_tpu_torch.train.checkpoint import CheckpointManager
from f5tts_tpu_torch.train import multihost
from f5tts_tpu_torch.train.dataset import DynamicBatchSampler, collate
from f5tts_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step
from f5tts_tpu_torch.utils import duration_bucket, make_time_grid, resolve_device


def tokenize(texts: list, tokenizer: str, vocab_char_map: Optional[dict],
             pad_to: Optional[int] = None) -> np.ndarray:
    """[b] texts -> [b, nt] int32 ids (-1 padded) by `tokenizer` ("pinyin",
    "char" or "custom" through `vocab_char_map`, "byte")."""
    if tokenizer == "pinyin":
        # prepared datasets store pinyin token lists already; converting
        # them again would split 'ni3' into its characters
        if texts and isinstance(texts[0], (list, tuple)):
            return list_str_to_idx(texts, vocab_char_map, pad_to=pad_to)
        return list_str_to_idx(convert_char_to_pinyin(texts), vocab_char_map, pad_to=pad_to)
    if tokenizer in ("char", "custom"):
        return list_str_to_idx(texts, vocab_char_map, pad_to=pad_to)
    return list_str_to_tensor(texts, pad_to=pad_to)


class Trainer:
    def __init__(self, params: dict, statics, train_cfg: TrainConfig,
                 cfm_cfg: CFMConfig = CFMConfig(), backbone: BackboneDef = DIT,
                 vocab_char_map: Optional[dict] = None, tokenizer: str = "pinyin",
                 total_updates: Optional[int] = None, dtype=torch.bfloat16, device=None,
                 logger: Optional[str] = None, log_dir: str = "runs", bf16_state: bool = False,
                 sample_fn: Optional[Callable] = None, vocoder: Optional[Callable] = None,
                 mesh=None, zero1: bool = False):
        """`statics`: the backbone's statics (`backbone.statics_cls`); only
        its `.arch` is read. `logger` overrides `train_cfg.logger`.
        `sample_fn(ema_params, update)` runs at each milestone; `vocoder`
        (mel [b, d, t] -> wav) enables `train_cfg.log_samples`. `mesh` (a
        `parallel.mesh.Mesh`) trains data / tensor parallel, `zero1` shards
        the moments and EMA over its data axis; `params` are the whole
        tree on every rank."""
        if tokenizer not in ("pinyin", "char", "custom", "byte"):
            raise ValueError(f"unknown tokenizer {tokenizer!r} (pinyin | char | custom | byte)")
        if tokenizer != "byte" and vocab_char_map is None:
            raise ValueError(f"the {tokenizer} tokenizer needs a vocab_char_map")
        if zero1 and mesh is None:
            raise ValueError("zero1 shards the state over a mesh's data axis: pass mesh")
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.vocab_char_map = vocab_char_map
        self.backbone = backbone
        self.mesh, self.zero1 = mesh, zero1
        self.dp = 1 if mesh is None else mesh.data
        self.rank0 = mesh is None or mesh.rank == 0
        tp = None if mesh is None else mesh.tp
        self.statics = backbone.statics_cls(statics.arch, self.device, tp=tp)
        # the milestone sample runs the whole (gathered) EMA on rank 0
        self._sample_statics = (self.statics if tp is None
                                else backbone.statics_cls(statics.arch, self.device))
        self.dtype = dtype
        self.sample_fn = sample_fn
        self.vocoder = vocoder
        self._last_sample = None  # (mel [t, d], text) of the latest batch's first row
        warmup = train_cfg.num_warmup_updates * self.dp
        self.hp = make_optimizer(train_cfg.learning_rate, warmup, total_updates or warmup * 10,
                                 train_cfg.max_grad_norm)
        sdt = torch.bfloat16 if bf16_state else None
        self.state = self._shard(init_train_state(params, self.device, moment_dtype=sdt,
                                                  ema_dtype=sdt))
        self.step_fn = make_train_step(
            self.statics, self.hp, cfm_cfg, ema_decay=train_cfg.ema_decay,
            ema_update_every=train_cfg.ema_update_every,
            ema_update_after_step=train_cfg.ema_update_after_step, dtype=dtype,
            backbone=backbone, mesh=mesh)
        self.accum = max(train_cfg.grad_accumulation_steps, 1)
        self.ckpt = CheckpointManager(train_cfg.save_dir, train_cfg.keep_last_n_checkpoints)
        self.writer = None
        logger = logger if logger is not None else train_cfg.logger
        if not self.rank0:  # one writer, as the reference's main process
            logger = None
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

    def _shard(self, state):
        if self.mesh is None:
            return state
        from f5tts_tpu_torch.parallel.mesh import shard_train_state

        return shard_train_state(state, self.mesh, self.zero1)

    def ema_params(self) -> dict:
        """The whole EMA tree (gathered over the mesh; every rank must call)."""
        from f5tts_tpu_torch.parallel.mesh import gather_ema

        return gather_ema(self.state)

    def _log(self, metrics: dict, step: int) -> None:
        if self.writer == "wandb":
            import wandb

            wandb.log(metrics, step=step)
        elif self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, v, step)
            self.writer.flush()

    def tokenize(self, texts: list, pad_to: Optional[int] = None) -> np.ndarray:
        return tokenize(texts, self.tokenizer, self.vocab_char_map, pad_to)

    @torch.no_grad()
    def _log_sample(self, update: int, ema: Optional[dict] = None) -> Optional[dict]:
        """Clone the first row of the latest batch with the EMA weights
        (`ema`, the whole tree; the state's by default) (reference
        trainer.py:408-438) and write the generated and the reference wav
        under save_dir/samples. Returns the sampled mel [1, n, d] and the
        two paths, or None without a vocoder or a batch."""
        if self.vocoder is None or self._last_sample is None:
            return None
        ema = self.state.ema if ema is None else ema
        from f5tts_tpu_torch.infer import audio_io

        mel_ref, text = self._last_sample
        ref_frames = mel_ref.shape[0]
        total = min(ref_frames * 2, 4096)
        n_bucket = duration_bucket(total, 256, 4096, self.backbone.seq_extra_tokens)
        cond = np.zeros((1, n_bucket, mel_ref.shape[1]), np.float32)
        cond[0, :ref_frames] = mel_ref
        # doubled text (reference trainer.py:411): token lists get [" "]
        # spliced between, strings a space
        doubled = (list(text) + [" "] + list(text) if isinstance(text, (list, tuple))
                   else text + " " + text)
        dev = self.device
        # the kernels take bf16 only: the trainer's dtype on the card, f32 on
        # the CPU (the JAX trainer samples in f32)
        dtype = self.dtype if dev.type == "cuda" else torch.float32
        params = m.fuse_backbone_qkv(m.tree_cast(ema, dtype), dtype=dtype)
        out = cfm.cfm_sample(
            params, self._sample_statics, torch.from_numpy(cond).to(dev),
            torch.from_numpy(self.tokenize([doubled])).to(dev),
            torch.tensor([ref_frames], dtype=torch.int32, device=dev),
            torch.tensor([total], dtype=torch.int32, device=dev),
            make_time_grid(32, sway_sampling_coef=-1.0),
            generator=torch.Generator(device=dev).manual_seed(update), cfg_strength=2.0,
            dtype=dtype, backbone=self.backbone)
        gen = out[:, ref_frames:total, :].transpose(1, 2)
        ref = torch.from_numpy(mel_ref[None]).to(dev).transpose(1, 2)
        sample_dir = os.path.join(self.cfg.save_dir, "samples")
        os.makedirs(sample_dir, exist_ok=True)
        paths = []
        for kind, mel in (("gen", gen), ("ref", ref)):
            wav = self.vocoder(mel)[0].float().cpu().numpy()
            paths.append(os.path.join(sample_dir, f"update_{update}_{kind}.wav"))
            audio_io.write_wav(paths[-1], wav, 24000)
        return {"mel": out, "gen_wav": paths[0], "ref_wav": paths[1]}

    def maybe_resume(self) -> int:
        restored = self.ckpt.restore(device=self.device, mesh=self.mesh, zero1=self.zero1)
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
        sampler = DynamicBatchSampler(frame_lens,
                                      frames_threshold=cfg.batch_size_per_device * self.dp,
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
                # the rows must split over the data axis
                batch_idx = list(batch_idx)[:len(batch_idx) // self.dp * self.dp]
                if not batch_idx:
                    continue
                if self.dp > 1:
                    # every rank walks the same sampler sequence, loads only
                    # its rows, pads to the width the estimates agree on and
                    # tokenizes the whole batch (train/multihost.py)
                    rows = multihost.process_local_rows(self.mesh, len(batch_idx))
                    width = multihost.global_pad_width([frame_lens[i] for i in batch_idx])
                    text_np = self.tokenize([dataset.get_text(i) for i in batch_idx])[rows]
                    batch = collate([dataset[i] for i in batch_idx[rows]], pad_to=width)
                else:
                    batch = collate([dataset[i] for i in batch_idx])
                    text_np = self.tokenize(batch["text"])
                if cfg.log_samples:
                    t0_len = int(batch["mel_lengths"][0])
                    self._last_sample = (batch["mel"][0, :t0_len].copy(), batch["text"][0])
                mel = torch.from_numpy(batch["mel"]).to(self.device)
                text = torch.from_numpy(np.ascontiguousarray(text_np)).to(self.device)
                lens = torch.from_numpy(batch["mel_lengths"]).to(self.device)
                gen = self._generator(seed, update * self.accum + accum_count)
                loss, grads = self.step_fn.grad_step(self.state.params, mel, text, lens,
                                                     generator=gen)
                if self.accum > 1:
                    if accum_grads is None:
                        accum_grads = grads
                    else:
                        torch._foreach_add_(m.tree_leaves(accum_grads), m.tree_leaves(grads))
                    accum_loss = accum_loss + loss
                    accum_count += 1
                    if accum_count < self.accum:
                        continue
                    torch._foreach_div_(m.tree_leaves(accum_grads), float(self.accum))
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
                    if self.rank0:
                        self._log(last_metrics, update)

                if update % cfg.save_per_updates == 0:
                    self.ckpt.save(self.state)
                    if self.sample_fn is not None or cfg.log_samples:
                        ema = self.ema_params()  # every rank takes part in the gather
                        if self.rank0 and self.sample_fn is not None:
                            self.sample_fn(ema, update)
                        if self.rank0 and cfg.log_samples:
                            self._log_sample(update, ema)
                elif update % cfg.last_per_updates == 0:
                    self.ckpt.save(self.state, heartbeat=True)

                if max_updates is not None and update >= max_updates:
                    self.ckpt.save(self.state, heartbeat=True)
                    return last_metrics
        self.ckpt.save(self.state, heartbeat=True)
        return last_metrics

