"""Training entry point: a YAML config in the reference layout plus
`key.path=value` overrides (counterpart of f5tts_tpu/train/train_cli.py).

`main` parses the flags, reads the YAML (PyYAML, imported there) and the
dataset (`load_dataset`), then calls `train(config dict, dataset)`, which
needs neither PyYAML nor `datasets` and so also runs where they are missing.
The model trains on the card in bf16 unless `--device cpu` is given (f32).
Its weights come from the port's own `backbone.init` (seed 0): the JAX
package's PRNGKey(0) init cannot be reproduced in torch.
`--bf16_state` stores the AdamW moments and the EMA in bf16.

Multi-GPU (as the JAX CLI's `--mesh_data` / `--mesh_model` / `--zero1`):
under `torchrun` every process trains its rows over a data x model mesh
(`parallel.mesh.make_mesh`; `--mesh_data` defaults to the processes /
`--mesh_model`), each on card `LOCAL_RANK` (`utils.resolve_device`). The
process group comes up from torchrun's environment (`--dist_init` names
another init method, such as a `file://` store): NCCL on the card, gloo
only with `--device cpu`. Without torchrun a mesh flag or `--zero1` makes a
one-process group. Rank 0 logs and writes the checkpoints.

Usage:
    python -m f5tts_tpu_torch.train.train_cli --config f5tts_tpu_torch/configs/F5TTS_v1_Base.yaml \
        optim.epochs=1 datasets.name=LJSpeech
    torchrun --nproc_per_node=8 -m f5tts_tpu_torch.train.train_cli --config ... \
        --mesh_data 4 --mesh_model 2 --zero1
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("train_cli reads YAML through PyYAML, which is not installed; build "
                          "the config dict yourself and call train_cli.train") from e
    return yaml


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Set each `key.path=value` (leading '+' of the `++` style stripped; the
    value parsed as YAML) in `cfg`, creating missing levels."""
    yaml = _yaml()
    for ov in overrides:
        key, _, value = ov.lstrip("+").partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return cfg


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", "-c", required=True, help="model YAML (reference layout)")
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="DP axis size (default: the processes / --mesh_model)")
    p.add_argument("--mesh_model", type=int, default=1, help="TP axis size")
    p.add_argument("--zero1", action="store_true",
                   help="shard AdamW moments + EMA over the data axis (ZeRO-1)")
    p.add_argument("--dist_init", default=None,
                   help="torch.distributed init method (default env://, torchrun's)")
    p.add_argument("--bf16_state", action="store_true",
                   help="store AdamW moments + EMA in bf16 (the update computes in f32)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def init_distributed(device, init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Bring the default process group up, unless it is: `rank` of
    `world_size` (torchrun's RANK / WORLD_SIZE by default) through
    `init_method` (env:// by default), or with neither, one process on an
    in-memory store. NCCL for a CUDA `device` (made the current card), gloo
    for the CPU. True when this call made it."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world_size is None and "WORLD_SIZE" in os.environ:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world_size is None:
        if init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
            return True
        rank, world_size = 0, 1
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return True


def setup_mesh(args, device):
    """The mesh of the flags (`parallel.mesh.Mesh`), or None for one process
    without mesh flags; brings the process group up first."""
    from f5tts_tpu_torch.parallel.mesh import make_mesh

    wanted = (int(os.environ.get("WORLD_SIZE", "1")) > 1 or args.mesh_data is not None
              or args.mesh_model > 1 or args.zero1 or args.dist_init is not None)
    if not wanted:
        return None
    init_distributed(device, args.dist_init)
    return make_mesh(args.mesh_data, args.mesh_model)


def build(raw: dict, data_root: Optional[str] = None):
    """(model config, train config, vocab map, vocab size, arch, backbone
    def) of a config dict, as the JAX main builds them."""
    from f5tts_tpu_torch.config import model_config_from_dict, train_config_from_dict
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.text.vocab import get_tokenizer

    mcfg = model_config_from_dict(raw)
    tcfg = train_config_from_dict(raw)
    tok_target = mcfg.tokenizer_path if mcfg.tokenizer == "custom" else tcfg.dataset_name
    vocab_char_map, vocab_size = get_tokenizer(tok_target, mcfg.tokenizer, data_root=data_root)
    arch = dataclasses.replace(mcfg.arch, text_num_embeds=vocab_size)
    return mcfg, tcfg, vocab_char_map, vocab_size, arch, BACKBONES[mcfg.backbone]


def train(raw: dict, dataset, *, max_updates: Optional[int] = None,
          data_root: Optional[str] = None, bf16_state: bool = False, device=None,
          params: Optional[dict] = None, on_update=None, mesh=None, zero1: bool = False):
    """Train on `dataset` from a config dict in the reference YAML layout;
    `params` (the backbone's, unfused) replace the seed-0 init; `mesh` /
    `zero1` as the Trainer's. Returns (trainer, the last logged metrics)."""
    import torch

    from f5tts_tpu_torch.train.trainer import Trainer
    from f5tts_tpu_torch.utils import resolve_device

    mcfg, tcfg, vocab_char_map, _, arch, backbone = build(raw, data_root)
    dev = resolve_device(device)
    if params is None:
        params = backbone.init(torch.Generator().manual_seed(0), arch)
    trainer = Trainer(params, backbone.statics_cls(arch), tcfg, backbone=backbone,
                      vocab_char_map=vocab_char_map, tokenizer=mcfg.tokenizer,
                      dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
                      device=dev, bf16_state=bf16_state, mesh=mesh, zero1=zero1)
    metrics = trainer.train(dataset, resumable_with_seed=666, max_updates=max_updates,
                            on_update=on_update)
    return trainer, metrics


def load(args) -> tuple[dict, object]:
    """The config dict (YAML + overrides) and its dataset."""
    from f5tts_tpu_torch.config import model_config_from_dict, train_config_from_dict
    from f5tts_tpu_torch.train.dataset import load_dataset

    with open(args.config, encoding="utf-8") as f:
        raw = _yaml().safe_load(f)
    raw = apply_overrides(raw, args.overrides)
    mcfg, tcfg = model_config_from_dict(raw), train_config_from_dict(raw)
    dataset = load_dataset(tcfg.dataset_name, mcfg.tokenizer, mcfg.mel_spec,
                           data_root=args.data_root, dataset_type=tcfg.dataset_type,
                           audio_type=tcfg.audio_type)
    return raw, dataset


def main(argv=None):
    import torch.distributed as dist

    from f5tts_tpu_torch.utils import resolve_device

    args = parse_args(argv)
    raw, dataset = load(args)
    device = resolve_device(args.device)
    made = not dist.is_initialized()
    mesh = setup_mesh(args, device)
    try:
        _, metrics = train(raw, dataset, max_updates=args.max_updates, data_root=args.data_root,
                           bf16_state=args.bf16_state, device=device, mesh=mesh,
                           zero1=args.zero1)
    finally:
        if mesh is not None and made:
            dist.destroy_process_group()
    print("done:", metrics)
    return metrics


if __name__ == "__main__":
    main()
