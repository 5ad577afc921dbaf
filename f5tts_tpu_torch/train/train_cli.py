"""Training entry point: a YAML config in the reference layout plus
`key.path=value` overrides (counterpart of f5tts_tpu/train/train_cli.py).

`main` parses the flags, reads the YAML (PyYAML, imported there) and the
dataset (`load_dataset`), then calls `train(config dict, dataset)`, which
needs neither PyYAML nor `datasets` and so also runs where they are missing.
The model trains on the card in bf16 unless `--device cpu` is given (f32).
Its weights come from the port's own `backbone.init` (seed 0): the JAX
package's PRNGKey(0) init cannot be reproduced in torch.
One device only: `--mesh_data` or `--mesh_model` above 1 and `--zero1`
raise (multi-GPU is ROADMAP.md queue 1 item 16); `--bf16_state` stores the
AdamW moments and the EMA in bf16.

Usage:
    python -m f5tts_tpu_torch.train.train_cli --config f5tts_tpu_torch/configs/F5TTS_v1_Base.yaml \
        optim.epochs=1 datasets.name=LJSpeech
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--mesh_data", type=int, default=None, help="DP axis size (1 only)")
    p.add_argument("--mesh_model", type=int, default=1, help="TP axis size (1 only)")
    p.add_argument("--zero1", action="store_true", help="not ported (multi-GPU)")
    p.add_argument("--bf16_state", action="store_true",
                   help="store AdamW moments + EMA in bf16 (the update computes in f32)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = p.parse_args(argv)
    # the port trains on one device: a mesh or ZeRO-1 raises
    if (args.mesh_data or 1) > 1 or (args.mesh_model or 1) > 1 or args.zero1:
        raise NotImplementedError(
            "multi-device training (--mesh_data / --mesh_model > 1, --zero1) is not ported; "
            "the port trains on one device (ROADMAP.md queue 1 item 16)")
    return args


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
          params: Optional[dict] = None, on_update=None):
    """Train on `dataset` from a config dict in the reference YAML layout;
    `params` (the backbone's, unfused) replace the seed-0 init. Returns
    (trainer, the last logged metrics)."""
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
                      device=dev, bf16_state=bf16_state)
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
    args = parse_args(argv)
    raw, dataset = load(args)
    _, metrics = train(raw, dataset, max_updates=args.max_updates, data_root=args.data_root,
                       bf16_state=args.bf16_state, device=args.device)
    print("done:", metrics)
    return metrics


if __name__ == "__main__":
    main()
