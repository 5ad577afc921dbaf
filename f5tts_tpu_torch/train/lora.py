"""Style-LoRA adapters: low-rank finetuning of the backbone blocks
(counterpart of f5tts_tpu/train/lora.py).

A·B adapters on the attention q / k / v / out and the feed-forward in / out
projections of every block of `params["blocks"]` (the DiT; the MMDiT's
blocks as the JAX package reads them), kept as a small tree beside the base
weights:
- the tree has the JAX package's layout: {"attn": {"to_q": {"a": [L, in, r],
  "b": [L, r, out]}, ...}, "ff": {"in": ..., "out": ...}}, stacked over the
  L blocks (the port's blocks are a list; block i reads row i). The file
  `finetune_cli` writes (`save_lora`) is the JAX one, a pickle of nested
  dicts of numpy arrays, so adapters cross between the two packages;
- merge: w_eff = w + (alpha / rank) * A @ B, in f32, cast to the base
  dtype (`apply_lora`, `merge_lora`);
- training (`make_lora_train_step`): gradients reach the adapters only; the
  base weights are frozen (requires_grad False) and the merged weights are
  what the forward reads, so every targeted projection still computes its
  weight gradient. The optimizer is `finetune_cli`'s optax chain,
  clip_by_global_norm then adamw at optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8, weight decay 1e-4, a constant learning rate, no EMA), written
  over `torch._foreach_*` in optax's order;
- serving (`merge_for_serving`): merge, fuse q / k / v, optionally int8.
The UNetT (first_half / second_half) has no `blocks`: the JAX package fails
there with a KeyError, the port raises a ValueError.

Over a mesh (`make_lora_train_step(mesh=)`, `shard_lora_state`): the base
weights are this rank's tensor-parallel shards and `lora_param_specs` shards
the adapters as the JAX package does (B follows a column base's output
axis, A a row base's input axis). The other factor is whole on every rank
but meets a sharded one inside the product, so the merge passes it through
`copy_to_tp`: its gradient is summed over the model group. Gradients are
reduced over "data" once an update (all-reduced, or reduce-scattered under
ZeRO-1, where AdamW runs on this rank's flat shard of mu / nu), as in
`train.step`.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import CFMConfig
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.parallel.collectives import all_reduce_sum
from f5tts_tpu_torch.utils import resolve_device

# block projections that receive adapters (names under blocks' attn / ff)
DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out", "in", "out")


class LoRAConfig(NamedTuple):
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = DEFAULT_TARGETS


def _blocks(params: dict) -> list:
    blocks = params.get("blocks")
    if not isinstance(blocks, list) or not blocks:
        raise ValueError("LoRA adapts the projections of params['blocks'] (DiT, MMDiT); this "
                         f"backbone has {sorted(params)} (the UNetT's blocks are first_half / "
                         "second_half)")
    return blocks


def _targets(params: dict, targets: tuple) -> dict:
    """{group: [names]} of the block projections to adapt."""
    first = _blocks(params)[0]
    out: dict = {}
    for group in ("attn", "ff"):
        for name, sub in first[group].items():
            if name in targets and isinstance(sub, dict) and "w" in sub:
                out.setdefault(group, []).append(name)
    return out


def init_lora(generator: torch.Generator, params: dict, cfg: LoRAConfig = LoRAConfig()) -> dict:
    """Adapters for every target: a ~ N(0, 1 / rank) from `generator`, b = 0
    (so the merged weights equal the base), f32 on the base weights' device."""
    blocks = _blocks(params)
    lora: dict = {}
    for group, names in _targets(params, cfg.targets).items():
        for name in names:
            w = blocks[0][group][name]["w"]
            d_in, d_out = w.shape
            a = torch.randn((len(blocks), d_in, cfg.rank), generator=generator,
                            device=generator.device) / math.sqrt(cfg.rank)
            b = torch.zeros((len(blocks), cfg.rank, d_out))
            lora.setdefault(group, {})[name] = {"a": a.to(w.device), "b": b.to(w.device)}
    return lora


def lora_param_specs(lora: dict, base_specs: dict) -> dict:
    """Tensor-parallel specs of the adapters (`parallel.mesh.Spec`): B
    takes a column base's sharded output axis, A a row base's sharded input
    axis (JAX lora.py:85-99); `base_specs` is `dit_param_specs(base)`."""
    from f5tts_tpu_torch.parallel.mesh import Spec

    block = base_specs["blocks"][0]
    out: dict = {}
    for group, subs in lora.items():
        for name in subs:
            d_in, d_out = block[group][name]["w"].axes
            out.setdefault(group, {})[name] = {"a": Spec((None, d_in, None)),
                                               "b": Spec((None, None, d_out))}
    return out


def apply_lora(params: dict, lora: dict, cfg: LoRAConfig = LoRAConfig(), tp=None) -> dict:
    """`params` with each adapted weight w + (alpha / rank) * A @ B (cast to
    w's dtype); every other leaf is the base's own tensor. Differentiable in
    the adapters. With `tp`, params and adapters are this rank's shards: the
    whole factor of each product passes `copy_to_tp`."""
    from f5tts_tpu_torch.parallel.collectives import copy_to_tp
    from f5tts_tpu_torch.parallel.mesh import _COL

    scale = cfg.alpha / cfg.rank
    out = dict(params)
    blocks = [dict(blk) for blk in _blocks(params)]
    for group, subs in lora.items():
        for blk in blocks:
            blk[group] = dict(blk[group])
        for name, ab in subs.items():
            a, b = ab["a"], ab["b"]
            if tp is not None:  # the whole factor (A of a column base, B of a row one)
                if (group, name) in _COL:
                    a = copy_to_tp(a, tp)
                else:
                    b = copy_to_tp(b, tp)
            delta = torch.einsum("lir,lro->lio", a.float(), b.float()) * scale
            for i, blk in enumerate(blocks):
                base = blk[group][name]
                w = base["w"]
                blk[group][name] = dict(base, w=w + delta[i].to(device=w.device, dtype=w.dtype))
    out["blocks"] = blocks
    return out


def merge_lora(params: dict, lora: dict, cfg: LoRAConfig = LoRAConfig()) -> dict:
    """`apply_lora`'s weights, materialised for export (no autograd graph)."""
    with torch.no_grad():
        return apply_lora(params, lora, cfg)


class AdamWHParams(NamedTuple):
    """`optax.chain(clip_by_global_norm(max_grad_norm), adamw(learning_rate))`
    at optax's defaults (finetune_cli.py:134-136)."""

    learning_rate: float
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4


@dataclasses.dataclass
class LoRAOptState:
    mu: dict     # first moment, a tree like the adapters
    nu: dict     # second moment
    count: int   # optax's `count`
    # over a mesh, how adapters and moments lie (`parallel.mesh.ShardInfo`);
    # under ZeRO-1 mu / nu are this rank's 1-D flat shards
    shard: Optional[object] = None


def init_lora_opt_state(lora: dict) -> LoRAOptState:
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    return LoRAOptState(mu=m.tree_map(zeros, lora), nu=m.tree_map(zeros, lora), count=0)


def shard_lora_state(lora: dict, opt: LoRAOptState, base_specs: dict, mesh,
                     zero1: bool = False) -> tuple[dict, LoRAOptState]:
    """(this rank's adapters, its optimizer state) from whole ones:
    `lora_param_specs` slices, and under ZeRO-1 the adapters become views
    into one flat buffer and mu / nu this rank's shards of it."""
    from f5tts_tpu_torch.parallel.mesh import shard_state_trees

    specs = lora_param_specs(lora, base_specs)
    lora, mu, nu, _, info = shard_state_trees(lora, opt.mu, opt.nu, None, specs, mesh, zero1)
    return lora, LoRAOptState(mu=mu, nu=nu, count=opt.count, shard=info)


def gather_lora_state(lora: dict, opt: LoRAOptState) -> tuple[dict, LoRAOptState]:
    """The whole adapters and optimizer state of sharded ones, on every rank
    (collectives over both groups)."""
    info = opt.shard
    if info is None:
        return lora, opt
    full = [info.full_tree(t, lora) for t in (lora, opt.mu, opt.nu)]
    return full[0], LoRAOptState(mu=full[1], nu=full[2], count=opt.count)


class LoRATrainStep:
    """`loss_and_grads` (the CFM loss through the merged weights and its
    adapter gradients) and `apply` (clip + AdamW on the adapters, in place);
    calling it does both and returns (lora, opt_state, {"loss", "grad_norm"})
    with the gradients' global norm before clipping, as the JAX step."""

    def __init__(self, base_params: dict, statics, tx: AdamWHParams,
                 cfg: LoRAConfig = LoRAConfig(), cfm_cfg: Optional[CFMConfig] = None,
                 dtype=torch.bfloat16, backbone: cfm.BackboneDef = cfm.DIT, mesh=None):
        _blocks(base_params)
        self.mesh = mesh
        self.base = m.tree_map(lambda t: t.detach().requires_grad_(False), base_params)
        self.statics = statics
        self.tx = tx
        self.cfg = cfg
        self.cfm_cfg = cfm_cfg or CFMConfig()
        self.dtype = dtype
        self.backbone = backbone

    def loss_fn(self, lora: dict, mel, text, lens, generator=None, draws=None) -> torch.Tensor:
        mesh = self.mesh
        merged = m.fuse_backbone_qkv(apply_lora(self.base, lora, self.cfg,
                                                None if mesh is None else mesh.tp),
                                     dtype=self.dtype)
        if mesh is not None and draws is None and generator is not None:
            from f5tts_tpu_torch.train.step import mesh_draws

            draws = mesh_draws(generator, mel, mesh, self.cfm_cfg)
        loss, _ = cfm.cfm_loss(merged, self.statics, mel, text, lens, self.cfm_cfg, self.dtype,
                               generator=generator, draws=draws, backbone=self.backbone,
                               dp_group=None if mesh is None else mesh.data_group)
        return loss

    def loss_and_grads(self, lora: dict, mel, text, lens, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[cfm.CFMDraws] = None) -> tuple[torch.Tensor, dict]:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in m.tree_leaves(lora)]
            loss = self.loss_fn(m.tree_unflatten(lora, leaves), mel, text, lens, generator, draws)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), m.tree_unflatten(lora, list(grads))

    def apply(self, lora: dict, opt: LoRAOptState, grads: dict) -> torch.Tensor:
        """optax's clip_by_global_norm then adamw on `lora` in place; returns
        the global norm before clipping. Over a mesh the gradients are this
        rank's, reduced here (`opt.shard`)."""
        tx = self.tx
        if opt.shard is None:
            p, mu, nu = (m.tree_leaves(t) for t in (lora, opt.mu, opt.nu))
            g = [x.float() for x in m.tree_leaves(grads)]
            gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        else:
            p, g, mu, nu, _, gnorm = opt.shard.reduce(grads, lora, opt.mu, opt.nu, None)
        # where(g_norm < max_norm, g, g / g_norm * max_norm)
        clip = gnorm >= tx.max_grad_norm
        gc = torch._foreach_div(g, gnorm)
        torch._foreach_mul_(gc, tx.max_grad_norm)
        g = [torch.where(clip, c, x) for c, x in zip(gc, g)]
        del gc
        count_inc = opt.count + 1
        # update_moment: (1 - decay) * g + decay * t
        torch._foreach_mul_(mu, tx.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - tx.b1))
        torch._foreach_mul_(nu, tx.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - tx.b2))
        bc1 = float(np.float32(1.0) - np.float32(tx.b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(tx.b2) ** np.float32(count_inc))
        upd = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, tx.eps)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(p, tx.weight_decay))
        torch._foreach_mul_(upd, -tx.learning_rate)
        torch._foreach_add_(p, upd)
        if opt.shard is not None:
            opt.shard.finish()
        opt.count = count_inc
        return gnorm

    def __call__(self, lora: dict, opt: LoRAOptState, mel, text, lens, *,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[cfm.CFMDraws] = None) -> tuple[dict, LoRAOptState, dict]:
        loss, grads = self.loss_and_grads(lora, mel, text, lens, generator=generator, draws=draws)
        gnorm = self.apply(lora, opt, grads)
        if opt.shard is not None:
            loss = all_reduce_sum(loss, opt.shard.mesh.data_group)
        return lora, opt, {"loss": loss, "grad_norm": gnorm}


def make_lora_train_step(base_params: dict, statics, tx: AdamWHParams,
                         cfg: LoRAConfig = LoRAConfig(), cfm_cfg: Optional[CFMConfig] = None,
                         dtype=torch.bfloat16, backbone: cfm.BackboneDef = cfm.DIT,
                         mesh=None) -> LoRATrainStep:
    """step(lora, opt_state, mel, text, lens, generator= | draws=) ->
    (lora, opt_state, metrics); only the adapters are optimized. Over a
    `mesh`: base_params this rank's shards (`parallel.mesh.shard_params`),
    statics made with `tp=mesh.tp`, lora / opt_state from
    `shard_lora_state`."""
    return LoRATrainStep(base_params, statics, tx, cfg, cfm_cfg, dtype, backbone, mesh)


def count_lora_params(lora: dict) -> int:
    return sum(t.numel() for t in m.tree_leaves(lora))


def save_lora(lora: dict, path: str) -> None:
    """The adapters as `finetune_cli` writes them: a pickle of nested dicts
    of f32 numpy arrays (the JAX package's `load_lora` reads it)."""
    tree = m.tree_map(lambda t: t.detach().float().cpu().numpy(), lora)
    with open(path, "wb") as f:
        pickle.dump(tree, f)


def load_lora(path: str, device=None) -> dict:
    """Adapters saved by either package's `finetune_cli --lora` (a pickle of
    nested dicts of arrays), as f32 tensors on `device` (the card unless
    named). Unpickling runs code the file names: load only adapters a
    trusted run wrote."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return m.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), tree)


def merge_for_serving(base_params: dict, lora: dict, cfg: LoRAConfig = LoRAConfig(),
                      quantization: str = "none") -> dict:
    """Merge the adapters into the base weights, fuse q / k / v
    (`fuse_backbone_qkv`) and with "int8" quantize the block projections
    (`quantize_dit_params`): the tree the JAX package serves. Merging comes
    first, so adapters trained on the unfused layout compose with fusion and
    int8."""
    if quantization not in ("none", "int8"):
        raise ValueError(f"unknown quantization {quantization!r}")
    with torch.no_grad():
        merged = m.fuse_backbone_qkv(merge_lora(base_params, lora, cfg))
        if quantization == "int8":
            from f5tts_tpu_torch.ops.quant import quantize_dit_params

            merged = quantize_dit_params(merged)
    return merged
