"""Training step: CFM loss -> backward -> clip + AdamW + EMA (counterpart of
f5tts_tpu/train/step.py).

The recipe is the reference Trainer's, as the JAX package's optax chain and
its fused update compute it:
- global-norm clipping that scales only when the norm is >= max_grad_norm
  (`where(g < max, 1, max / g)`, no epsilon);
- AdamW with bias correction at count + 1, eps outside the square root,
  decoupled weight decay 0.01, lr from the warmup/decay `join_schedules`
  (1e-8 -> peak over `warmup_updates`, then back to 1e-8);
- the EMA e' = alpha e + (1 - alpha) p with alpha in {1, 0, decay} at the
  post-increment step (ema_pytorch's update_every / update_after_step).
Scalars (lr, bias corrections, alpha) are computed in f32 on the host, as
XLA computes them. The update runs with `torch._foreach_*` ops and updates
the state's tensors IN PLACE (params, mu, nu, ema): the state of F5TTS_v1_Base
is 5.4 GB in f32 and is never double-buffered.

`init_train_state(moment_dtype=, ema_dtype=)` stores mu / nu and the EMA in
a reduced dtype (bf16), as the JAX package's init_train_state: the update
then computes each group of leaves in f32 (f32 copies of the stored ones)
and casts the new moments and EMA back once (the JAX package computes the
EMA in its stored dtype; here it is rounded once from f32). The params
stay f32.

The optimizer state is kept on the unfused to_q / to_k / to_v tree. With
`fuse_qkv=True` (the default) the loss fuses a per-step to_qkv view
(`fuse_backbone_qkv(params, dtype)`), and autograd carries the gradient back
through the concatenation; with `fuse_qkv=False` it runs on the unfused
projections (the head layout: RoPE on the flat q / k, then K7's lse mode
and K9), as the JAX make_train_step(fuse_qkv=False). The loss runs through
any backbone of `cfm.BACKBONES` (`backbone=`, as the JAX make_train_step's
`backbone`): the DiT, the UNetT or the MMDiT.

Over a mesh (`parallel.mesh`, `make_train_step(mesh=)`), each rank takes its
rows of the global batch and of the global batch's draws (`grad_step`
draws B x data rows from the generator and keeps its own, so any data size
computes what one rank does on the whole batch); the loss divides by the
global span count (`cfm_loss(dp_group=)`). Gradients stay local through
micro-batches and are reduced once an update, in `apply_step`, by the
state's `ShardInfo` (`parallel.mesh.shard_train_state`): all-reduced over
"data", or reduce-scattered under ZeRO-1, where AdamW and the EMA run on
this rank's flat shard and the parameters are all-gathered after. The
global gradient norm sums TP-sharded leaves over "model" and counts
replicated leaves once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import CFMConfig
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.parallel.collectives import all_reduce_sum


@dataclasses.dataclass
class TrainState:
    params: dict     # f32 leaves, the unfused tree
    mu: dict         # AdamW first moment (optax ScaleByAdamState.mu)
    nu: dict         # AdamW second moment
    count: int       # AdamW / schedule update count (optax's `count`)
    ema: dict        # EMA of params
    step: int        # update counter (JAX TrainState.step)
    # over a mesh, how the state lies (`parallel.mesh.ShardInfo`); under
    # ZeRO-1 mu / nu / ema are this rank's 1-D flat shards
    shard: Optional[object] = None


class OptHParams(NamedTuple):
    """make_optimizer's hyperparameters."""

    learning_rate: float
    warmup_updates: int
    total_updates: int
    max_grad_norm: float = 1.0
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def make_optimizer(learning_rate: float, warmup_updates: int, total_updates: int,
                   max_grad_norm: float = 1.0, weight_decay: float = 0.01) -> OptHParams:
    """AdamW with the reference's warmup -> decay ramp (JAX step.py:58-72)."""
    return OptHParams(learning_rate, warmup_updates, total_updates, max_grad_norm, weight_decay)


def _linear_schedule(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax.linear_schedule at `count`, in f32."""
    if steps <= 0:
        return np.float32(init)
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1.0) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def learning_rate_at(hp: OptHParams, count: int) -> np.float32:
    """The warmup/decay `join_schedules` (JAX step.py:47-55) at `count`."""
    if count < hp.warmup_updates:
        return _linear_schedule(1e-8, hp.learning_rate, hp.warmup_updates, count)
    return _linear_schedule(hp.learning_rate, 1e-8, max(hp.total_updates - hp.warmup_updates, 1),
                            count - hp.warmup_updates)


def ema_alpha(step: int, decay: float, update_every: int, update_after_step: int) -> np.float32:
    """alpha of e' = alpha e + (1 - alpha) p at the post-increment `step`."""
    if step % update_every != 0:
        return np.float32(1.0)
    return np.float32(decay) if step > update_after_step else np.float32(0.0)


def init_train_state(params: dict, device=None, moment_dtype=None, ema_dtype=None) -> TrainState:
    """Fresh state: f32 copies of `params` on `device`, zero moments, EMA =
    params; mu / nu stored in `moment_dtype` and the EMA in `ema_dtype`
    (f32 when None)."""
    p = m.tree_map(lambda a: a.detach().to(device=device, dtype=torch.float32).clone(), params)
    mdt, edt = moment_dtype or torch.float32, ema_dtype or torch.float32
    return TrainState(params=p, mu=m.tree_map(lambda a: torch.zeros_like(a, dtype=mdt), p),
                      nu=m.tree_map(lambda a: torch.zeros_like(a, dtype=mdt), p), count=0,
                      ema=m.tree_map(lambda a: a.to(edt, copy=True), p), step=0)


def mesh_draws(generator: torch.Generator, mel, mesh, cfg: CFMConfig) -> cfm.CFMDraws:
    """This rank's rows of the draws of the global batch (its rows x the
    data size), as one rank drawing the whole batch gets them."""
    from f5tts_tpu_torch.parallel.mesh import batch_sharding

    b, n, d = mel.shape
    full = cfm.make_draws(generator, b * mesh.data, n, d, cfg)
    return cfm.CFMDraws(*(t[batch_sharding(mesh, b * mesh.data)] for t in full))


def _groups(leaves: list, limit: Optional[int] = 1 << 25):
    """(start, end) of consecutive runs of `leaves` holding at most `limit`
    elements (one leaf at least; all of them when `limit` is None): a
    reduced-dtype state's f32 copies are a run's size, not the model's."""
    start, size = 0, 0
    for i, t in enumerate(leaves):
        if limit is not None and i > start and size + t.numel() > limit:
            yield start, i
            start, size = i, 0
        size += t.numel()
    if leaves:
        yield start, len(leaves)


class TrainStep:
    """`grad_step` (one micro-batch: loss and grads) and `apply_step` (clip +
    AdamW + EMA + counters); calling it does both (JAX make_train_step)."""

    def __init__(self, statics, hp: OptHParams, cfg: CFMConfig = CFMConfig(),
                 ema_decay: float = 0.999, ema_update_every: int = 10,
                 ema_update_after_step: int = 100, dtype=torch.bfloat16,
                 backbone: cfm.BackboneDef = cfm.DIT, fuse_qkv: bool = True, mesh=None):
        self.statics = statics
        self.mesh = mesh
        self.hp = hp
        self.cfg = cfg
        self.ema = (ema_decay, ema_update_every, ema_update_after_step)
        self.dtype = dtype
        self.backbone = backbone
        self.fuse_qkv = fuse_qkv

    def loss_fn(self, params, mel, text, lens, generator=None, draws=None) -> torch.Tensor:
        if self.fuse_qkv:
            params = m.fuse_backbone_qkv(params, dtype=self.dtype)
        loss, _ = cfm.cfm_loss(params, self.statics, mel, text, lens, self.cfg, self.dtype,
                               generator=generator, draws=draws, backbone=self.backbone,
                               dp_group=None if self.mesh is None else self.mesh.data_group)
        return loss

    def grad_step(self, params, mel, text, lens, *, generator: Optional[torch.Generator] = None,
                  draws: Optional[cfm.CFMDraws] = None) -> tuple[torch.Tensor, dict]:
        """(loss, grads) of one micro-batch; grads is a tree like params.
        Over a mesh: this rank's rows, its share of the loss and its local
        gradients (`draws`, when given, are this rank's rows)."""
        if self.mesh is not None and draws is None and generator is not None:
            draws = mesh_draws(generator, mel, self.mesh, self.cfg)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in m.tree_leaves(params)]
            loss = self.loss_fn(m.tree_unflatten(params, leaves), mel, text, lens, generator, draws)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), m.tree_unflatten(params, grads)

    def apply_step(self, state: TrainState, loss, grads: dict) -> tuple[TrainState, dict]:
        """Clip + AdamW + EMA on `state` in place (`grads` are consumed).
        Over a mesh the loss and gradients are this rank's (`grad_step`),
        reduced here."""
        hp = self.hp
        if state.shard is None:
            p, mu, nu, ema = (m.tree_leaves(t) for t in (state.params, state.mu, state.nu,
                                                         state.ema))
            g = [x.float() for x in m.tree_leaves(grads)]
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        else:
            loss = all_reduce_sum(loss, state.shard.mesh.data_group)
            p, g, mu, nu, ema, gnorm = state.shard.reduce(grads, state.params, state.mu, state.nu,
                                                          state.ema)
        del grads
        gscale = torch.where(gnorm < hp.max_grad_norm, torch.ones_like(gnorm),
                             hp.max_grad_norm / gnorm)
        count_inc = state.count + 1
        lr = float(learning_rate_at(hp, state.count))
        bc1 = float(np.float32(1.0) - np.float32(hp.b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(hp.b2) ** np.float32(count_inc))
        step = state.step + 1
        alpha = ema_alpha(step, *self.ema)

        torch._foreach_mul_(g, gscale)
        # f32 leaves are updated in place, a reduced-dtype leaf (bf16_state)
        # in an f32 copy cast back once. Only copies need bounding: an f32
        # state is one group, as 2^25-element groups cost it 17.1 ms of
        # AdamW + EMA a step against 14.2 (PERF.md: DiT, 16 x 1024, one H100)
        reduced = any(t.dtype != torch.float32 for t in mu + nu + ema)
        for a, b in _groups(p, 1 << 25 if reduced else None):
            stored = (mu[a:b], nu[a:b]) + ((ema[a:b],) if alpha != 1.0 else ())
            work = [[t if t.dtype == torch.float32 else t.float() for t in ts] for ts in stored]
            self._update(p[a:b], g[a:b], work[0], work[1], work[2] if alpha != 1.0 else None,
                         lr, bc1, bc2, alpha)
            for ts, ws in zip(stored, work):
                back = [(t, w) for t, w in zip(ts, ws) if w is not t]
                if back:
                    torch._foreach_copy_([t for t, _ in back], [w for _, w in back])
        if state.shard is not None:
            state.shard.finish()
        state.count, state.step = count_inc, step
        return state, {"loss": loss, "grad_norm": gnorm}

    def _update(self, p, g, mu, nu, ema, lr, bc1, bc2, alpha) -> None:
        """AdamW then the EMA (none when alpha is 1), in place on lists of f32
        leaves; `g` is emptied once the moments have read it."""
        hp = self.hp
        torch._foreach_mul_(mu, hp.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - hp.b1)
        torch._foreach_mul_(nu, hp.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - hp.b2)
        g.clear()
        upd = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, hp.eps)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, p, alpha=hp.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)
        del upd
        if alpha == 0.0:
            torch._foreach_copy_(ema, p)
        elif alpha != 1.0:
            torch._foreach_mul_(ema, float(alpha))
            torch._foreach_add_(ema, p, alpha=float(np.float32(1.0) - alpha))

    def __call__(self, state: TrainState, mel, text, lens, *, generator=None, draws=None):
        loss, grads = self.grad_step(state.params, mel, text, lens, generator=generator, draws=draws)
        return self.apply_step(state, loss, grads)


def make_train_step(statics, hp: OptHParams, cfg: CFMConfig = CFMConfig(),
                    ema_decay: float = 0.999, ema_update_every: int = 10,
                    ema_update_after_step: int = 100, dtype=torch.bfloat16,
                    backbone: cfm.BackboneDef = cfm.DIT, fuse_qkv: bool = True,
                    mesh=None) -> TrainStep:
    """`mesh` (`parallel.mesh.Mesh`): data / tensor parallel; pass statics
    made with `tp=mesh.tp` and a state from `shard_train_state`."""
    return TrainStep(statics, hp, cfg, ema_decay, ema_update_every, ema_update_after_step, dtype,
                     backbone, fuse_qkv, mesh)
