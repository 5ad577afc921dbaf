"""Activation checkpointing of the backbones' blocks (counterpart of the
`jax.checkpoint` of f5tts_tpu/models/dit.py:256-261, unett.py:206-212 and
mmdit.py:415-417, with the policies of modules.py:571 remat_policy_for).

`ModelArch.checkpoint_activations` runs each block under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: the forward keeps
the block's inputs and what `ModelArch.remat_policy` names, the backward
recomputes the rest of the block first. The policies (selective
checkpointing, `create_selective_checkpoint_contexts`, over the operators a
block dispatches):
- "nothing": only the block's inputs; the backward replays the whole block,
  its attention forward included.
- "attn_out": the attention's output and its row lse (the outputs of the
  operators `ops.attention.TRAINING_ATTENTION_OPS`): the backward replays
  the norms and projections but no attention forward, since the attention
  backwards (K4, K8, K9) read the saved lse.
- "attn": "attn_out" and the q / k / v projections' products (the
  matmuls run under `tagged("qkv")`, JAX's `checkpoint_name(..., "qkv")`).
- "dots": every matmul's product (`aten.mm` / `addmm` / `bmm` / `baddbmm`),
  not the attention's (its kernels are no matmul operator); the attention
  forward is replayed.
Without grad (`torch.no_grad()`, inference) the block runs as it is. The
recompute runs the same arithmetic, so a checkpointed block's loss and
gradients equal those of the block run straight through. The blocks draw
no random numbers, so no RNG state is saved for the replay.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from f5tts_tpu_torch.ops.attention import TRAINING_ATTENTION_OPS

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_ATTENTION = TRAINING_ATTENTION_OPS
_tag = threading.local()


@contextlib.contextmanager
def tagged(name: str):
    """Name the matmuls run inside (the "attn" policy keeps those of "qkv")."""
    prev = getattr(_tag, "name", None)
    _tag.name = name
    try:
        yield
    finally:
        _tag.name = prev


def _keeps(policy: str, op) -> bool:
    if op in _ATTENTION:
        return policy in ("attn_out", "attn")
    if op in _MATMULS:
        return policy == "dots" or (policy == "attn" and getattr(_tag, "name", None) == "qkv")
    return False


def _policy_fn(policy: str, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if _keeps(policy, op) else CheckpointPolicy.PREFER_RECOMPUTE


def run_block(arch, fn, *args):
    """fn(*args), checkpointed under `arch`'s policy when
    `arch.checkpoint_activations` holds and grad is on."""
    if not (arch.checkpoint_activations and torch.is_grad_enabled()):
        return fn(*args)
    kw = {}
    if arch.remat_policy != "nothing":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             functools.partial(_policy_fn, arch.remat_policy))
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
