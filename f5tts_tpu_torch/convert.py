"""Weights from the JAX package into the port.

`dit_params_from_jax`, `unett_params_from_jax`, `mmdit_params_from_jax`,
`vocos_params_from_jax` and `bigvgan_params_from_jax` take the JAX
package's parameter pytree as numpy arrays (nested dicts and lists; blocks
stacked on a leading depth axis: "blocks" of the DiT, MMDiT and Vocos,
"first_half" / "second_half" of the UNetT; BigVGAN's stages unstacked;
attention fused (`to_qkv`, `to_qkv_c`) or not, with qk-norm's
`q_norm` / `k_norm` / `c_q_norm` / `c_k_norm` leaves or without) and return
the port's parameters as CPU f32 tensors. The walk is generic: every leaf of
the JAX tree comes across under its own key.
`train_state_from_jax` takes a JAX `TrainState` with numpy leaves (params,
the optax AdamW mu / nu / count, the EMA and the step) of any backbone
("DiT", "UNetT", "MMDiT") and returns the port's `TrainState`, so both sides
can take an optimizer step from one state.

Layouts. The port keeps the JAX package's layouts, so no tensor is
transposed: Linear weights stay (in, out) and are applied as `x @ w + b`;
Conv1d weights stay (k, in/groups, out) (WIO), which is also the layout the
conv-position kernel K2 reads. The one change of structure: the stacked
[depth, ...] block arrays become a Python list of per-block dicts (MMDiT's
unstacked "last_block" stays one dict).
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return _tensor(tree)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.asarray(tree).shape[0])


def _params_from_jax(tree: dict, stacked: tuple) -> dict:
    out = {k: _to_torch(v) for k, v in tree.items() if k not in stacked}
    for k in stacked:
        out[k] = [_to_torch(_unstack(tree[k], i)) for i in range(_depth(tree[k]))]
    return out


def dit_params_from_jax(tree: dict) -> dict:
    """JAX DiT params (numpy leaves) -> the port's DiT params."""
    return _params_from_jax(tree, ("blocks",))


def unett_params_from_jax(tree: dict) -> dict:
    """JAX UNetT params (numpy leaves) -> the port's UNetT params."""
    return _params_from_jax(tree, ("first_half", "second_half"))


def mmdit_params_from_jax(tree: dict) -> dict:
    """JAX MMDiT params (numpy leaves) -> the port's MMDiT params."""
    return _params_from_jax(tree, ("blocks",))


def vocos_params_from_jax(tree: dict) -> dict:
    """JAX Vocos params (numpy leaves) -> the port's Vocos params."""
    return dit_params_from_jax(tree)


def bigvgan_params_from_jax(tree: dict) -> dict:
    """JAX BigVGAN params (numpy leaves; lists of per-stage and per-block
    dicts, nothing stacked) -> the port's BigVGAN params."""
    return _to_torch(tree)


def _find_states(node, found: list) -> list:
    """The optax states (namedtuples with a `count`) inside an opt_state."""
    if hasattr(node, "_fields"):
        if "count" in node._fields:
            found.append(node)
        for child in node:
            _find_states(child, found)
    elif isinstance(node, (tuple, list)):
        for child in node:
            _find_states(child, found)
    return found


PARAMS_FROM_JAX = {"DiT": dit_params_from_jax, "UNetT": unett_params_from_jax,
                   "MMDiT": mmdit_params_from_jax}


def train_state_from_jax(state, backbone: str = "DiT"):
    """JAX TrainState (numpy leaves; the optax chain clip + adamw) of the
    `backbone`'s tree -> the port's TrainState on the CPU."""
    from f5tts_tpu_torch.train.step import TrainState

    to_port = PARAMS_FROM_JAX[backbone]
    counts = _find_states(state.opt_state, [])
    adam = [s for s in counts if "mu" in s._fields]
    if len(adam) != 1:
        raise ValueError("train_state_from_jax expects one AdamW (ScaleByAdamState) in opt_state")
    count = int(np.asarray(adam[0].count))
    if any(int(np.asarray(s.count)) != count for s in counts):
        raise ValueError("the schedule count and the AdamW count differ")
    return TrainState(params=to_port(state.params), mu=to_port(adam[0].mu),
                      nu=to_port(adam[0].nu), count=count, ema=to_port(state.ema_params),
                      step=int(np.asarray(state.step)))
