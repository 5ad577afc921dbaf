"""Checkpoints in torch format (counterpart of f5tts_tpu/train/checkpoint.py).

- CheckpointManager: numbered milestones `model_<step>.pt` in `save_dir`,
  rotated to the newest `keep_last_n` (all kept when < 0), and a separate
  heartbeat `last/model_<step>.pt` that keeps only itself and never evicts a
  milestone (the reference's model_last.pt vs model_<step>.pt). A payload
  holds params, AdamW mu/nu/count, the EMA and the update counter; it is
  written to a temporary file and renamed, so a cut run leaves no torn file.
  Any backbone's tree is saved as it is: the DiT's and MMDiT's "blocks"
  lists (and MMDiT's "last_block" dict), the UNetT's "first_half" /
  "second_half".
- load_params: the (EMA) params of the newest checkpoint across both.
- save_safetensors_ema: the EMA weights of a DiT (the one backbone the JAX
  package exports, as its `_to_reference_keys`) in the reference's state-dict key
  schema, as a safetensors file written by hand (an 8-byte little-endian
  header length, a compact JSON header sorted by key and padded with spaces
  to 8 bytes, then raw little-endian f32), byte-equal to what the
  `safetensors` package writes for the same tensors.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Optional

import numpy as np
import torch

from f5tts_tpu_torch.train.step import TrainState

_NAME = re.compile(r"^model_(\d+)\.pt$")


def _steps(d: str) -> list[int]:
    if not os.path.isdir(d):
        return []
    return sorted(int(mt.group(1)) for f in os.listdir(d) if (mt := _NAME.match(f)))


def _path(d: str, step: int) -> str:
    return os.path.join(d, f"model_{step}.pt")


def state_to_dict(state: TrainState) -> dict:
    return {"step": state.step, "count": state.count, "params": state.params, "mu": state.mu,
            "nu": state.nu, "ema_params": state.ema}


def dict_to_state(d: dict) -> TrainState:
    return TrainState(params=d["params"], mu=d["mu"], nu=d["nu"], count=int(d["count"]),
                      ema=d["ema_params"], step=int(d["step"]))


class CheckpointManager:
    def __init__(self, save_dir: str, keep_last_n: int = -1):
        self.save_dir = os.path.abspath(save_dir)
        self.last_dir = os.path.join(self.save_dir, "last")
        self.keep_last_n = keep_last_n
        os.makedirs(self.save_dir, exist_ok=True)

    def save(self, state: TrainState, step: Optional[int] = None, heartbeat: bool = False) -> str:
        step = state.step if step is None else step
        d = self.last_dir if heartbeat else self.save_dir
        os.makedirs(d, exist_ok=True)
        path = _path(d, step)
        tmp = path + ".tmp"
        torch.save(state_to_dict(state), tmp)
        os.replace(tmp, path)
        keep = 1 if heartbeat else (None if self.keep_last_n < 0 else max(self.keep_last_n, 1))
        if keep is not None:
            for old in _steps(d)[:-keep]:
                os.remove(_path(d, old))
        return path

    def milestones(self) -> list[int]:
        return _steps(self.save_dir)

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.save_dir) + _steps(self.last_dir)
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, device=None) -> Optional[TrainState]:
        """The state at `step` (default: the newest across heartbeat and
        milestones), with its tensors on `device`."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = self.save_dir if step in _steps(self.save_dir) else self.last_dir
        return dict_to_state(torch.load(_path(d, step), map_location=device, weights_only=True))


def load_params(ckpt_dir: str, use_ema: bool = True, step: Optional[int] = None) -> dict:
    """The (EMA) params of a checkpoint dir (the newest when `step` is None),
    on the CPU."""
    state = CheckpointManager(ckpt_dir).restore(step, device="cpu")
    if state is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return state.ema if use_ema else state.params


def to_reference_keys(params: dict, prefix: str = "") -> dict:
    """The port's DiT params -> the reference state-dict key schema (numpy,
    torch layouts: Linear (out, in), Conv1d (out, in/groups, k)), qk-norm's
    per-head weights and the long skip included (the inverse of
    `compat.convert_f5tts_state_dict`). Other backbones raise: the JAX
    package maps only the DiT's keys."""
    if "blocks" not in params or "last_block" in params:
        raise ValueError("the reference-key export covers the DiT only (as the JAX "
                         "_to_reference_keys); this tree is a UNetT or an MMDiT")
    sd: dict[str, np.ndarray] = {}
    t = "transformer"

    def arr(a):
        return a.detach().float().cpu().numpy()

    def lin(p, name):
        sd[f"{name}.weight"] = arr(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = arr(p["b"])

    def conv(p, name):
        sd[f"{name}.weight"] = np.transpose(arr(p["w"]), (2, 1, 0))
        sd[f"{name}.bias"] = arr(p["b"])

    lin(params["time_embed"]["mlp1"], f"{t}.time_embed.time_mlp.0")
    lin(params["time_embed"]["mlp2"], f"{t}.time_embed.time_mlp.2")
    sd[f"{t}.text_embed.text_embed.weight"] = arr(params["text_embed"]["embed"]["w"])
    for i, blk in enumerate(params["text_embed"].get("blocks", [])):
        p = f"{t}.text_embed.text_blocks.{i}"
        conv(blk["dwconv"], f"{p}.dwconv")
        sd[f"{p}.norm.weight"] = arr(blk["norm_w"])
        sd[f"{p}.norm.bias"] = arr(blk["norm_b"])
        lin(blk["pw1"], f"{p}.pwconv1")
        sd[f"{p}.grn.gamma"] = arr(blk["grn"]["gamma"]).reshape(1, 1, -1)
        sd[f"{p}.grn.beta"] = arr(blk["grn"]["beta"]).reshape(1, 1, -1)
        lin(blk["pw2"], f"{p}.pwconv2")
    lin(params["input_embed"]["proj"], f"{t}.input_embed.proj")
    conv(params["input_embed"]["conv_pos"]["conv1"], f"{t}.input_embed.conv_pos_embed.conv1d.0")
    conv(params["input_embed"]["conv_pos"]["conv2"], f"{t}.input_embed.conv_pos_embed.conv1d.2")
    for i, blk in enumerate(params["blocks"]):
        b = f"{t}.transformer_blocks.{i}"
        lin(blk["attn_norm"]["linear"], f"{b}.attn_norm.linear")
        for name in ("to_q", "to_k", "to_v"):
            lin(blk["attn"][name], f"{b}.attn.{name}")
        lin(blk["attn"]["to_out"], f"{b}.attn.to_out.0")
        if "q_norm" in blk["attn"]:
            sd[f"{b}.attn.q_norm.weight"] = arr(blk["attn"]["q_norm"]["w"])
            sd[f"{b}.attn.k_norm.weight"] = arr(blk["attn"]["k_norm"]["w"])
        lin(blk["ff"]["in"], f"{b}.ff.ff.0.0")
        lin(blk["ff"]["out"], f"{b}.ff.ff.2")
    lin(params["norm_out"]["linear"], f"{t}.norm_out.linear")
    lin(params["proj_out"], f"{t}.proj_out")
    if "long_skip" in params:
        sd[f"{t}.long_skip_connection.weight"] = arr(params["long_skip"]["w"]).T
    return {prefix + k: v for k, v in sd.items()}


def write_safetensors_f32(tensors: dict, path: str) -> None:
    """Write {name: array} as a safetensors file of little-endian f32."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name], dtype="<f4")
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        blobs.append(a.tobytes())
        offset += a.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def save_safetensors_ema(params: dict, path: str) -> None:
    """EMA weights in the reference's pruned format: `ema_model.`-prefixed
    reference keys, f32."""
    write_safetensors_f32(to_reference_keys(params, prefix="ema_model."), path)
