"""Reference PyTorch checkpoints into the port's parameter trees
(counterpart of f5tts_tpu/compat/torch_import.py).

The reference's checkpoint formats: `.pt` dicts with `ema_model_state_dict`
(keys "ema_model.<name>") or `model_state_dict`, `.safetensors` EMA exports,
and charactr/vocos-mel-24khz's `pytorch_model.bin`. The converters return
the port's layouts directly, as `convert.*_params_from_jax` returns them
from the JAX importer's trees: torch f32 tensors on the CPU, block stacks as
Python lists of per-block dicts, and
- torch Linear weight (out, in) -> (in, out);
- torch Conv1d weight (out, in/groups, k) -> (k, in/groups, out) (WIO);
- GRN gamma / beta (1, 1, d) -> (d,).
State dict values may be torch tensors (any float dtype) or anything
`np.asarray` takes.

`load_torch_checkpoint` reads `.safetensors` by hand (an 8-byte
little-endian header length, a JSON header, then raw little-endian
buffers; F64 / F32 / F16 / BF16 and the integer types), so the
`safetensors` package is not needed, and `.pt` / `.pth` / `.bin` through
`torch.load(weights_only=True)`. Both go through `extract_ema_state_dict`,
as the reference's `load_checkpoint` strips the "ema_model." prefix of a
safetensors export (the JAX package hands such a file's keys to the
converters with their prefix).
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch

from f5tts_tpu_torch.config import ModelArch


def _t(x) -> torch.Tensor:
    """An f32 CPU tensor of its own (a copy) from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32, copy=True).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _lin(sd: Mapping, name: str, bias: bool = True) -> dict:
    p = {"w": _t(sd[f"{name}.weight"]).T.contiguous()}
    if bias and f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _conv(sd: Mapping, name: str) -> dict:
    return {"w": _t(sd[f"{name}.weight"]).permute(2, 1, 0).contiguous(),
            "b": _t(sd[f"{name}.bias"])}


def _convnext_v2(sd: Mapping, prefix: str) -> dict:
    return {
        "dwconv": _conv(sd, f"{prefix}.dwconv"),
        "norm_w": _t(sd[f"{prefix}.norm.weight"]),
        "norm_b": _t(sd[f"{prefix}.norm.bias"]),
        "pw1": _lin(sd, f"{prefix}.pwconv1"),
        "grn": {"gamma": _t(sd[f"{prefix}.grn.gamma"]).reshape(-1),
                "beta": _t(sd[f"{prefix}.grn.beta"]).reshape(-1)},
        "pw2": _lin(sd, f"{prefix}.pwconv2"),
    }


def _qk_norm(sd: Mapping, attn: str, out: dict) -> None:
    """The per-head RMSNorm weights of a qk-norm attention, where present."""
    if f"{attn}.q_norm.weight" in sd:
        out["q_norm"] = {"w": _t(sd[f"{attn}.q_norm.weight"])}
        out["k_norm"] = {"w": _t(sd[f"{attn}.k_norm.weight"])}


def extract_ema_state_dict(checkpoint: Mapping) -> dict:
    """The model weights of a reference checkpoint (utils_infer.py:209-227):
    the EMA dict without its "ema_model." prefix and bookkeeping
    ("initted", "step"), else `model_state_dict`, else the dict itself with
    the prefix stripped."""
    if "ema_model_state_dict" in checkpoint:
        sd = checkpoint["ema_model_state_dict"]
        return {k.removeprefix("ema_model."): v for k, v in sd.items()
                if k not in ("initted", "step", "ema_model.initted", "ema_model.step")}
    if "model_state_dict" in checkpoint:
        return dict(checkpoint["model_state_dict"])
    return {k.removeprefix("ema_model."): v for k, v in checkpoint.items()
            if k not in ("initted", "step")}


# safetensors dtype names -> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> dict:
    """{name: tensor} of a safetensors file, each in its stored dtype (CPU)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                             f"does not take ({sorted(_ST_DTYPES)})")
        begin, end = info["data_offsets"]
        buf = bytearray(data[begin:end])  # a writable copy for frombuffer
        t = (torch.frombuffer(buf, dtype=_ST_DTYPES[info["dtype"]]) if buf
             else torch.empty(0, dtype=_ST_DTYPES[info["dtype"]]))
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(tensors: Mapping, path: str) -> None:
    """Write {name: tensor} as a safetensors file, each tensor in its own
    dtype (`read_safetensors`' inverse)."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def load_torch_checkpoint(path: str) -> dict:
    """A reference checkpoint (.safetensors, or .pt / .pth / .bin) as a flat
    state dict through `extract_ema_state_dict`, its float tensors in f32 on
    the CPU."""
    if path.endswith(".safetensors"):
        ckpt = read_safetensors(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
            for k, v in extract_ema_state_dict(ckpt).items()}


def convert_f5tts_state_dict(sd: Mapping, arch: ModelArch) -> dict:
    """Reference CFM / DiT state dict ("transformer.<...>" keys; mel_spec
    buffers ignored) -> the port's DiT params."""
    t = "transformer"
    params: dict = {
        "time_embed": {"mlp1": _lin(sd, f"{t}.time_embed.time_mlp.0"),
                       "mlp2": _lin(sd, f"{t}.time_embed.time_mlp.2")},
        "text_embed": {"embed": {"w": _t(sd[f"{t}.text_embed.text_embed.weight"])}},
        "input_embed": {
            "proj": _lin(sd, f"{t}.input_embed.proj"),
            "conv_pos": {"conv1": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.0"),
                         "conv2": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.2")},
        },
        "norm_out": {"linear": _lin(sd, f"{t}.norm_out.linear")},
        "proj_out": _lin(sd, f"{t}.proj_out"),
    }
    if arch.conv_layers > 0:
        params["text_embed"]["blocks"] = [_convnext_v2(sd, f"{t}.text_embed.text_blocks.{i}")
                                          for i in range(arch.conv_layers)]
    blocks = []
    for i in range(arch.depth):
        b = f"{t}.transformer_blocks.{i}"
        attn = {"to_q": _lin(sd, f"{b}.attn.to_q"), "to_k": _lin(sd, f"{b}.attn.to_k"),
                "to_v": _lin(sd, f"{b}.attn.to_v"), "to_out": _lin(sd, f"{b}.attn.to_out.0")}
        _qk_norm(sd, f"{b}.attn", attn)
        blocks.append({"attn_norm": {"linear": _lin(sd, f"{b}.attn_norm.linear")},
                       "attn": attn,
                       "ff": {"in": _lin(sd, f"{b}.ff.ff.0.0"), "out": _lin(sd, f"{b}.ff.ff.2")}})
    params["blocks"] = blocks
    # the arch, not the key, decides: a long-skip weight under an arch without
    # the flag stays unread, and the audit reports it
    if arch.long_skip_connection:
        params["long_skip"] = _lin(sd, f"{t}.long_skip_connection", bias=False)
    return params


def convert_unett_state_dict(sd: Mapping, arch: ModelArch) -> dict:
    """Reference CFM / UNetT (E2-TTS) state dict -> the port's UNetT params.
    The reference's `layers` are ModuleLists [skip_proj (0), attn_norm (1),
    attn (2), ff_norm (3), ff (4)], skip_proj only in the later half under
    "concat"; norm_out is an RMSNorm."""
    t = "transformer"
    params: dict = {
        "time_embed": {"mlp1": _lin(sd, f"{t}.time_embed.time_mlp.0"),
                       "mlp2": _lin(sd, f"{t}.time_embed.time_mlp.2")},
        "text_embed": {"embed": {"w": _t(sd[f"{t}.text_embed.text_embed.weight"])}},
        "input_embed": {
            "proj": _lin(sd, f"{t}.input_embed.proj"),
            "conv_pos": {"conv1": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.0"),
                         "conv2": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.2")},
        },
        "norm_out": {"w": _t(sd[f"{t}.norm_out.weight"])},
        "proj_out": _lin(sd, f"{t}.proj_out"),
    }
    if arch.conv_layers > 0:
        params["text_embed"]["blocks"] = [_convnext_v2(sd, f"{t}.text_embed.text_blocks.{i}")
                                          for i in range(arch.conv_layers)]

    def block(i: int, later_half: bool) -> dict:
        b = f"{t}.layers.{i}"
        attn = {"to_q": _lin(sd, f"{b}.2.to_q"), "to_k": _lin(sd, f"{b}.2.to_k"),
                "to_v": _lin(sd, f"{b}.2.to_v"), "to_out": _lin(sd, f"{b}.2.to_out.0")}
        _qk_norm(sd, f"{b}.2", attn)
        blk = {"attn_norm": {"w": _t(sd[f"{b}.1.weight"])}, "attn": attn,
               "ff_norm": {"w": _t(sd[f"{b}.3.weight"])},
               "ff": {"in": _lin(sd, f"{b}.4.ff.0.0"), "out": _lin(sd, f"{b}.4.ff.2")}}
        if later_half and arch.skip_connect_type == "concat":
            blk["skip_proj"] = _lin(sd, f"{b}.0", bias=False)
        return blk

    half = arch.depth // 2
    params["first_half"] = [block(i, False) for i in range(half)]
    params["second_half"] = [block(half + i, True) for i in range(half)]
    return params


def convert_backbone_state_dict(sd: Mapping, arch: ModelArch, backbone: str = "DiT") -> dict:
    """The converter of `backbone`; the reference publishes no MMDiT checkpoint."""
    if backbone == "DiT":
        return convert_f5tts_state_dict(sd, arch)
    if backbone == "UNetT":
        return convert_unett_state_dict(sd, arch)
    raise NotImplementedError(
        f"no torch-checkpoint converter for backbone {backbone!r} "
        "(the reference publishes DiT (F5-TTS) and UNetT (E2-TTS) checkpoints only)")


# keys a reference checkpoint carries that the converted model never reads:
# the mel_spec STFT buffers, the rotary frequency parameter (the port builds
# its RoPE tables) and the EMA bookkeeping scalars
_IGNORED_CKPT_KEYS = ("mel_spec.", "rotary_embed.freqs", "freqs_cis", "initted", "step")


class _TrackedStateDict(Mapping):
    """A read-through view of a state dict that records the keys read."""

    def __init__(self, sd: Mapping):
        self._sd = sd
        self.consumed: set = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return self._sd[k]

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)


def convert_backbone_state_dict_audited(sd: Mapping, arch: ModelArch,
                                        backbone: str = "DiT") -> tuple[dict, list[str]]:
    """(params, the weight keys the converter did not read and no ignorable
    pattern covers): a non-empty list means weights were dropped."""
    tracked = _TrackedStateDict(sd)
    params = convert_backbone_state_dict(tracked, arch, backbone)
    unconsumed = [k for k in sd if k not in tracked.consumed
                  and not any(pat in k for pat in _IGNORED_CKPT_KEYS)]
    return params, unconsumed


def convert_vocos_state_dict(sd: Mapping, num_layers: int = 8) -> dict:
    """charactr/vocos-mel-24khz state dict -> the port's Vocos params."""
    blocks = []
    for i in range(num_layers):
        p = f"backbone.convnext.{i}"
        blocks.append({"dwconv": _conv(sd, f"{p}.dwconv"), "norm_w": _t(sd[f"{p}.norm.weight"]),
                       "norm_b": _t(sd[f"{p}.norm.bias"]), "pw1": _lin(sd, f"{p}.pwconv1"),
                       "pw2": _lin(sd, f"{p}.pwconv2"),
                       "gamma": _t(sd[f"{p}.gamma"]).reshape(-1)})
    return {
        "embed": _conv(sd, "backbone.embed"),
        "in_norm_w": _t(sd["backbone.norm.weight"]),
        "in_norm_b": _t(sd["backbone.norm.bias"]),
        "blocks": blocks,
        "final_norm_w": _t(sd["backbone.final_layer_norm.weight"]),
        "final_norm_b": _t(sd["backbone.final_layer_norm.bias"]),
        "head": _lin(sd, "head.out"),
    }


def to_vocos_reference_keys(params: dict) -> dict:
    """The port's Vocos params -> charactr/vocos-mel-24khz keys and layouts
    (f32 CPU tensors): the inverse of `convert_vocos_state_dict`."""
    sd: dict[str, torch.Tensor] = {}

    def lin(name, p):
        sd[f"{name}.weight"] = _t(p["w"]).T.contiguous()
        sd[f"{name}.bias"] = _t(p["b"])

    def conv(name, p):
        sd[f"{name}.weight"] = _t(p["w"]).permute(2, 1, 0).contiguous()
        sd[f"{name}.bias"] = _t(p["b"])

    conv("backbone.embed", params["embed"])
    sd["backbone.norm.weight"], sd["backbone.norm.bias"] = (_t(params["in_norm_w"]),
                                                            _t(params["in_norm_b"]))
    for i, blk in enumerate(params["blocks"]):
        p = f"backbone.convnext.{i}"
        conv(f"{p}.dwconv", blk["dwconv"])
        sd[f"{p}.norm.weight"], sd[f"{p}.norm.bias"] = _t(blk["norm_w"]), _t(blk["norm_b"])
        lin(f"{p}.pwconv1", blk["pw1"])
        lin(f"{p}.pwconv2", blk["pw2"])
        sd[f"{p}.gamma"] = _t(blk["gamma"])
    sd["backbone.final_layer_norm.weight"] = _t(params["final_norm_w"])
    sd["backbone.final_layer_norm.bias"] = _t(params["final_norm_b"])
    lin("head.out", params["head"])
    return sd
