"""BigVGAN v2 generator: log-mel [b, 100, t] -> wav [b, t * 256].

Counterpart of f5tts_tpu/vocoder/bigvgan.py:34-350, the
nvidia/bigvgan_v2_24khz_100band_256x generator: conv_pre (100 -> 1536,
k 7) -> 6 x [ConvTranspose1d upsample (rates 4, 4, 2, 2, 2, 2; kernels
8, 8, 4, 4, 4, 4) -> 3 AMP blocks (kernels 3, 7, 11; dilations 1, 3, 5),
averaged] -> anti-aliased snakebeta -> conv_post (k 7, no bias) -> clamp
to [-1, 1]. Every activation is anti-aliased: a 2x kaiser-sinc upsample
(a depthwise `F.conv_transpose1d` on an edge-padded input), snakebeta
x + 1 / (exp(beta) + eps) * sin^2(exp(alpha) x), a 2x kaiser-sinc
downsample (a depthwise strided `F.conv1d`). No Pallas kernel computes
any of this, so the convolutions go to PyTorch (cuDNN on the card). It
runs in f32, as the reference forces, with TF32 off whatever the caller's
flags (`precision.full_f32`).

Parameters keep the JAX package's tree: conv weights [out, in, k],
transposed-conv weights [in, out, k] (PyTorch's own layouts), per-channel
snake alpha / beta in log scale. `convert_bigvgan_state_dict` folds the
weight norm of a reference-key generator state dict into that tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.precision import f32_call
from f5tts_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 100
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False
    # the snake parameters are always in log scale (the v2 checkpoints'
    # snake_logscale = True); there is no linear-scale variant


# ---------------------------------------------------------------------------
# Anti-aliasing filters and the snake activation
# ---------------------------------------------------------------------------

def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass filter (the alias-free-torch formula)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = (np.arange(-half_size, half_size) + 0.5) if even else np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (f / f.sum()).astype(np.float32)


def resample_filter(ratio: int = 2) -> np.ndarray:
    """The 2x up- and downsampling filter (both are the same, 12 taps)."""
    return kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, int(6 * ratio // 2) * 2)


def _depthwise(filt: torch.Tensor, c: int) -> torch.Tensor:
    return filt.to(torch.float32)[None, None, :].expand(c, 1, filt.shape[0]).contiguous()


def upsample1d_2x(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """[b, c, t] -> [b, c, 2t]: edge pad, depthwise transposed conv (stride
    2), times 2, trimmed."""
    c, ks, ratio = x.shape[1], filt.shape[0], 2
    pad = ks // ratio - 1
    pad_left = pad * ratio + (ks - ratio) // 2
    pad_right = pad * ratio + (ks - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, _depthwise(filt, c), stride=ratio, groups=c)
    return y[:, :, pad_left:y.shape[2] - pad_right]


def downsample1d_2x(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """[b, c, t] -> [b, c, t // 2]: edge pad, depthwise strided conv."""
    c, ks = x.shape[1], filt.shape[0]
    half = ks // 2
    x = F.pad(x, (half - int(ks % 2 == 0), half), mode="replicate")
    return F.conv1d(x, _depthwise(filt, c), stride=2, groups=c)


def snakebeta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-9) -> torch.Tensor:
    """x + 1 / (exp(beta) + eps) * sin^2(exp(alpha) x), per-channel alpha /
    beta [c] in log scale."""
    a, b = torch.exp(alpha)[None, :, None], torch.exp(beta)[None, :, None]
    return x + (1.0 / (b + eps)) * torch.sin(a * x) ** 2


def aa_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
             filt: torch.Tensor) -> torch.Tensor:
    """Anti-aliased snakebeta: up 2x, snakebeta, down 2x."""
    return downsample1d_2x(snakebeta(upsample1d_2x(x, filt), alpha, beta), filt)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, c_in: int, c_out: int, k: int,
               transposed: bool = False) -> m.Params:
    """PyTorch's default bounds: 1 / sqrt(fan_in); a transposed conv's
    weight is [in, out, k] and its fan_in out * k."""
    bound = 1.0 / math.sqrt((c_out if transposed else c_in) * k)
    shape = (c_in, c_out, k) if transposed else (c_out, c_in, k)
    return {"w": m._uniform(gen, shape, bound), "b": m._uniform(gen, (c_out,), bound)}


def init_bigvgan(generator: torch.Generator, cfg: BigVGANConfig = BigVGANConfig()) -> m.Params:
    """Random weights in the JAX package's tree (snake parameters 0 in log
    scale, i.e. alpha = beta = 1)."""
    g, ch = generator, cfg.upsample_initial_channel
    p: m.Params = {"conv_pre": _conv_init(g, cfg.num_mels, ch, 7), "ups": [], "resblocks": []}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        p["ups"].append(_conv_init(g, c_in, c_out, k, transposed=True))
        for kr, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            blk = {"convs1": [], "convs2": []}
            for _ in dils:
                blk["convs1"].append(_conv_init(g, c_out, c_out, kr))
                blk["convs2"].append(_conv_init(g, c_out, c_out, kr))
            for name in ("alpha1", "beta1", "alpha2", "beta2"):
                blk[name] = [torch.zeros(c_out) for _ in dils]
            p["resblocks"].append(blk)
    c_final = ch // 2 ** len(cfg.upsample_rates)
    p["activation_post"] = {"alpha": torch.zeros(c_final), "beta": torch.zeros(c_final)}
    post = _conv_init(g, c_final, 1, 7)
    if not cfg.use_bias_at_final:
        post.pop("b")
    p["conv_post"] = post
    return p


def _conv1d(p: m.Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    k = p["w"].shape[2]
    return F.conv1d(x, p["w"], p.get("b"), padding=dilation * (k - 1) // 2, dilation=dilation)


def _amp_block(blk: m.Params, x: torch.Tensor, dils, filt: torch.Tensor) -> torch.Tensor:
    for i, d in enumerate(dils):
        h = aa_snake(x, blk["alpha1"][i], blk["beta1"][i], filt)
        h = _conv1d(blk["convs1"][i], h, dilation=d)
        h = aa_snake(h, blk["alpha2"][i], blk["beta2"][i], filt)
        x = x + _conv1d(blk["convs2"][i], h)
    return x


@f32_call
def bigvgan_apply(params: m.Params, mel: torch.Tensor, filt: torch.Tensor,
                  cfg: BigVGANConfig = BigVGANConfig()) -> torch.Tensor:
    """log-mel [b, n_mels, t] -> wav [b, t * prod(upsample_rates)] in f32."""
    x = _conv1d(params["conv_pre"], mel.float())
    n_res = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = params["ups"][i]
        x = F.conv_transpose1d(x, up["w"], up["b"], stride=u, padding=(k - u) // 2)
        acc = None
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            h = _amp_block(params["resblocks"][i * n_res + j], x, dils, filt)
            acc = h if acc is None else acc + h
        x = acc / n_res
    post = params["activation_post"]
    x = _conv1d(params["conv_post"], aa_snake(x, post["alpha"], post["beta"], filt))
    x = torch.tanh(x) if cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
    return x[:, 0, :]


class BigVGAN:
    """Callable vocoder on `device`: log-mel [b, n_mels, t] -> wav
    [b, t * 256], in f32. For a mel on `device` a call does no host work,
    so the pipeline's CUDA graph captures it."""

    def __init__(self, params: m.Params, cfg: BigVGANConfig = BigVGANConfig(), device=None):
        self.device = resolve_device(device)
        self.params = m.tree_cast(params, torch.float32, self.device)
        self.cfg = cfg
        self.filt = torch.from_numpy(resample_filter()).to(self.device)

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        return bigvgan_apply(self.params, mel.to(self.device), self.filt, self.cfg)


# ---------------------------------------------------------------------------
# A reference-key generator state dict (weight-normed) -> the port's tree
# ---------------------------------------------------------------------------

def _fold_weight_norm(sd: dict, name: str) -> np.ndarray:
    """weight_g * weight_v / ||weight_v|| over axes 1, 2, or the plain weight."""
    if f"{name}.weight" in sd:
        return np.asarray(sd[f"{name}.weight"], np.float32)
    g = np.asarray(sd[f"{name}.weight_g"], np.float32)
    v = np.asarray(sd[f"{name}.weight_v"], np.float32)
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def convert_bigvgan_state_dict(sd: dict, cfg: BigVGANConfig = BigVGANConfig()) -> m.Params:
    """The generator's state dict (reference keys: conv_pre, ups.{i}.0,
    resblocks.{m}.convs1 / convs2.{i}, resblocks.{m}.activations.{j}.act,
    activation_post.act, conv_post; numpy or tensor values) -> the port's
    params (CPU f32 tensors), the weight norm folded."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    def conv(name, bias=True):
        p = {"w": t(_fold_weight_norm(sd, name))}
        if bias and f"{name}.bias" in sd:
            p["b"] = t(np.asarray(sd[f"{name}.bias"], np.float32))
        return p

    def act(name):
        return t(np.asarray(sd[name], np.float32).reshape(-1))

    n_res = len(cfg.resblock_kernel_sizes)
    resblocks = []
    for r in range(len(cfg.upsample_rates) * n_res):
        pre = f"resblocks.{r}"
        dils = range(len(cfg.resblock_dilation_sizes[r % n_res]))
        resblocks.append({
            "convs1": [conv(f"{pre}.convs1.{i}") for i in dils],
            "convs2": [conv(f"{pre}.convs2.{i}") for i in dils],
            "alpha1": [act(f"{pre}.activations.{2 * i}.act.alpha") for i in dils],
            "beta1": [act(f"{pre}.activations.{2 * i}.act.beta") for i in dils],
            "alpha2": [act(f"{pre}.activations.{2 * i + 1}.act.alpha") for i in dils],
            "beta2": [act(f"{pre}.activations.{2 * i + 1}.act.beta") for i in dils]})
    return {"conv_pre": conv("conv_pre"),
            "ups": [conv(f"ups.{i}.0") for i in range(len(cfg.upsample_rates))],
            "resblocks": resblocks,
            "activation_post": {"alpha": act("activation_post.act.alpha"),
                                "beta": act("activation_post.act.beta")},
            "conv_post": conv("conv_post", bias=cfg.use_bias_at_final)}
