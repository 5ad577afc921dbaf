"""Flow matching: the training loss and the sampler (counterpart of
f5tts_tpu/models/cfm.py:111-364).

`cfm_loss` is the masked-infilling CFM regression through any backbone of
`BACKBONES` (its `forward`, as JAX cfm.py:111-162 runs `BackboneDef.forward`):
a random span (fraction 0.7-1.0 of each length) is cut out of the mel and
predicted from noise,
x0 ~ N(0, I), t ~ U[0, 1], phi = (1 - t) x0 + t x1, target flow = x1 - x0,
with per-sample CFG dropout (audio 0.3; both 0.2, which also drops the
audio), then the MSE over the span. Its random draws come from a
`torch.Generator` or are passed in (`CFMDraws`): the JAX PRNG and torch's
differ, so a test passes the JAX draws.

`cfm_sample` runs the Euler or midpoint ODE over a precomputed time grid
(EPSS + sway) with CFG: cond and uncond rows go through the backbone as
one 2b batch and combine as pred + (pred - null) * cfg. Text embeddings
and every evaluation's AdaLN modulation (DiT, MMDiT; the UNetT's time
rides the sequence as a token) are computed once, before the step loop.
The prompt frames, or with an `edit_mask` the frames it keeps, are
re-imposed on the result. `duplicate_test_start` restarts a trajectory
from a ground-truth mel at t_inter. `BACKBONES` describes each backbone as
the JAX package's `BackboneDef` table does (cfm.py:37-103).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from f5tts_tpu_torch.config import CFMConfig
from f5tts_tpu_torch.models import dit, mmdit, unett
from f5tts_tpu_torch.utils import (lens_to_mask, linspace_f32, mask_from_frac_lengths,
                                   sway_timesteps)


class BackboneDef(NamedTuple):
    """What the sampler and the pipeline need of a backbone."""

    name: str
    init: Callable          # (generator, arch) -> params
    statics_cls: type       # (arch, device) -> constant tables
    forward: Callable       # (params, statics, x, cond, text, time, ...) -> flow
    text_embeds: Callable   # (params, statics, text, n, lengths, dtype) -> (cond, uncond)
    # (params, t_values [S], batch, dtype) -> at(i), step i's AdaLN mods;
    # None for a backbone without AdaLN (the UNetT's time token)
    precompute_mods: Optional[Callable] = None
    # sequence tokens the backbone prepends to the mel frames (the UNetT's
    # time token); `duration_bucket` keeps frames + these a bucket multiple
    seq_extra_tokens: int = 0


def _dit_text_embeds(params, statics, text, n, lengths, dtype):
    return tuple(dit.text_embedding(params["text_embed"], statics, text, n, lengths=lengths,
                                    drop_text=drop, dtype=dtype) for drop in (False, True))


def _unett_text_embeds(params, statics, text, n, lengths, dtype):
    return unett.unett_text_embeds(params, statics, text, n, dtype)  # no per-sample length


def _mmdit_text_embeds(params, statics, text, n, lengths, dtype):
    return mmdit.mmdit_text_embeds(params, statics, text, dtype)  # the text's own length


def _dit_mods(params, t_values, batch, dtype):
    block_mods, final_mods = dit.precompute_t_mods(params, t_values, batch, dtype)
    return lambda i: (block_mods[:, i], final_mods[i])


BACKBONES: dict[str, BackboneDef] = {
    "DiT": BackboneDef("DiT", dit.init_dit, dit.DiTStatics, dit.dit_forward,
                       _dit_text_embeds, _dit_mods),
    "UNetT": BackboneDef("UNetT", unett.init_unett, unett.UNetTStatics, unett.unett_forward,
                         _unett_text_embeds, seq_extra_tokens=1),
    "MMDiT": BackboneDef("MMDiT", mmdit.init_mmdit, mmdit.MMDiTStatics, mmdit.mmdit_forward,
                         _mmdit_text_embeds, mmdit.mmdit_precompute_t_mods),
}
DIT = BACKBONES["DiT"]


class CFMDraws(NamedTuple):
    """The random inputs of one `cfm_loss` call (JAX cfm.py:125-150)."""

    frac: torch.Tensor        # [b] span fraction, U[frac_lengths_mask)
    start: torch.Tensor       # [b] U[0, 1): where the span starts
    x0: torch.Tensor          # [b, n, d] N(0, 1) noise
    time: torch.Tensor        # [b] U[0, 1) flow time
    drop_audio: torch.Tensor  # [b] U[0, 1), < audio_drop_prob drops the audio cond
    drop_both: torch.Tensor   # [b] U[0, 1), < cond_drop_prob drops audio and text


def make_draws(generator: torch.Generator, b: int, n: int, d: int,
               cfg: CFMConfig = CFMConfig()) -> CFMDraws:
    """Draw a `CFMDraws` from `generator`, on the generator's device."""
    def u(shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    lo, hi = cfg.frac_lengths_mask
    return CFMDraws(frac=u((b,)) * (hi - lo) + lo, start=u((b,)),
                    x0=torch.randn((b, n, d), generator=generator, device=generator.device),
                    time=u((b,)), drop_audio=u((b,)), drop_both=u((b,)))


def cfm_loss(params, statics, mel: torch.Tensor, text: torch.Tensor, lens: torch.Tensor,
             cfg: CFMConfig = CFMConfig(), dtype=torch.bfloat16, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[CFMDraws] = None,
             backbone: BackboneDef = DIT, dp_group=None) -> tuple[torch.Tensor, dict]:
    """(scalar f32 loss, aux) for target mel [b, n, d] (x1), text [b, nt] ids
    (-1 padded), lens [b] valid frames, through `backbone` (`statics` are
    its `statics_cls`'s). `params` hold the fused to_qkv
    (`fuse_backbone_qkv`: the flat attention kernels) or the unfused to_q /
    to_k / to_v (the head layout). Pass `draws` or a `generator`.

    With `dp_group` (data parallelism: this rank's rows of a global batch)
    the span count is all-reduced over the group before the division, so
    the ranks' losses (and gradients) SUM to the global batch's span-weighted
    mean, as JAX's one mean over the sharded batch; averaging per-rank means
    would weigh a row by its rank's span count."""
    b, n, d = mel.shape
    if draws is None:
        if generator is None:
            raise ValueError("cfm_loss needs a generator or draws")
        draws = make_draws(generator, b, n, d, cfg)
    draws = CFMDraws(*(t.to(mel.device) for t in draws))
    mask = lens_to_mask(lens, n)
    span = mask_from_frac_lengths(lens, draws.frac, draws.start, n) & mask

    x1 = mel.float()
    x0 = draws.x0.float()
    t = draws.time.float()[:, None, None]
    phi = (1.0 - t) * x0 + t * x1
    flow = x1 - x0
    cond = torch.where(span[:, :, None], 0.0, x1)

    drop_both = draws.drop_both < cfg.cond_drop_prob
    drop_audio = (draws.drop_audio < cfg.audio_drop_prob) | drop_both
    pred = backbone.forward(params, statics, phi, cond, text, draws.time.float(), lengths=lens,
                            drop_audio_cond=drop_audio, drop_text=drop_both, dtype=dtype)

    se = (pred.float() - flow) ** 2
    spanf = span[:, :, None].float()
    count = spanf.sum()
    if dp_group is not None:
        from f5tts_tpu_torch.parallel.collectives import all_reduce_sum

        count = all_reduce_sum(count, dp_group)
    loss = (se * spanf).sum() / torch.clamp(count * d, min=1.0)
    return loss, {"pred": pred, "cond": cond, "rand_span_mask": span}


def make_noise(generator: torch.Generator, batch: int, seq_len: int, num_channels: int,
               duration: torch.Tensor, noise_max_len: Optional[int] = None) -> torch.Tensor:
    """Sampling noise y0 [batch, seq_len, c] f32 on duration's device: ONE
    panel shared by every row, drawn at `noise_max_len` rows and cut to
    seq_len (the same seed gives the same audio in any bucket), rows >=
    duration zeroed. Drawn from `generator`, on the generator's device."""
    gen_len = max(noise_max_len or seq_len, seq_len)
    panel = torch.randn((gen_len, num_channels), generator=generator,
                        device=generator.device, dtype=torch.float32)[:seq_len]
    noise = panel.to(duration.device)[None].expand(batch, seq_len, num_channels)
    valid = lens_to_mask(duration, seq_len)
    return torch.where(valid[:, :, None], noise, 0.0)


def sample_ode(params, statics, y0: torch.Tensor, step_cond: torch.Tensor,
               text: torch.Tensor, duration: torch.Tensor, t_grid: torch.Tensor,
               cfg: torch.Tensor, dtype=torch.bfloat16, backbone: BackboneDef = DIT,
               method: str = "euler") -> torch.Tensor:
    """Euler or midpoint steps with CFG over `t_grid` [steps+1]; x stays
    f32. `cfg` is the guidance strength as an f32 scalar tensor on y0's
    device: no host value enters the loop, so a CUDA graph can capture it.
    Midpoint evaluates the flow at t and t + dt/2 (two backbone passes a
    step); its modulations are precomputed at both, the second pass of step
    i reading index steps + i, in the JAX package's f32 order."""
    if method not in ("euler", "midpoint"):
        raise ValueError(f"unknown ODE method {method!r} (euler | midpoint)")
    b, n, _ = y0.shape
    steps = t_grid.shape[0] - 1
    text_embeds = backbone.text_embeds(params, statics, text, n, duration, dtype)
    dts = t_grid[1:] - t_grid[:-1]
    t_values = t_grid[:steps]
    if method == "midpoint":  # the second pass of step i at index steps + i
        half = t_grid[:steps] + 0.5 * dts
        t_values = torch.cat([t_values, half])
    mods_at = (backbone.precompute_mods(params, t_values, 2 * b, dtype)
               if backbone.precompute_mods is not None else None)

    def flow(x, t, idx):
        kw = {"t_mods": mods_at(idx)} if mods_at is not None else {}
        pred_cfg = backbone.forward(
            params, statics, x, step_cond, text, t, lengths=duration,
            cfg_infer=True, text_embeds=text_embeds, dtype=dtype, **kw)
        pred, null_pred = pred_cfg.chunk(2, dim=0)
        return pred + (pred - null_pred) * cfg

    x = y0
    for i in range(steps):
        v = flow(x, t_grid[i], i)
        if method == "midpoint":
            v = flow(x + 0.5 * dts[i] * v, half[i], steps + i)
        x = x + dts[i] * v
    return x


@torch.no_grad()
def cfm_sample(params, statics, cond: torch.Tensor, text: torch.Tensor,
               lens: torch.Tensor, duration: torch.Tensor, t_grid: torch.Tensor, *,
               generator: Optional[torch.Generator] = None, y0: Optional[torch.Tensor] = None,
               cfg_strength: float | torch.Tensor = 2.0, dtype=torch.bfloat16,
               noise_max_len: Optional[int] = None, method: str = "euler",
               edit_mask: Optional[torch.Tensor] = None, no_ref_audio: bool = False,
               backbone: BackboneDef = DIT) -> torch.Tensor:
    """cond [b, n, d] prompt mel zero-padded to the bucket n, text [b, nt]
    ids (-1 padded), lens [b] prompt frames, duration [b] total frames <= n.
    Returns the mel [b, n, d] (f32). Pass `y0` or a `generator` for noise.
    `params` must hold the fused QKV projections (`fuse_backbone_qkv`).
    `cfg_strength` is a float or an f32 scalar tensor on cond's device (a
    CUDA graph's input, as the JAX pipeline traces it); given `y0`, t_grid
    and cfg_strength on cond's device, the call does no host work that
    depends on their values. `method` "euler" or "midpoint"; `edit_mask`
    [b, n] bool keeps cond only where it holds (speech editing: False
    frames are regenerated); `no_ref_audio` conditions on zeros. The cond
    frames kept are re-imposed on the result."""
    b, n, d = cond.shape
    cond_mask = lens_to_mask(lens, n)
    if edit_mask is not None:
        cond_mask = cond_mask & edit_mask.to(cond_mask.device)
    if no_ref_audio:
        cond = torch.zeros_like(cond)
    step_cond = torch.where(cond_mask[:, :, None], cond, 0.0)
    if y0 is None:
        if generator is None:
            raise ValueError("cfm_sample needs a generator or y0")
        y0 = make_noise(generator, b, n, d, duration, noise_max_len)
    cfg = torch.as_tensor(cfg_strength, dtype=torch.float32, device=cond.device)
    sampled = sample_ode(params, statics, y0.float(), step_cond, text, duration,
                         t_grid.float().to(cond.device), cfg, dtype, backbone, method)
    return torch.where(cond_mask[:, :, None], cond, sampled)


def duplicate_test_start(gt_mel: torch.Tensor, seq_len: int, cond_seq_len: int,
                         duration: torch.Tensor, steps: int, t_inter: float = 0.1,
                         sway_sampling_coef: Optional[float] = None, *,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Mid-trajectory restart (JAX cfm.py:323-356): the ground-truth mel
    [b, n_gt, d], shifted to start right after the prompt, is blended into
    the noise at t = t_inter, and the remaining steps integrate from there.
    The noise is `noise` ([b, seq_len, d], as `make_noise` gives it) or
    drawn from `generator`. Returns (y0, t_grid, remaining steps) for
    `cfm_sample(y0=..., t_grid=...)`."""
    b, n_gt, d = gt_mel.shape
    test_cond = gt_mel.new_zeros((b, seq_len, d))
    take = min(n_gt, seq_len - cond_seq_len)
    test_cond[:, cond_seq_len:cond_seq_len + take] = gt_mel[:, :take]
    if noise is None:
        if generator is None:
            raise ValueError("duplicate_test_start needs a generator or noise")
        noise = make_noise(generator, b, seq_len, d, duration)
    y0 = (1.0 - t_inter) * noise.to(test_cond) + t_inter * test_cond
    remaining = max(int(steps * (1.0 - t_inter)), 1)
    t = sway_timesteps(linspace_f32(t_inter, 1.0, remaining + 1), sway_sampling_coef)
    return y0, t, remaining


def compute_duration(text_lens, prompt_lens, requested, max_duration: int):
    """duration = max(max(text_len, lens) + 1, requested), clamped."""
    return torch.clamp(torch.maximum(torch.maximum(text_lens, prompt_lens) + 1, requested),
                       max=max_duration)
