"""The port's export (f5tts_tpu_torch.compat.export) and the kernels as
`torch.library` operators (ops/_operators.py), on the CPU.

- `export_sampler` -> `load_exported` -> the program against the eager
  port's `cfm_sample` on the same y0 (exact: the same operators in the same
  order) and against the JAX `cfm_sample(y0=)` with the same numpy-seeded
  weights, all in f32, for the DiT (at dim 1024: 64 channels a conv group,
  the fused conv-position operator), the UNetT, the MMDiT, a dim-768 DiT
  (48 channels a group: the grouped-conv operator) and the DiT / MMDiT with
  qk-norm (the RMSNorm operator on the head view, the head-layout attention
  operators);
- `export_vocoder` against the JAX `vocos_decode`;
- a saved program loaded and run in a process that imports only the port;
- every `f5tts::` operator's fake (what `torch.export` traces with) against
  its real output on the CPU: shape, dtype and strides.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import unett as junett
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch.compat.export import (export_sampler, export_vocoder, load_exported,
                                           run_exported)
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import (dit_params_from_jax, mmdit_params_from_jax,
                                     unett_params_from_jax, vocos_params_from_jax)
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops import adaln_norm as tnorm
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops import grouped_conv as tgc
from f5tts_tpu_torch.ops._operators import OPERATORS
from f5tts_tpu_torch.utils import make_time_grid
from f5tts_tpu_torch.vocoder.vocos import VocosConfig
from tests.test_torch_dit import _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.test_torch_vocos_mel import SMALL_VOCOS

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFE = 2
BASE = dict(depth=2, heads=2, dim_head=64, ff_mult=2, text_num_embeds=32)
# name -> (backbone, arch fields)
ARCHS = {
    "DiT": ("DiT", dict(BASE, dim=1024, depth=1, heads=16, ff_mult=1, text_dim=64,
                        conv_layers=1)),
    "UNetT": ("UNetT", dict(BASE, dim=128, text_dim=None, conv_layers=0,
                            text_mask_padding=False)),
    "MMDiT": ("MMDiT", dict(BASE, dim=128, text_dim=None, conv_layers=0,
                            text_mask_padding=True)),
    "DiT_768": ("DiT", dict(BASE, dim=768, depth=1, heads=12, text_dim=64, conv_layers=1)),
    "DiT_qk_norm": ("DiT", dict(BASE, dim=128, text_dim=64, conv_layers=1,
                                qk_norm="rms_norm")),
    "MMDiT_qk_norm": ("MMDiT", dict(BASE, dim=128, text_dim=None, conv_layers=0,
                                    text_mask_padding=True, qk_norm="rms_norm")),
}
INIT = {"DiT": jdit.init_dit, "UNetT": junett.init_unett, "MMDiT": jmmdit.init_mmdit}
CONVERT = {"DiT": dit_params_from_jax, "UNetT": unett_params_from_jax,
           "MMDiT": mmdit_params_from_jax}


def _inputs(n: int, nt: int, mel_dim: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((1, n, mel_dim)).astype(np.float32)
    text = rng.integers(0, 32, (1, nt)).astype(np.int32)
    text[0, nt - 5:] = -1
    lens, dur = np.array([n // 4], np.int32), np.array([n - 9], np.int32)
    y0 = rng.standard_normal((1, n, mel_dim)).astype(np.float32)
    y0[0, dur[0]:] = 0
    return cond, text, lens, dur, y0


@pytest.mark.parametrize("name", list(ARCHS))
def test_exported_sampler_matches_eager_and_jax(name, tmp_path):
    backbone, fields = ARCHS[name]
    jarch, tarch = JArch(**fields), TArch(**fields)
    tree = np_params(lambda: INIT[backbone](jax.random.PRNGKey(0), jarch), 5)
    params = tm.fuse_backbone_qkv(CONVERT[backbone](tree))
    statics = tcfm.BACKBONES[backbone].statics_cls(tarch, "cpu")
    n = 64 - tcfm.BACKBONES[backbone].seq_extra_tokens
    cond, text, lens, dur, y0 = _inputs(n, 16, tarch.mel_dim)
    path = str(tmp_path / "sampler.pt2")
    export_sampler(params, statics, path, batch=1, seq_frames=n, text_len=16, nfe=NFE,
                   dtype=torch.float32, backbone=backbone)
    program = load_exported(path)
    got = _np(run_exported(program, *map(_t, (cond, text, lens, dur, y0))))

    eager = _np(tcfm.cfm_sample(params, statics, *map(_t, (cond, text, lens, dur)),
                                make_time_grid(NFE, sway_sampling_coef=-1.0), y0=_t(y0),
                                cfg_strength=2.0, dtype=torch.float32,
                                backbone=tcfm.BACKBONES[backbone]))
    np.testing.assert_array_equal(got, eager)  # the same operators in the same order

    jbd = jcfm.BACKBONES[backbone]
    want = np.asarray(jcfm.cfm_sample(
        jx(tree), jbd.statics_cls(jarch), *map(jnp.asarray, (cond, text, lens, dur)),
        j_make_time_grid(NFE, sway_sampling_coef=-1.0), y0=jnp.asarray(y0),
        cfg_strength=2.0, dtype=jnp.float32, backend="xla", backbone=jbd))
    assert got.shape == want.shape
    # f32 through 2 Euler steps of a 1-2 block backbone: sum-order drift only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    ops = {str(node.target).split(".")[1] for node in program.graph.nodes
           if str(node.target).startswith("f5tts.")}
    expect = {"DiT": {"adaln_norm", "conv_pos_embedding", "fused_qkv_rope_attention"},
              "UNetT": {"rms_norm", "grouped_conv1d", "fused_qkv_rope_attention"},
              "MMDiT": {"adaln_norm", "grouped_conv1d", "fused_qkv_rope_attention_bias"},
              "DiT_768": {"adaln_norm", "grouped_conv1d", "fused_qkv_rope_attention"},
              "DiT_qk_norm": {"adaln_norm", "rms_norm", "grouped_conv1d", "flash_attention"},
              "MMDiT_qk_norm": {"adaln_norm", "rms_norm", "grouped_conv1d",
                                "masked_flash_attention"}}[name]
    assert ops == expect


def test_exported_vocoder_matches_jax(tmp_path):
    jcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    tree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jcfg), 4)
    path = str(tmp_path / "vocos.pt2")
    export_vocoder(vocos_params_from_jax(tree), path, batch=2, frames=40,
                   cfg=VocosConfig(**SMALL_VOCOS), device="cpu")
    mel = np.random.default_rng(1).standard_normal((2, 100, 40)).astype(np.float32)
    got = _np(run_exported(load_exported(path), _t(mel)))
    want = np.asarray(jvocos.vocos_decode(jx(tree), jnp.asarray(mel), jcfg))
    assert got.shape == want.shape == (2, 39 * 256)
    # f32, |wav| < ~1: sum-order differences through the iSTFT
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_load_in_a_process_that_imports_only_the_port(tmp_path):
    backbone, fields = ARCHS["UNetT"]
    tarch = TArch(**fields)
    gen = torch.Generator().manual_seed(0)
    params = tcfm.BACKBONES[backbone].init(gen, tarch)
    statics = tcfm.BACKBONES[backbone].statics_cls(tarch, "cpu")
    path = tmp_path / "sampler.pt2"
    export_sampler(params, statics, str(path), seq_frames=63, text_len=8, nfe=NFE,
                   dtype=torch.float32, backbone=backbone)
    cond, text, lens, dur, y0 = _inputs(63, 8, tarch.mel_dim)
    np.savez(tmp_path / "inputs.npz", cond=cond, text=text, lens=lens, dur=dur, y0=y0)
    want = _np(tcfm.cfm_sample(tm.fuse_backbone_qkv(params), statics,
                               *map(_t, (cond, text, lens, dur)),
                               make_time_grid(NFE, sway_sampling_coef=-1.0), y0=_t(y0),
                               cfg_strength=2.0, dtype=torch.float32,
                               backbone=tcfm.BACKBONES[backbone]))
    np.save(tmp_path / "want.npy", want)
    code = ("import sys, numpy as np, torch\n"
            "from f5tts_tpu_torch.compat.export import load_exported, run_exported\n"
            f"d = np.load({str(tmp_path / 'inputs.npz')!r})\n"
            f"p = load_exported({str(path)!r})\n"
            "out = run_exported(p, *(torch.from_numpy(d[k]) for k in "
            "('cond', 'text', 'lens', 'dur', 'y0'))).numpy()\n"
            f"assert np.array_equal(out, np.load({str(tmp_path / 'want.npy')!r}))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'f5tts_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _operator_cases():
    """(operator name, args) on small CPU inputs: every f5tts:: operator,
    K6 also on qk-norm's strided head view."""
    rng = np.random.default_rng(0)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    b, n, h, d = 2, 64, 2, 64
    qkv, cos, sin = r(b, n, 3 * h * d), r(n, h * d), r(n, h * d)
    lengths = torch.tensor([n, 40], dtype=torch.int32)
    kmask = torch.ones(b, n, dtype=torch.bool)
    kmask[1, 20:30] = False
    q, k, v = r(b, h, n, d), r(b, h, n, d), r(b, h, n, d)
    proj = r(b, n, 3 * h * d)
    x128 = r(b, n, 128)
    return [
        ("adaln_norm", (r(b, n, 128), r(b, 128), r(b, 128), 1e-6)),
        ("rms_norm", (r(b, n, 128), r(128), 1e-6)),
        ("rms_norm", (tm.head_view(proj[..., :h * d], h), r(d), 1e-6)),
        ("conv_pos_embedding", (x128, r(31, 64, 128), r(128), r(31, 64, 128), r(128), lengths,
                                2)),
        ("grouped_conv1d", (x128, r(31, 8, 128), r(128), 16)),
        ("fused_qkv_rope_attention", (qkv, cos, sin, lengths, h)),
        ("fused_qkv_rope_attention_lse", (qkv, cos, sin, lengths, h)),
        ("fused_qkv_rope_attention_bias", (qkv, cos, sin, kmask, h)),
        ("fused_qkv_rope_attention_bias_lse", (qkv, cos, sin, kmask, h)),
        ("flash_attention", (q, k, v, lengths)),
        ("flash_attention_lse", (q, k, v, lengths)),
        ("masked_flash_attention", (q, k, v, kmask)),
    ]


def test_every_operator_has_a_case():
    assert {name for name, _ in _operator_cases()} == set(OPERATORS)


@pytest.mark.parametrize("case", range(len(_operator_cases())))
def test_operator_fake_matches_real_layout(case):
    name, args = _operator_cases()[case]
    real = OPERATORS[name](*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode:
        fake = OPERATORS[name](*fake_args)
    reals = real if isinstance(real, tuple) else (real,)
    fakes = fake if isinstance(fake, tuple) else (fake,)
    assert len(reals) == len(fakes)
    for a, f in zip(reals, fakes):
        assert (f.shape, f.dtype, f.stride()) == (a.shape, a.dtype, a.stride()), name


def test_wrappers_reach_their_operators():
    """The public wrappers (what the models call) dispatch the operators:
    under a dispatch mode each call shows up as its f5tts:: operator."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func).split(".")[1] if str(func).startswith("f5tts.") else None)
            return func(*args, **(kwargs or {}))

    cases = dict((name, args) for name, args in _operator_cases())
    calls = {
        "adaln_norm": lambda a: tnorm.adaln_norm(*a),
        "rms_norm": lambda a: tnorm.rms_norm(*a),
        "conv_pos_embedding": lambda a: tgc.conv_pos_embedding(*a),
        "grouped_conv1d": lambda a: tgc.grouped_conv1d(*a),
        "fused_qkv_rope_attention": lambda a: tatt.fused_qkv_rope_attention(*a),
        "fused_qkv_rope_attention_bias": lambda a: tatt.fused_qkv_rope_attention_bias(*a),
        "flash_attention": lambda a: tatt.flash_attention(*a),
        "masked_flash_attention": lambda a: tatt.masked_flash_attention(*a),
    }
    for name, call in calls.items():
        seen = Seen()
        with seen:
            call(cases[name])
        assert name in seen.ops, (name, seen.ops)
    # under grad, the training forwards' operators
    grads = {"fused_qkv_rope_attention_lse": lambda a: tatt.fused_qkv_rope_attention(
                 a[0].requires_grad_(), *a[1:]),
             "fused_qkv_rope_attention_bias_lse": lambda a: tatt.fused_qkv_rope_attention_bias(
                 a[0].requires_grad_(), *a[1:]),
             "flash_attention_lse": lambda a: tatt.flash_attention(
                 a[0].requires_grad_(), *a[1:])}
    for name, call in grads.items():
        seen = Seen()
        with seen:
            call([t.clone() if isinstance(t, torch.Tensor) else t for t in cases[name]])
        assert name in seen.ops, (name, seen.ops)


def test_operators_refuse_other_devices_through_their_fakes():
    """A meta tensor reaches an operator's fake; the wrappers' refusal holds."""
    x = torch.empty(1, 64, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        OPERATORS["grouped_conv1d"](x, torch.empty(31, 8, 128, device="meta"),
                                    torch.empty(128, device="meta"), 16)
