"""Head widths past 64 through the port's backbones against the JAX package
on the CPU.

Each backbone (DiT, UNetT, MMDiT) at dim 256, depth 2 and 2 heads of 128
(the flat kernels' second instantiated width: K3 / K5's plain versions here),
of 96, of 256 and of 512 (off the flat gate: the DiT and UNetT take the head
layout, K7's plain version, on the card K7 reading rows of 96 in place at
its D = 128 tile, its native D = 256 kernel at 256 and its pair D = 512
kernel at 512; the MMDiT computes JAX's XLA branch `bias_decomposed_ref`).
Weights are numpy-seeded in the JAX tree layout and carried across by
`convert.*_params_from_jax`; the JAX side runs its XLA path in f32
(`backend="xla"`), the port its plain versions in f32. Also: the converter
carries a dim_head-128 and a dim_head-96 tree leaf for leaf, one `cfm_loss`
gradient check of the DiT at 2 x 128, 2 x 96, 2 x 256 and 2 x 512 (K7-lse /
K9's plain versions past 64) against `jax.value_and_grad`, one
`InferencePipeline.infer` of the DiT at 2 x 128, 2 x 96, 2 x 256 and 2 x
512, the width routing of K7 / K9 (the tile width D and the row width read
in place), and the operators' fakes and FLOP formulas at d = 128, 256 and
K10's new range.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import CFMConfig as JCFMConfig
from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.ops import attention as jatt
from f5tts_tpu_torch import convert
from f5tts_tpu_torch.config import CFMConfig
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import mmdit as tmmdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models import unett as tunett
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops._operators import OPERATORS
from f5tts_tpu_torch.ops.rope import rope_flat_tables
from f5tts_tpu_torch.train import step as tstep
from tests.test_torch_dit import _live, _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = dict(dim=256, depth=2, ff_mult=2, text_num_embeds=32)
# each backbone's small configuration, as its own test file's
BACKBONE = {
    "DiT": (dict(text_dim=64, conv_layers=1), jdit.init_dit, jdit.dit_forward, jdit.DiTStatics,
            convert.dit_params_from_jax, tdit.dit_forward, tdit.DiTStatics),
    "UNetT": (dict(text_dim=None, conv_layers=0, text_mask_padding=False), junett.init_unett,
              junett.unett_forward, junett.UNetTStatics, convert.unett_params_from_jax,
              tunett.unett_forward, tunett.UNetTStatics),
    "MMDiT": (dict(text_dim=None, conv_layers=0, text_mask_padding=True), jmmdit.init_mmdit,
              jmmdit.mmdit_forward, jmmdit.MMDiTStatics, convert.mmdit_params_from_jax,
              tmmdit.mmdit_forward, tmmdit.MMDiTStatics),
}
# f32 on both sides; the random AdaLN gates scale the streams, outputs O(1-10)
ATOL, RTOL = 2e-4, 2e-4


def _model(backbone: str, dim_head: int, seed: int = 0):
    """(JAX arch, port arch, numpy JAX params, port params with fused QKV)."""
    extra, jinit, *_, to_port, _, _ = BACKBONE[backbone]
    kw = dict(BASE, heads=2, dim_head=dim_head, **extra)
    jarch = JArch(**kw)
    tree = np_params(lambda: jinit(jax.random.PRNGKey(seed), jarch), seed)
    return jarch, TArch(**kw), tree, tm.fuse_backbone_qkv(to_port(tree))


@pytest.fixture(scope="module")
def dit128():
    return _model("DiT", 128)


@pytest.fixture(scope="module")
def dit256():
    return _model("DiT", 256)


@pytest.fixture(scope="module")
def dit96():
    return _model("DiT", 96)


@pytest.fixture(scope="module")
def dit512():
    return _model("DiT", 512)


@pytest.mark.parametrize("dim_head", [128, 96, 256, 512])
@pytest.mark.parametrize("backbone", ["DiT", "UNetT", "MMDiT"])
def test_forward_at_head_width_matches_jax(backbone, dim_head):
    """The whole forward with CFG packing, ragged lengths and padded text."""
    jarch, tarch, tree, tp = _model(backbone, dim_head)
    _, _, jfwd, jstatics, _, tfwd, tstatics = BACKBONE[backbone]
    rng = np.random.default_rng(8)
    # the DiT at 256 rows (flat gate), the UNetT's 255 + the time token, the
    # MMDiT's 200 audio + 70 text rows padded to 384
    b, n = 2, {"DiT": 256, "UNetT": 255, "MMDiT": 200}[backbone]
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 80:] = 0
    text = rng.integers(0, 32, (b, 70)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 141], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    fwd = jax.jit(functools.partial(jfwd, statics=jstatics(jarch), cfg_infer=True,
                                    backend="xla"))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens)))
    got = _np(tfwd(tp, tstatics(tarch), _t(x), _t(cond), _t(text), _t(time), lengths=_t(lens),
                   cfg_infer=True))
    assert got.shape == want.shape == (2 * b, n, 100)
    lens2 = np.concatenate([lens, lens])
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=ATOL, rtol=RTOL)
    assert np.abs(_live(want, lens2)).max() > 0.1


def test_self_attention_routes_by_head_width(monkeypatch):
    """The DiT block's attention takes the flat K3 at 2 x 128 and the head
    layout (K7) at 2 x 96, 2 x 256 and 2 x 512 (its native wide and split
    kernels on the card), whose plain versions the CPU runs: spies on the
    forwards the two operators call."""
    taken = []
    for name in ("fused_qkv_rope_attention_fwd", "flash_attention_fwd"):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _n=name, _r=real, **k: taken.append(_n)
                            or _r(*a, **k))
    for dim_head, want in ((128, "fused_qkv_rope_attention_fwd"), (96, "flash_attention_fwd"),
                           (256, "flash_attention_fwd"), (512, "flash_attention_fwd")):
        _, tarch, _, tp = _model("DiT", dim_head)
        statics = tdit.DiTStatics(tarch)
        x = torch.randn(1, 128, 256, generator=torch.Generator().manual_seed(dim_head))
        tabs = rope_flat_tables(statics.rope_angles, 128, 2, dtype=torch.float32)
        taken.clear()
        tm.self_attention(tp["blocks"][0]["attn"], x, 2, tabs, None, statics.rope_angles)
        assert taken == [want], (dim_head, taken)


@pytest.mark.parametrize("d,width,row", [(64, 64, 64), (128, 128, 128), (96, 128, 96),
                                         (32, 64, 32), (1, 64, 8), (160, 192, 160),
                                         (200, 256, 200), (256, 256, 256), (130, 192, 136),
                                         (512, 512, 512), (192, 192, 192), (264, 384, 264),
                                         (320, 384, 320), (448, 512, 448), (520, 520, 520),
                                         (640, 640, 640)])
def test_kernel_width_covers_every_head_width(d, width, row):
    """The widths K7 / K9 run a head of d at on the card: the tile width D
    (64, 128, 192, 256, 384 or 512, the least that holds d; 192 / 256 the
    native wide kernels, 384 / 512 the pair kernels; past 512 the slice
    mode at the row width) and the row width they read and write in place
    (d itself where it is a multiple of 8, 16-byte rows, else d rounded up
    to one)."""
    assert tatt._kernel_width(d) == width
    assert tatt._row_width(d) == row


@pytest.mark.parametrize("d", [1, 8, 96, 100, 104, 130, 160, 200, 248, 256, 264, 512])
def test_row_width_rule(d, monkeypatch):
    """`_to_row_width`, the one place K7 / K9's route may copy: a head whose
    width is a multiple of 8 goes to the kernel as it is (the same tensors,
    `_pad_heads` not called); any other is zero-padded to the next multiple
    of 8, its lanes past d exactly 0 and the rest unchanged, and the route's
    function there (the plain versions at the row width with the scale of
    the true d, the lanes past d dropped) matches JAX's
    `_flash_forward(return_lse=True)` and `_flash_backward_fused` (Pallas,
    interpret mode) at d on live rows, f32, 3e-4 as
    `test_padded_native_width_matches_jax`; the padded lanes exactly 0."""
    calls = []
    real = tatt._pad_heads
    monkeypatch.setattr(tatt, "_pad_heads", lambda *a: calls.append(a[0]) or real(*a))
    n, lengths = 128, [128, 77]
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((2, 2, n, d)).astype(np.float32) for _ in range(4))
    lens = np.array(lengths, np.int32)
    do *= (np.arange(n)[None, :] < lens[:, None])[:, None, :, None]
    ts = tuple(_t(x) for x in (q, k, v, do))
    row = -(-d // 8) * 8
    got = tatt._to_row_width(*ts)
    if row == d:
        assert all(g is t for g, t in zip(got, ts)) and calls == []
        return
    assert calls == [row]
    for g, t in zip(got, ts):
        assert g.shape == (2, 2, n, row) and g.is_contiguous()
        assert torch.equal(g[..., :d], t) and not g[..., d:].any()
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jl, jdo = (jnp.asarray(x) for x in (q, k, v, lens, do))
    o_j, lse_j = jatt._flash_forward(jq, jk, jv, jl, return_lse=True)
    o, lse = tatt.flash_attention_fwd_ref(*got[:3], _t(lens), return_lse=True, scale=scale)
    assert not o[..., d:].any()
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(_np(o)[i, :, :ln, :d], np.asarray(o_j)[i, :, :ln], atol=3e-4,
                                   rtol=3e-4)
        np.testing.assert_allclose(_np(lse)[i, :, :ln], np.asarray(lse_j)[i, :, :ln, 0],
                                   atol=3e-4, rtol=3e-4)
    want = jatt._flash_backward_fused(jq, jk, jv, jl, o_j, lse_j, jdo)
    (op,) = tatt._to_row_width(_t(np.asarray(o_j)))
    grads = tatt.flash_attention_bwd_ref(*got[:3], _t(lens), op, _t(np.asarray(lse_j)[..., 0]),
                                         got[3], scale=scale)
    for g, w in zip(grads, want):
        g = _np(g)
        assert not g[..., d:].any()
        for i, ln in enumerate(lengths):
            np.testing.assert_allclose(g[i, :, :ln, :d], np.asarray(w)[i, :, :ln], atol=3e-4,
                                       rtol=3e-4)


@pytest.mark.parametrize("d", [160, 200, 320, 448])
def test_padded_native_width_matches_jax(d):
    """What the card's tiles hold for a head of d in (128, 512]: q, k, v, o
    and dO zero-padded to `_kernel_width(d)` (192 / 256, K7 / K9's native
    wide kernels, whose TMA copies fill the lanes past d with zeros; 384 /
    512 their pair kernels, whose sub-tiles past d are zeroed and never
    copied into) by `_pad_heads`, the plain versions at that width with the
    scale of the true d, the lanes past d dropped. Against JAX's
    `_flash_forward(return_lse=True)` and `_flash_backward_fused` (Pallas,
    interpret mode) at n = 128, lengths [128, 77], f32 on both sides, on
    live rows (forward rows and dq rows < length, dk / dv keys < length):
    3e-4, the sum orders of the Pallas backward's own tolerance; the padded
    lanes exactly 0."""
    n, lengths = 128, [128, 77]
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((2, 2, n, d)).astype(np.float32) for _ in range(4))
    lens = np.array(lengths, np.int32)
    do *= (np.arange(n)[None, :] < lens[:, None])[:, None, :, None]  # the model's row mask
    width = tatt._kernel_width(d)
    assert width in tatt.NATIVE_WIDE_DIMS and width > d
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = tatt._pad_heads(width, *(_t(x) for x in (q, k, v, do)))
    jq, jk, jv, jl, jdo = (jnp.asarray(x) for x in (q, k, v, lens, do))
    o_j, lse_j = jatt._flash_forward(jq, jk, jv, jl, return_lse=True)
    o, lse = tatt.flash_attention_fwd_ref(qp, kp, vp, _t(lens), return_lse=True, scale=scale)
    assert o.shape[-1] == width and not o[..., d:].any()
    o, lse = _np(o), _np(lse)
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(o[i, :, :ln, :d], np.asarray(o_j)[i, :, :ln], atol=3e-4,
                                   rtol=3e-4)
        np.testing.assert_allclose(lse[i, :, :ln], np.asarray(lse_j)[i, :, :ln, 0], atol=3e-4,
                                   rtol=3e-4)
    want = jatt._flash_backward_fused(jq, jk, jv, jl, o_j, lse_j, jdo)
    (op,) = tatt._pad_heads(width, _t(o_j))
    got = tatt.flash_attention_bwd_ref(qp, kp, vp, _t(lens), op, _t(np.asarray(lse_j)[..., 0]),
                                       dop, scale=scale)
    for g, w in zip(got, want):
        g = _np(g)
        assert g.shape[-1] == width and not g[..., d:].any()
        for i, ln in enumerate(lengths):
            np.testing.assert_allclose(g[i, :, :ln, :d], np.asarray(w)[i, :, :ln], atol=3e-4,
                                       rtol=3e-4)


def test_converter_carries_a_dim_head_128_tree(dit128):
    """Every leaf of the JAX tree comes across under its own key, unchanged:
    the attention leaves at [256, 256] (2 heads of 128), a block's own slice
    of the stacked arrays."""
    _check_converter(dit128)


def test_converter_carries_a_dim_head_96_tree(dit96):
    """The same at 2 heads of 96: the attention leaves at [256, 192]."""
    _check_converter(dit96)


def _check_converter(model):
    jarch, _, tree, _ = model
    inner = jarch.heads * jarch.dim_head
    tp = convert.dit_params_from_jax(tree)
    assert len(tp["blocks"]) == jarch.depth
    for i in range(jarch.depth):
        for name in ("to_q", "to_k", "to_v", "to_out"):
            for leaf in ("w", "b"):
                got = _np(tp["blocks"][i]["attn"][name][leaf])
                np.testing.assert_array_equal(got, tree["blocks"]["attn"][name][leaf][i])
        assert tuple(tp["blocks"][i]["attn"]["to_q"]["w"].shape) == (256, inner)
    fused_j = convert.dit_params_from_jax(jax.tree.map(np.asarray, jm.fuse_backbone_qkv(tree)))
    fused_t = tm.fuse_backbone_qkv(tp)
    for leaf in ("w", "b"):
        np.testing.assert_array_equal(_np(fused_j["blocks"][1]["attn"]["to_qkv"][leaf]),
                                      _np(fused_t["blocks"][1]["attn"]["to_qkv"][leaf]))


def test_cfm_loss_and_grads_at_dim_head_128_match_jax(dit128):
    """cfm_loss and every gradient leaf of the DiT at 2 x 128 (K3's lse mode
    and K4's plain versions) against jax.value_and_grad, the JAX key's draws
    handed to the port: loss 1e-5 relative, leaves rel-L2 <= 1e-4."""
    _check_loss_and_grads(dit128)


def test_cfm_loss_and_grads_at_dim_head_96_match_jax(dit96):
    """The same at 2 x 96: the head layout (off the flat gate), K7's lse mode
    and K9's plain versions (K7 / K9 reading rows of 96 in place at their D =
    128 tile on the card)."""
    _check_loss_and_grads(dit96)


def test_cfm_loss_and_grads_at_dim_head_256_match_jax(dit256):
    """The same at 2 x 256: the head layout, K7's lse mode and K9's plain
    versions (their wide mode on the card)."""
    _check_loss_and_grads(dit256)


def test_cfm_loss_and_grads_at_dim_head_512_match_jax(dit512):
    """The same at 2 x 512: the head layout, K7's lse mode and K9's plain
    versions (their pair kernels at D = 512 on the card)."""
    _check_loss_and_grads(dit512)


def _check_loss_and_grads(model):
    jarch, tarch, tree, tp = model
    b, n, d = 4, 128, 100
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((b, n, d)).astype(np.float32)
    lens = np.array([n, 100, 77, 120], np.int32)
    mel[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    text = rng.integers(0, 32, (b, 50)).astype(np.int32)
    text[2, 30:] = -1
    key = jax.random.PRNGKey(2)
    k_frac, k_start, k_x0, k_t, k_da, k_db = jax.random.split(key, 6)
    u = functools.partial(jax.random.uniform, shape=(b,))
    draws = tcfm.CFMDraws(*(torch.from_numpy(np.array(a)) for a in (
        u(k_frac, minval=0.7, maxval=1.0), u(k_start),
        jax.random.normal(k_x0, (b, n, d), jnp.float32), u(k_t), u(k_da), u(k_db))))

    def jloss(p):
        p = jm.fuse_backbone_qkv(p, dtype=jnp.float32)
        return jcfm.cfm_loss(p, jdit.DiTStatics(jarch), key, jnp.asarray(mel), jnp.asarray(text),
                             jnp.asarray(lens), cfg=JCFMConfig(), dtype=jnp.float32,
                             backend="xla")[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jx(tree))
    step = tstep.make_train_step(tdit.DiTStatics(tarch), tstep.make_optimizer(1e-4, 10, 100),
                                 CFMConfig(), dtype=torch.float32)
    loss, grads = step.grad_step(convert.dit_params_from_jax(tree), torch.from_numpy(mel),
                                 torch.from_numpy(text), torch.from_numpy(lens), draws=draws)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = tm.tree_leaves(convert.dit_params_from_jax(jax.tree.map(np.asarray, want_grads)))
    got = tm.tree_leaves(grads)
    assert len(got) == len(want)
    rel = [float(np.linalg.norm(_np(g) - _np(w)) / np.linalg.norm(_np(w)))
           for g, w in zip(got, want) if float(w.abs().max()) > 0]
    assert max(rel) <= 1e-4, max(rel)


def test_dit_128_pipeline_infer_on_cpu(dit128):
    """One InferencePipeline.infer at the DiT of 2 heads of 128 (depth 2)."""
    _pipeline_smoke(dit128)


def test_dit_96_pipeline_infer_on_cpu(dit96):
    """One InferencePipeline.infer at the DiT of 2 heads of 96 (depth 2)."""
    _pipeline_smoke(dit96)


def test_dit_256_pipeline_infer_on_cpu(dit256):
    """One InferencePipeline.infer at the DiT of 2 heads of 256 (depth 2)."""
    _pipeline_smoke(dit256)


def test_dit_512_pipeline_infer_on_cpu(dit512):
    """One InferencePipeline.infer at the DiT of 2 heads of 512 (depth 2)."""
    _pipeline_smoke(dit512)


def _pipeline_smoke(model):
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_pipeline import VOCAB, _ref_wav
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    _, tarch, _, tp = model
    voc = tvocos.Vocos(tvocos.init_vocos(torch.Generator().manual_seed(0),
                                         tvocos.VocosConfig(**SMALL_VOCOS)),
                       tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    pipe = tpipe.InferencePipeline(tp, tdit.DiTStatics(tarch), voc, VOCAB,
                                   sampling=SamplingConfig(nfe_steps=2), tokenizer="char",
                                   dtype=torch.float32, device="cpu")
    _build.reset_launches()
    wave, sr, mel = pipe.infer(_ref_wav(), 24000, "a quiet voice.", "hello there.",
                               nfe_step=2, fix_duration=2.0)
    assert sr == 24000 and np.isfinite(wave).all() and np.abs(wave).max() > 0
    assert mel.shape[0] == 100 and len(wave) > 0
    assert _build.launches() == {}  # CPU tensors: the plain versions, no kernel


def _cases():
    bf = torch.float32
    i32 = torch.int32
    return [
        ("fused_qkv_rope_attention", (torch.randn(2, 128, 3 * 256), torch.randn(128, 256),
                                      torch.randn(128, 256), torch.tensor([128, 90], dtype=i32),
                                      2)),
        ("fused_qkv_rope_attention_lse", (torch.randn(2, 128, 3 * 256), torch.randn(128, 256),
                                          torch.randn(128, 256),
                                          torch.tensor([128, 90], dtype=i32), 2)),
        ("fused_qkv_rope_attention_bias", (torch.randn(2, 128, 3 * 256), torch.randn(128, 256),
                                           torch.randn(128, 256),
                                           torch.ones(2, 128, dtype=torch.bool), 2)),
        ("flash_attention", (*(torch.randn(2, 2, 128, 128, dtype=bf) for _ in range(3)),
                             torch.tensor([128, 90], dtype=i32))),
        ("flash_attention_lse", (*(torch.randn(2, 2, 128, 96, dtype=bf) for _ in range(3)),
                                 torch.tensor([128, 90], dtype=i32))),
        ("masked_flash_attention", (*(torch.randn(2, 2, 128, 128) for _ in range(3)),
                                    torch.ones(2, 128, dtype=torch.bool))),
        ("grouped_conv1d", (torch.randn(2, 64, 320), torch.randn(63, 160, 320),
                            torch.randn(320), 2)),
        ("grouped_conv1d", (torch.randn(2, 64, 256), torch.randn(30, 256, 256),
                            torch.randn(256), 1)),
        ("flash_attention", (*(torch.randn(2, 2, 128, 256, dtype=bf) for _ in range(3)),
                             torch.tensor([128, 90], dtype=i32))),
        ("flash_attention_lse", (*(torch.randn(2, 2, 128, 256, dtype=bf) for _ in range(3)),
                                 torch.tensor([128, 90], dtype=i32))),
        ("masked_flash_attention", (*(torch.randn(2, 2, 128, 256) for _ in range(3)),
                                    torch.ones(2, 128, dtype=torch.bool))),
    ]


CASE_IDS = ["K3-d128", "K3lse-d128", "K5-d128", "K7-d128", "K7lse-d96", "K11-d128",
            "K10-W160-k63", "K10-W256-k30", "K7-d256", "K7lse-d256", "K11-d256"]


@pytest.mark.parametrize("case", range(len(CASE_IDS)), ids=CASE_IDS)
def test_operator_fakes_and_flops_at_the_new_widths(case):
    """Each operator's fake gives its real output's shape, dtype and strides,
    and its FLOP formula the count FlopCounterMode makes of the plain version
    (`_operators.operator`), at the new widths."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from tests.test_torch_tools import PLAIN

    torch.manual_seed(case)
    name, args = _cases()[case]
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
    counts = []
    for fn in (OPERATORS[name], PLAIN[name]):
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args)
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1] > 0, name
