"""The port's int8 W8A8 path (f5tts_tpu_torch.ops.quant) against the JAX
package's (f5tts_tpu.ops.quant) on the CPU, where K12 and K13 run their
plain versions and the int8 product is `torch._int_mm` (exact integer
arithmetic, as the JAX s32 dot).

Tolerances:
- weight and row codes and scales, `flag_outlier_channels`' indices and
  `quantize_dit_params`' leaves: bit-equal (the same IEEE divisions and
  round-half-to-even on the same f32 inputs);
- `int8_linear_pre` / `int8_linear` on the same inputs: rtol 1e-6 (the
  same exact accumulator, then the same three f32 roundings; the hedge's
  side product adds f32 sum order);
- the backbones' forwards and the pipeline on quantized params: the int8
  inputs of each projection are quantized from activations that the two f32
  paths compute to within sum order, so a code can flip where a value sits
  within an ulp of a .5 step; a flip moves one product term by one step
  (amax / 127 times a weight). So each int8 projection of a forward is
  checked on the input it was given (rtol 1e-6), and the forward's output
  by rel-L2 <= 3e-3 (measured 0.9e-3 to 1.9e-3 at dim 128, depth 2), under
  half of int8's own drift from the f32 forward (4.5e-3 to 1.2e-2,
  asserted too); a 2-NFE CFG generate compounds the flips over its steps:
  mel and wav rel-L2 <= 1.5e-2 (measured 5.3e-3 / 8.4e-3).
- the fused quantizes' plain versions (`adaln_norm_quant_ref`,
  `rms_norm_quant_ref`, `gelu_quantize_rows_ref`) against the JAX chains
  (`adaln_norm_ref` / `rms_norm_ref` / `jax.nn.gelu(approximate=True)`, then
  `quantize_rows`): the JAX norm's or GELU's output fed to both quantizes
  gives bit-equal codes and scales; where the two norms' or GELUs' outputs
  are bit-equal (both norms in bf16), so are the chains'. Where they are
  not (the norms in f32 agree to sum order, ~1e-6; XLA rounds a bf16 GELU
  at other points than PyTorch's f32 formula), a code moves by at most 1
  and only where its value or its row's scale differs, and a scale by at
  most its row's largest difference / 127 plus an ulp. Measured at [2, 33,
  256]: no code moved in f32 (26-33% of the values differ); the bf16 GELU
  moved 294 of 16,896 codes (6,644 values differ by a bf16 ulp);
- the int8 forwards with the fused modes against the same forwards with
  them switched off (each norm writing bf16 rows, `quantize_rows` before
  each projection): bit-identical, as the plain versions are those
  compositions.
Tiny dims (dim 128, depth 2, 2 x 64 heads), as the other port tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.ops import adaln_norm as jan
from f5tts_tpu.ops import quant as jq
from f5tts_tpu.ops import rope as jrope
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import dit_params_from_jax
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import mmdit as tmmdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models import unett as tunett
from f5tts_tpu_torch.ops import adaln_norm as tan
from f5tts_tpu_torch.ops import quant as tq
from f5tts_tpu_torch.ops import rope as trope
from tests.test_torch_dit import SMALL, _live, _np, _t, jx, np_params, small_dit
from tests.test_torch_mmdit import small_mmdit
from tests.test_torch_unett import small_unett
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_TOL = 1e-3  # one self-attention on int8 leaves: max-abs and relative
FWD_REL_L2 = 3e-3  # a forward's output after code flips (the module docstring)
PIPE_REL_L2 = 1.5e-2  # a 2-NFE CFG generate's mel and wav: the flips compound over steps
BACKBONES = {"DiT": (small_dit, jdit.dit_forward, tdit.dit_forward, tdit.DiTStatics,
                     jdit.DiTStatics, 256),
             "UNetT": (small_unett, junett.unett_forward, tunett.unett_forward,
                       tunett.UNetTStatics, junett.UNetTStatics, 255),
             "MMDiT": (small_mmdit, jmmdit.mmdit_forward, tmmdit.mmdit_forward,
                       tmmdit.MMDiTStatics, jmmdit.MMDiTStatics, 200)}


def _hard_matrix(rng, shape, axis):
    """Gaussian values with an all-zero slice along `axis`'s other axis and
    values exactly on .5 steps of their slice's scale (k + 0.5 multiples of
    amax / 127, amax = 127 so the scale is exactly 1)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x = np.moveaxis(x, axis, -1)
    x[..., 0, :] = 0.0  # an all-zero row (or column): scale 1, codes 0
    x[..., 1, :] = np.resize(np.arange(-60, 60) + 0.5, x.shape[-1])
    x[..., 1, 0] = 127.0
    return np.ascontiguousarray(np.moveaxis(x, -1, axis))


@pytest.mark.parametrize("shape", [(64, 96), (3, 40, 24), (1024, 8)])
def test_quantize_weight_bit_equal(shape):
    w = _hard_matrix(np.random.default_rng(0), shape, -2)
    ji, js = jq.quantize_weight(jnp.asarray(w))
    ti, ts = tq.quantize_weight(torch.from_numpy(w))
    assert ti.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert (_np(ti)[..., 0] == 0).all() and (_np(ts)[..., 0, 0] == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 64), (2, 17, 1024), (5, 8)])
def test_quantize_rows_bit_equal(shape, dtype):
    x = _hard_matrix(np.random.default_rng(1), shape, -1)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ji, js = jq.quantize_rows(xj)
    ti, ts = tq.quantize_rows(xt)  # a CPU tensor: the plain version of K12
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert ts.shape == (*shape[:-1], 1)


def _linear_pair(rng, k, n, hedge: bool):
    """A JAX int8 leaf and the port's (w_i8 stored [n, k]) from one f32
    weight; with `hedge`, channels 3 and 17 go through the side product."""
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    pj, idx = {"b": jnp.asarray(b)}, np.asarray([3, 17], np.int32)
    if hedge:
        mask = np.ones((k,), np.float32)
        mask[idx] = 0.0
        pj.update(act_mask=jnp.asarray(mask), out_idx=jnp.asarray(idx),
                  w_out=jnp.asarray(w[idx]))
        w = w * mask[:, None]
    w_i8, scale = jq.quantize_weight(jnp.asarray(w))
    pj.update(w_i8=w_i8, w_scale=scale)
    pt = {"w_i8": torch.from_numpy(np.array(w_i8)).t().contiguous(),
          **{key: torch.from_numpy(np.array(v)) for key, v in pj.items() if key != "w_i8"}}
    return pj, pt


@pytest.mark.parametrize("hedge", [False, True])
def test_int8_linear_matches_jax(hedge):
    rng = np.random.default_rng(2)
    pj, pt = _linear_pair(rng, 256, 96, hedge)
    x = rng.standard_normal((2, 33, 256)).astype(np.float32)
    if hedge:
        x[..., [3, 17]] *= 60.0  # outlier activation channels
    want = np.asarray(jq.int8_linear(pj, jnp.asarray(x)))
    got = tq.int8_linear(pt, _t(x))
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(_np(tm.linear(pt, _t(x))), _np(got))  # `linear` dispatches
    # int8_linear_pre on the same pre-quantized rows
    xq, xs = jq.quantize_rows(jnp.asarray(x))
    want = np.asarray(jq.int8_linear_pre(pj, xq, xs, jnp.float32))
    got = _np(tq.int8_linear_pre(pt, torch.from_numpy(np.asarray(xq)),
                                 torch.from_numpy(np.asarray(xs)), torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _with_outliers(tree, writers: dict):
    """`tree` (numpy, JAX layout) with the columns of each writer leaf
    ((mod, name): columns) scaled by 100 in every block."""
    tree = jax.tree.map(np.array, tree)
    for (mod, name), cols in writers.items():
        for stack in ("blocks", "last_block"):
            leaf = tree.get(stack, {}).get(mod, {}).get(name)
            if leaf is not None:
                leaf["w"][..., cols] *= 100.0
    return tree


def test_flag_outlier_channels_matches_jax():
    from f5tts_tpu_torch.convert import mmdit_params_from_jax

    _, _, tree, _ = small_dit(seed=4)
    tree = _with_outliers(tree, {("attn", "to_out"): [3, 9], ("ff", "out"): [3, 9, 40]})
    tp = dit_params_from_jax(tree)
    want = jq.flag_outlier_channels(jx(tree))
    np.testing.assert_array_equal(tq.flag_outlier_channels(tp), want)
    np.testing.assert_array_equal(want, [3, 9, 40])
    assert tq.flag_outlier_channels(tp, max_channels=2).tolist() == \
        jq.flag_outlier_channels(jx(tree), max_channels=2).tolist()
    # the MMDiT's two streams, each from its own writers
    _, _, mtree, _ = small_mmdit(seed=4)
    mtree = _with_outliers(mtree, {("attn", "to_out"): [3, 7], ("ff_x", "out"): [3, 7],
                                   ("attn", "to_out_c"): [5], ("ff_c", "out"): [5]})
    mp = mmdit_params_from_jax(mtree)
    for stream, want in (("audio", [3, 7]), ("context", [5])):
        writers = tq._RESIDUAL_WRITERS[stream]
        got = tq.flag_outlier_channels(mp, writers=writers)
        np.testing.assert_array_equal(got, jq.flag_outlier_channels(jx(mtree), writers=writers))
        np.testing.assert_array_equal(got, want)
    assert tq.flag_outlier_channels(dit_params_from_jax(small_dit(seed=4)[2])).size == 0


def _quantized_pair(backbone: str, smooth: bool = False, fused: bool = True):
    """(JAX arch, port arch, JAX-quantized params, the port's), q/k/v fused
    as the pipeline fuses them unless `fused` is False."""
    from f5tts_tpu_torch.convert import mmdit_params_from_jax

    jarch, tarch, tree, tp = BACKBONES[backbone][0](seed=5)
    if smooth:  # the DiT with outlier channels in its residual writers
        tree = _with_outliers(tree, {("attn", "to_out"): [3, 9], ("ff", "out"): [3, 9]})
        tp = tm.fuse_backbone_qkv(dit_params_from_jax(tree))
    jtree = jx(tree)
    if fused:
        jtree = jm.fuse_backbone_qkv(jtree)
    else:  # the MMDiT's unfused projections (the head layout)
        tp = mmdit_params_from_jax(tree)
    return jarch, tarch, jq.quantize_dit_params(jtree, smooth=smooth), \
        tq.quantize_dit_params(tp, smooth=smooth)


@pytest.mark.parametrize("backbone,smooth", [("DiT", False), ("UNetT", False),
                                             ("MMDiT", False), ("DiT", True)])
def test_quantize_dit_params_bit_equal(backbone, smooth):
    """Every quantized leaf of every block, the port's w_i8 ([n, k]) after
    its transpose; the hedge's mask, indices and saved rows too."""
    _, _, jp, tp = _quantized_pair(backbone, smooth)
    seen = 0
    for stack in tq._BLOCK_STACKS:
        if stack not in tp:
            continue
        blocks = tp[stack] if isinstance(tp[stack], list) else [tp[stack]]
        for i, blk in enumerate(blocks):
            for mod, name in tq._QUANT_LEAVES:
                leaf = blk.get(mod, {}).get(name)
                if leaf is None:
                    continue
                jleaf = jp[stack][mod][name]
                if stack != "last_block":
                    jleaf = {k: np.asarray(v)[i] for k, v in jleaf.items()}
                assert "w" not in leaf and set(leaf) == set(jleaf), (stack, mod, name)
                assert leaf["w_i8"].dtype == torch.int8 and leaf["w_scale"].dtype == torch.float32
                np.testing.assert_array_equal(_np(leaf["w_i8"].t()), np.asarray(jleaf["w_i8"]))
                for key in set(leaf) - {"w_i8"}:
                    np.testing.assert_array_equal(_np(leaf[key]), np.asarray(jleaf[key]))
                seen += 1
    assert seen >= 8
    if smooth:
        assert "act_mask" in tp["blocks"][0]["attn"]["to_qkv"]
        assert "act_mask" not in tp["blocks"][0]["attn"]["to_out"]  # writers stay plain
    assert "w" in tp["proj_out"]  # untouched leaves


@pytest.mark.parametrize("backbone,fused", [("DiT", True), ("UNetT", True), ("MMDiT", True),
                                            ("MMDiT", False)])
def test_int8_forward_matches_jax(backbone, fused, monkeypatch):
    """cfg_infer with ragged lengths. Every int8 projection of the port's
    forward equals the JAX `int8_linear` on the input it was given, or
    `int8_linear_pre` on the codes and scales a fused norm or the GELU mode
    gave it (rtol 1e-6; the MMDiT's to_out_c on its strided text rows). The
    per-projection check runs twice: with the fused modes, and with them
    switched off, where every projection gets bf16 rows and so holds the
    port's quantize against JAX `int8_linear`'s own (the two forwards are
    bit-identical, `test_int8_forward_fused_modes_bit_identical`). The
    forward's output against the JAX forward (`xla`, f32) on the
    JAX-quantized params: rel-L2 <= FWD_REL_L2, and under half the
    int8-against-f32 drift. The unfused MMDiT takes the head layout (the
    JAX one reads `w_i8` for the head width there)."""
    _, jfwd, tfwd, tstat, jstat, n = BACKBONES[backbone]
    jarch, tarch, jp, tp = _quantized_pair(backbone, fused=fused)
    calls = []
    real = tm.int8_linear

    def recorded(p, x):
        y = real(p, x)
        calls.append((p, x, y))
        return y

    monkeypatch.setattr(tm, "int8_linear", recorded)
    real_takes = tm.takes_quantized
    rng = np.random.default_rng(8)
    b = 2
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 80:] = 0
    text = rng.integers(0, 32, (b, 64)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 141], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    fwd = jax.jit(functools.partial(jfwd, statics=jstat(jarch), cfg_infer=True, backend="xla"))
    want = np.asarray(fwd(jp, x=jnp.asarray(x), cond=jnp.asarray(cond), text=jnp.asarray(text),
                          time=jnp.asarray(time), lengths=jnp.asarray(lens)))
    for handed in (True, False):
        monkeypatch.setattr(tm, "takes_quantized",
                            real_takes if handed else lambda *leaves: False)
        calls.clear()
        out = _np(tfwd(tp, tstat(tarch), _t(x), _t(cond), _t(text), _t(time),
                       lengths=_t(lens), cfg_infer=True))
        if handed:
            got = out
        # four projections a block; the MMDiT's eight, five in its last block
        # (unfused: twelve and nine)
        assert len(calls) == {"DiT": 8, "UNetT": 8, "MMDiT": 13 if fused else 21}[backbone]
        assert any(isinstance(xin, tq.QuantRows) for _, xin, _ in calls) == handed
        for p, xin, y in calls:
            leaf = {k: jnp.asarray(_np(v.t() if k == "w_i8" else v)) for k, v in p.items()}
            if isinstance(xin, tq.QuantRows):  # the rows of a fused norm or the GELU mode
                ref = np.asarray(jq.int8_linear_pre(leaf, jnp.asarray(_np(xin.codes)),
                                                    jnp.asarray(_np(xin.scale)), jnp.float32))
            else:
                ref = np.asarray(jq.int8_linear(leaf, jnp.asarray(_np(xin))))
            np.testing.assert_allclose(_np(y), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    monkeypatch.setattr(tm, "int8_linear", real)
    monkeypatch.setattr(tm, "takes_quantized", real_takes)
    _, _, _, tf = BACKBONES[backbone][0](seed=5)
    f32 = _np(tfwd(tf, tstat(tarch), _t(x), _t(cond), _t(text), _t(time), lengths=_t(lens),
                   cfg_infer=True))
    lens2 = np.concatenate([lens, lens])
    got, want, f32 = (_live(a, lens2) for a in (got, want, f32))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    drift = np.linalg.norm(got - f32) / np.linalg.norm(f32)
    assert rel <= FWD_REL_L2 and rel < 0.5 * drift, (rel, drift)


def test_self_attention_unfused_int8_quantizes_once(monkeypatch):
    """Unfused int8 q / k / v share one row quantize (the JAX package's
    `self_attention`): the rows a block's norm hands over quantized
    (`QuantRows`) reach all three, and to_out quantizes its own input once;
    the output as the JAX one's on the unquantized input."""
    tree = np_params(lambda: jm.init_attention(jax.random.PRNGKey(0), 128, 2, 64), 6)
    jp = jq.quantize_dit_params({"blocks": {"attn": jx(tree)}})["blocks"]["attn"]
    tp = tq.quantize_dit_params({"blocks": [{"attn": tm.tree_map(_t, tree)}]})["blocks"][0]["attn"]
    assert tm.takes_quantized(*tm.attention_inputs(tp))
    rng = np.random.default_rng(6)
    n = 128
    x = rng.standard_normal((2, n, 128)).astype(np.float32)
    rows = tm.QuantRows(*tq.quantize_rows(_t(x)), torch.float32)
    calls, inputs = [], []
    real, real_linear = tq.quantize_rows, tm.int8_linear
    monkeypatch.setattr(tq, "quantize_rows", lambda x: calls.append(1) or real(x))
    monkeypatch.setattr(tm, "int8_linear", lambda p, x: inputs.append(x) or real_linear(p, x))
    lens = np.array([n, 77], np.int32)
    want = np.asarray(jm.self_attention(jp, jnp.asarray(x), 2, jrope.rope_freqs_interleaved(64, n),
                                        jnp.asarray(lens), backend="xla"))
    tang = trope.rope_freqs_interleaved(64, n)
    tabs = trope.rope_flat_tables(tang, n, 2, None, dtype=torch.float32)
    got = _np(tm.self_attention(tp, rows, 2, tabs, _t(lens), tang))
    assert calls == [1] and len(inputs) == 4 and all(r is rows for r in inputs[:3])
    np.testing.assert_allclose(_live(got, lens), _live(want, lens), atol=FWD_TOL, rtol=FWD_TOL)


# ---------------------------------------------------------------------------
# K12's fused modes: K1Q, K6Q and the GELU mode (their plain versions here)
# ---------------------------------------------------------------------------

TIES = np.resize(np.arange(-60, 60) + 0.5, 256)  # .5 steps of a row whose scale is 1
GELU_TIES = np.resize(np.arange(10, 70) + 0.5, 256)  # GELU(x) = x exactly for x >= 10


def _fused_case(mode: str, dtype: str):
    """(the JAX chain's rows before the quantize, its codes and scales, the
    port's plain version's codes and scales, the port's rows before the
    quantize) for x [2, 33, 256] from a seed. Row (0, 5) comes out all
    zero; row (1, 7) exactly on .5 steps with scale 1: for the AdaLN a
    constant x row is its batch's shift, for the RMSNorm a row of 1024s
    (mean square 2^20, eps lost to rounding) is the weight, GELU(x) = x
    for x >= 10."""
    rng = np.random.default_rng({"adaln": 20, "rms": 21, "gelu": 22}[mode])
    d = 256
    x = (rng.standard_normal((2, 33, d)) * 2 + 0.3).astype(np.float32)
    x[0, 5] = 0.0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if mode == "adaln":
        mods = (0.2 * rng.standard_normal((2, 6 * d))).astype(np.float32)
        mods[0, :d] = 0.0  # batch 0's shift: its zero row stays zero
        mods[1, :d] = TIES
        mods[1, 0] = 127.0
        x[1, 7] = 0.0
        shift, scale = mods[:, :d], mods[:, d:2 * d]
        xj, scj, shj = (jnp.asarray(a).astype(jdt) for a in (x, scale, shift))
        yj = jan.adaln_norm_ref(xj, scj, shj)
        xt, sct, sht = (_t(a).to(tdt) for a in (x, scale, shift))
        yt = tan.adaln_norm_ref(xt, sct, sht)
        ct, st = tan.adaln_norm_quant(xt, sct, sht)
    elif mode == "rms":
        w = TIES.astype(np.float32).copy()
        w[0] = 127.0
        x[1, 7] = 1024.0
        xj = jnp.asarray(x).astype(jdt)
        yj = jan.rms_norm_ref(xj, jnp.asarray(w))
        xt = _t(x).to(tdt)
        yt = tan.rms_norm_ref(xt, _t(w))
        ct, st = tan.rms_norm_quant(xt, _t(w))
    else:
        x[1, 7] = GELU_TIES
        x[1, 7, 0] = 127.0
        xj = jnp.asarray(x).astype(jdt)
        yj = jax.nn.gelu(xj, approximate=True)
        xt = _t(x).to(tdt)
        yt = torch.nn.functional.gelu(xt, approximate="tanh")
        ct, st = tq.gelu_quantize_rows(xt)
    cj, sj = jq.quantize_rows(yj)
    return yj, np.asarray(cj), np.asarray(sj), _np(ct), _np(st), yt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaln", "rms", "gelu"])
def test_fused_quantize_plain_matches_jax(mode, dtype):
    """The plain versions of K1Q, K6Q and the GELU mode against the JAX
    chains (the module docstring's tolerances)."""
    yj, cj, sj, ct, st, yt = _fused_case(mode, dtype)
    assert ct.dtype == np.int8 and st.dtype == np.float32 and st.shape == (2, 33, 1)
    # the JAX rows through both quantizes: bit-equal
    qc, qs = tq.quantize_rows(_t(np.asarray(yj.astype(jnp.float32))).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(_np(qc), cj)
    np.testing.assert_array_equal(_np(qs), sj)
    # the all-zero row and the row of .5 steps, exactly
    for c, sc in ((ct, st), (cj, sj)):
        assert not c[0, 5].any() and sc[0, 5, 0] == 1.0
        assert sc[1, 7, 0] == 1.0
        np.testing.assert_array_equal(c[1, 7, 1:], np.round(np.asarray(
            (TIES if mode != "gelu" else GELU_TIES)[1:])).astype(np.int8))
    yjf = np.asarray(yj.astype(jnp.float32))
    ytf = _np(yt.float())
    if np.array_equal(ytf, yjf):
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(st, sj)
        return
    diff = np.abs(ytf - yjf).max(axis=-1, keepdims=True)
    moved = ct.astype(np.int32) != cj.astype(np.int32)
    print(f"{mode} {dtype}: {int((ytf != yjf).sum())} of {ytf.size} rows' values and "
          f"{int((st != sj).sum())} of {st.size} scales differ, {int(moved.sum())} codes moved")
    assert np.abs(ct.astype(np.int32) - cj.astype(np.int32)).max() <= 1
    # a code moves only where its value or its row's scale differs
    assert not (moved & (ytf == yjf) & (st == sj)).any()
    assert (np.abs(st - sj) <= diff / 127 * (1 + 1e-6) + np.spacing(sj)).all()


def _forward_case(backbone: str, smooth: bool = False, dtype=torch.float32):
    """The backbone's int8 cfg_infer forward (port only) on seeded inputs."""
    _, _, tfwd, tstat, _, n = BACKBONES[backbone]
    _, tarch, _, tp = _quantized_pair(backbone, smooth)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, n, 100)).astype(np.float32)
    cond = rng.standard_normal((2, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (2, 64)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 141], np.int32)
    return lambda: tfwd(tm.tree_cast(tp, dtype), tstat(tarch), _t(x), _t(cond), _t(text),
                        _t(np.array([0.3, 0.7], np.float32)), lengths=_t(lens), cfg_infer=True,
                        dtype=dtype)


FUSED = ("adaln_norm_quant", "rms_norm_quant", "gelu_quantize_rows")


def _count_fused(monkeypatch) -> dict:
    """Counts the calls `modules` makes to each fused quantize."""
    calls = {name: 0 for name in FUSED}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    for name in FUSED:
        monkeypatch.setattr(tm, name, counted(name, getattr(tm, name)))
    return calls


@pytest.mark.parametrize("backbone,dtype", [("DiT", torch.float32), ("DiT", torch.bfloat16),
                                            ("UNetT", torch.float32), ("MMDiT", torch.float32)])
def test_int8_forward_fused_modes_bit_identical(backbone, dtype, monkeypatch):
    """The rewired int8 forward (the norms before to_qkv and ff.in write
    quantized rows, ff.out's input from the GELU mode) equals, bit for bit,
    the same forward with every fused mode switched off (bf16 rows, then
    `quantize_rows` before each projection: the path before the fused
    modes), on the CPU where each mode runs its plain version."""
    forward = _forward_case(backbone, dtype=dtype)
    calls = _count_fused(monkeypatch)
    fused = forward()
    norm = "rms_norm_quant" if backbone == "UNetT" else "adaln_norm_quant"
    # two norms a block, the MMDiT four (three in its last block); one GELU
    # mode a feed-forward
    want = {"DiT": (4, 2), "UNetT": (4, 2), "MMDiT": (7, 3)}[backbone]
    assert (calls[norm], calls["gelu_quantize_rows"]) == want, calls
    monkeypatch.setattr(tm, "takes_quantized", lambda *leaves: False)
    assert torch.equal(fused, forward())


def test_quantized_rows_dispatch(monkeypatch):
    """The fused norms run only where every reader of the rows is an int8
    leaf without the hedge: with smooth=True the norms write bf16 rows (the
    hedged to_qkv and ff.in quantize their masked rows themselves) while
    ff.out, which has no hedge, still takes the GELU mode; bf16 params run
    none of them. Pre-quantized rows handed to a hedged leaf or a bf16 leaf
    raise."""
    calls = _count_fused(monkeypatch)
    _forward_case("DiT", smooth=True)()
    assert calls == {"adaln_norm_quant": 0, "rms_norm_quant": 0, "gelu_quantize_rows": 2}
    calls.update({name: 0 for name in FUSED})
    _, tarch, _, tp = small_dit(seed=5)
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((1, 64, 100)).astype(np.float32))
    tdit.dit_forward(tp, tdit.DiTStatics(tarch), x, x, _t(np.zeros((1, 8), np.int32)),
                     _t(np.array([0.5], np.float32)))
    assert calls == {name: 0 for name in FUSED}
    _, _, _, hedged = _quantized_pair("DiT", smooth=True)
    rows = tm.QuantRows(*tq.quantize_rows(_t(rng.standard_normal((1, 4, 128)).astype(
        np.float32))), torch.float32)
    with pytest.raises(ValueError, match="outlier hedge"):
        tm.linear(hedged["blocks"][0]["attn"]["to_qkv"], rows)
    with pytest.raises(TypeError, match="int8 leaf"):
        tm.linear(tp["blocks"][0]["attn"]["to_qkv"], rows)
    assert tm.linear(hedged["blocks"][0]["attn"]["to_out"], rows).shape == (1, 4, 128)


@pytest.fixture(scope="module")
def pinyin_pipelines():
    """The port's and the JAX pipeline, int8 + pinyin (the Emilia vocab,
    2545 ids), the same numpy-seeded tiny DiT and Vocos, f32."""
    from f5tts_tpu.infer import pipeline as jpipe
    from f5tts_tpu.text.vocab import load_vocab
    from f5tts_tpu.vocoder import vocos as jvocos
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.convert import vocos_params_from_jax
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    arch = dict(SMALL, text_num_embeds=2545)
    jarch = JArch(**arch)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 7)
    jvcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jvcfg), 4)
    vocab = load_vocab(EMILIA_VOCAB)
    port = tpipe.InferencePipeline(
        dit_params_from_jax(tree), tdit.DiTStatics(TArch(**arch)),
        tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**SMALL_VOCOS),
                     device="cpu"), vocab, sampling=SamplingConfig(nfe_steps=2),
        dtype=torch.float32, device="cpu", quantization="int8")
    jax_pipe = jpipe.InferencePipeline(jx(tree), jdit.DiTStatics(jarch),
                                       jvocos.Vocos(jx(vtree), jvcfg), vocab, dtype=jnp.float32,
                                       backend="xla", quantization="int8")
    return port, jax_pipe


def test_pipeline_int8_pinyin_matches_jax(pinyin_pipelines):
    """`generate_chunk` (pinyin ids, int8 backbone) against the JAX pipeline's
    steps with the port's noise; unknown quantization values raise."""
    from f5tts_tpu.infer import pipeline as jpipe
    from f5tts_tpu.models import cfm as jcfm
    from f5tts_tpu.utils import duration_bucket as j_duration_bucket
    from f5tts_tpu.utils import make_time_grid as j_make_time_grid
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.models import cfm as tcfm
    from tests.test_torch_pipeline import _ref_wav

    port, jax_pipe = pinyin_pipelines
    assert port.tokenizer == jax_pipe.tokenizer == "pinyin"
    assert "w_i8" in port.params["blocks"][0]["attn"]["to_qkv"]
    ref_wav, ref_text, gen_text, seed = _ref_wav(), "一个安静的声音。", "你好, friend.", 3
    wave, gen_mel = port.generate_chunk(ref_wav, ref_text, gen_text, seed=seed, nfe_step=2)

    rms = float(np.sqrt(np.mean(ref_wav ** 2)))
    ref_mel = port.ref_mel(ref_wav * (0.1 / rms))  # the front end is held to 1e-3 elsewhere
    ref_frames = ref_mel.shape[0]
    ids = jax_pipe.tokenize([ref_text + gen_text])
    np.testing.assert_array_equal(port.tokenize([ref_text + gen_text]), ids)
    total = jpipe.estimate_duration_frames(ref_frames, ref_text, gen_text)
    total = int(jcfm.compute_duration(jnp.asarray((ids != -1).sum(axis=1)),
                                      jnp.asarray([ref_frames]), jnp.asarray([total]), 4096)[0])
    n = j_duration_bucket(total, 256, 4096)
    cond = np.zeros((1, n, 100), np.float32)
    cond[0, :ref_frames] = ref_mel
    y0 = _np(tcfm.make_noise(torch.Generator().manual_seed(seed), 1, n, 100,
                             torch.tensor([total]), noise_max_len=4096))
    mel = jcfm.cfm_sample(jax_pipe.params, jax_pipe.statics, jnp.asarray(cond), jnp.asarray(ids),
                          jnp.asarray([ref_frames]), jnp.asarray([total]),
                          j_make_time_grid(2, sway_sampling_coef=-1.0), y0=jnp.asarray(y0),
                          cfg_strength=2.0, dtype=jnp.float32, backend="xla")
    wave_full = np.asarray(jax_pipe.vocoder(jnp.transpose(mel, (0, 2, 1))))
    want = wave_full[0, ref_frames * 256: min(total * 256, wave_full.shape[1])] * (rms / 0.1)
    want_mel = np.asarray(mel)[0, ref_frames:total].T
    assert wave.shape == want.shape and gen_mel.shape == want_mel.shape
    for a, b in ((gen_mel, want_mel), (wave, want)):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= PIPE_REL_L2
    with pytest.raises(ValueError, match="unknown quantization"):
        tpipe.InferencePipeline(port.params, port.statics, port.vocoder, device="cpu",
                                quantization="fp8")
