"""Plain versions of kernels K8, K7's lse mode and K9 against the Pallas bodies
they replace, in interpret mode, on the CPU.

- K8 `fused_qkv_rope_attention_bias_bwd_ref` (the backward of the key-masked
  flat attention) against `_fused_bias_bwd_pallas` (joint n <= 1536) and
  `_fused_qkv_bwd_pallas_long` with the bias row (the (1536, 4096] band), at
  joint 256 and 384 with dead keys mid-sequence and an unmasked cotangent,
  and both against `jax.vjp` of `_bias_decomposed_ref`;
- K7's lse `flash_attention_fwd_ref(..., return_lse=True)` against
  `_flash_forward(..., return_lse=True)` over live rows, both Pallas bodies,
  at d = 64 and 128 and at the wide mode's 160, 256 and 320 (K9 below too:
  the fused body at 160 / 256 / 320, the split pair at 256);
- K9 `flash_attention_bwd_ref` against `_flash_backward_fused`, the split
  `_flash_bwd_dq_kernel` + `_flash_bwd_dkv_kernel` (reached by a one-shot
  `_pick_block` that returns a non-divisor: `_flash_backward` never reaches
  them otherwise) and `jax.vjp(flash_attention)`, with the cotangent zero on
  rows >= length as the model's mask makes it; and against
  `_flash_backward_fused` with the cotangent nonzero on every row, from K7's
  plain lse mode (rows past the length inside the last live q tile carry a
  gradient);
- K5's lse mode: the plain forward's row lse against the logsumexp of the JAX
  scores on the same roped heads (tolerance 1e-5); K8's function from the
  saved lse, `fused_qkv_rope_attention_bias_bwd_from_lse_ref`, fed the plain
  forward's out and lse, against `jax.grad` through the JAX
  `fused_qkv_rope_attention_bias` with the Pallas backward (FORCE_FLAT_BWD,
  interpret mode) at joint n = 256 / 1152;
- each plain backward is the autograd of its plain forward, and the
  differentiable wrappers take the from-lse ones on the CPU without counting
  a launch.
All f32 on numpy-seeded inputs: the differences are sum orders (tolerance
3e-4, the JAX package's own for its long backward kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.ops import attention as jatt
from f5tts_tpu.ops import rope as jrope
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=3e-4, rtol=3e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _joint(n, heads=2, d=64, b=2, seed=0):
    """qkv, joint cos/sin (the last 128 rows restart at position 0, as MMDiT
    joins its text table to the audio one), a key mask with dead keys mid
    sequence and in the text tail, and an unmasked cotangent."""
    rng = np.random.default_rng(seed + n)
    hd = heads * d
    qkv = rng.standard_normal((b, n, 3 * hd)).astype(np.float32)
    kmask = np.ones((b, n), bool)
    kmask[0, n // 3: n // 2] = False
    kmask[1, n // 4: n // 2] = False
    kmask[1, n - n // 8:] = False
    ang = jrope.rope_freqs_interleaved(d, n)
    ca, sa = jrope.rope_flat_tables(ang, n - 128, heads, dtype=jnp.float32)
    ct, st = jrope.rope_flat_tables(ang, 128, heads, dtype=jnp.float32)
    cos, sin = np.asarray(jnp.concatenate([ca, ct])), np.asarray(jnp.concatenate([sa, st]))
    ct_ = rng.standard_normal((b, n, hd)).astype(np.float32)
    return qkv, cos, sin, kmask, ct_


@pytest.mark.parametrize("n,body,d", [(256, "whole", 64), (256, "long", 64), (384, "whole", 64),
                                      (384, "long", 64), (256, "whole", 128)],
                         ids=["256-whole", "256-long", "384-whole", "384-long", "d128-256-whole"])
def test_bias_bwd_plain_matches_pallas(n, body, d):
    heads = 2
    qkv, cos, sin, kmask, do = _joint(n, d=d)
    args = [jnp.asarray(a) for a in (qkv, cos, sin)]
    if body == "whole":
        pallas = jatt._fused_bias_bwd_pallas(*args, jnp.asarray(kmask), jnp.asarray(do), heads)
    else:  # the long body takes the key mask as its additive bias row
        bias = jnp.where(jnp.asarray(kmask), 0.0, jatt.NEG_INF).astype(jnp.float32)[:, None, :]
        pallas = jatt._fused_qkv_bwd_pallas_long(*args, bias, jnp.asarray(do), heads)
    _, vjp = jax.vjp(lambda x: jatt._bias_decomposed_ref(x, args[1], args[2],
                                                         jnp.asarray(kmask), heads), args[0])
    (xla,) = vjp(jnp.asarray(do))
    got = _np(tatt.fused_qkv_rope_attention_bias_bwd_ref(_t(qkv), _t(cos), _t(sin), _t(kmask),
                                                         _t(do), heads))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    hd = heads * d
    dead = ~kmask
    assert not got[:, :, hd:][dead].any()  # dead keys: dk = dv = 0 exactly
    assert np.abs(got[:, :, :hd][dead]).max() > 0  # dead rows still get their dq


@pytest.mark.parametrize("n,d", [(256, 64), (384, 64), (256, 128)], ids=["256", "384", "d128-256"])
def test_bias_lse_plain_matches_jax_scores(n, d):
    heads = 2
    qkv, cos, sin, kmask, _ = _joint(n, d=d)
    q, k, _v = jnp.split(jnp.asarray(qkv), 3, axis=-1)
    qh, kh = (jrope.apply_rotary_flat_tables(t, jnp.asarray(cos), jnp.asarray(sin))
              .reshape(2, n, heads, d).transpose(0, 2, 1, 3) for t in (q, k))
    scores = jnp.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(d)
    scores = jnp.where(jnp.asarray(kmask)[:, None, None, :], scores, jatt.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    o, lse = tatt.fused_qkv_rope_attention_bias_ref(_t(qkv), _t(cos), _t(sin), _t(kmask), heads,
                                                    return_lse=True)
    assert lse.shape == (2, heads, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(lse), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(o), _np(tatt.fused_qkv_rope_attention_bias_ref(
        _t(qkv), _t(cos), _t(sin), _t(kmask), heads)))


@pytest.mark.parametrize("n,d", [(256, 64), (1152, 64), (256, 128)],
                         ids=["256", "1152", "d128-256"])
def test_bias_bwd_from_lse_matches_pallas_grad(n, d, monkeypatch):
    monkeypatch.setattr(jatt, "FORCE_FLAT_BWD", True)
    heads = 2
    qkv, cos, sin, kmask, do = _joint(n, d=d)
    jc, js, jk = jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kmask)
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        jatt.fused_qkv_rope_attention_bias(x, jc, js, jk, heads) * jnp.asarray(do)))(
            jnp.asarray(qkv)))
    o, lse = tatt.fused_qkv_rope_attention_bias_ref(_t(qkv), _t(cos), _t(sin), _t(kmask), heads,
                                                    return_lse=True)
    got = _np(tatt.fused_qkv_rope_attention_bias_bwd_from_lse_ref(
        _t(qkv), _t(cos), _t(sin), _t(kmask), o, lse, _t(do), heads))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[:, :, 2 * d:][~kmask].any()  # dead keys: dk = dv = 0 exactly


@pytest.mark.parametrize("body,n,lengths,d", [("single", 256, [256, 177], 64),
                                              ("loop", 384, [384, 70], 64),
                                              ("single", 256, [256, 177], 128),
                                              ("single", 256, [256, 177], 256),
                                              ("loop", 384, [384, 70], 160),
                                              ("single", 256, [256, 177], 320)],
                         ids=["single-256-lengths0", "loop-384-lengths1",
                              "d128-single-256-lengths0", "d256-single-256-lengths0",
                              "d160-loop-384-lengths1", "d320-single-256-lengths0"])
def test_flash_lse_plain_matches_pallas(body, n, lengths, d, monkeypatch):
    if body == "loop":  # the online-softmax body over three 128-key blocks
        monkeypatch.setattr(jatt, "SINGLE_PASS_MAX_N", 0)
    rng = np.random.default_rng(n + 1)
    q, k, v = (rng.standard_normal((2, 2, n, d)).astype(np.float32) for _ in range(3))
    lens = np.array(lengths, np.int32)
    o_j, lse_j = jatt._flash_forward(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(lens),
                                     return_lse=True)
    o, lse = tatt.flash_attention_fwd_ref(_t(q), _t(k), _t(v), _t(lens), return_lse=True)
    o, lse, lse_j = _np(o), _np(lse), np.asarray(lse_j)[..., 0]
    assert lse.shape == (2, 2, n) and lse.dtype == np.float32
    for i, ln in enumerate(lens):
        np.testing.assert_allclose(lse[i, :, :ln], lse_j[i, :, :ln], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(o[i, :, :ln], np.asarray(o_j)[i, :, :ln], atol=2e-5)
        tile_end = -(-ln // 64) * 64  # K7's 64-row tiles past the length
        assert (lse[i, :, tile_end:] == tatt.NEG_INF).all() and not o[i, :, tile_end:].any()
        assert np.isfinite(lse[i, :, :tile_end]).all()


def _flash_case(n, lengths, seed=3, d=64):
    rng = np.random.default_rng(seed + n)
    q, k, v = (rng.standard_normal((2, 2, n, d)).astype(np.float32) for _ in range(3))
    lens = np.array(lengths, np.int32)
    do = rng.standard_normal((2, 2, n, d)).astype(np.float32)
    do *= (np.arange(n)[None, :] < lens[:, None])[:, None, :, None]  # the model's row mask
    return q, k, v, lens, do


_FLASH_BWD = [(n, ln, route, 64) for n, ln in ((256, [256, 177]), (384, [384, 70]))
              for route in ("fused", "split", "vjp")]


# head widths past 128 (K9's wide mode on the card): the fused body and the
# split pair
_FLASH_BWD_WIDE = [(256, [256, 177], "fused", 256), (384, [384, 70], "split", 256),
                   (256, [256, 177], "fused", 160), (384, [384, 70], "fused", 320)]


@pytest.mark.parametrize(
    "n,lengths,route,d", _FLASH_BWD + [(256, [256, 177], "fused", 128)] + _FLASH_BWD_WIDE,
    ids=[f"{n}-lengths{i // 3}-{r}" for i, (n, _, r, _) in enumerate(_FLASH_BWD)]
    + ["d128-256-lengths0-fused"]
    + [f"d{d}-{n}-lengths{int(n == 384)}-{r}" for n, _, r, d in _FLASH_BWD_WIDE])
def test_flash_bwd_plain_matches_pallas(route, n, lengths, d, monkeypatch):
    q, k, v, lens, do = _flash_case(n, lengths, d=d)
    jq, jk, jv, jl, jdo = (jnp.asarray(t) for t in (q, k, v, lens, do))
    o_j, lse_j = jatt._flash_forward(jq, jk, jv, jl, return_lse=True)
    if route == "vjp":  # the custom_vjp as training reaches it
        _, vjp = jax.vjp(lambda a, b_, c: jatt.flash_attention(a, b_, c, jl), jq, jk, jv)
        want = vjp(jdo)
        o, lse = tatt.flash_attention_fwd_ref(_t(q), _t(k), _t(v), _t(lens), return_lse=True)
    else:
        if route == "split":  # one non-divisor, then the real block sizes
            real, calls = jatt._pick_block, []

            def once(m, candidates=(512, 256, 128)):
                calls.append(m)
                return m + 1 if len(calls) == 1 else real(m, candidates)

            monkeypatch.setattr(jatt, "_pick_block", once)
            want = jatt._flash_backward(jq, jk, jv, jl, o_j, lse_j, jdo)
            assert len(calls) == 3  # the gate, then block_q and block_k
        else:
            want = jatt._flash_backward_fused(jq, jk, jv, jl, o_j, lse_j, jdo)
        o, lse = _t(o_j), _t(np.asarray(lse_j)[..., 0])  # the same saved residuals
    got = tatt.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(lens), o, lse, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    tile_end = -(-lengths[1] // 64) * 64
    assert not _np(got[0])[1, :, tile_end:].any()  # dq of dead tiles
    for g in got[1:]:  # dk, dv of dead keys
        assert not _np(g)[1, :, lengths[1]:].any()


@pytest.mark.parametrize("n,lengths", [(256, [256, 177]), (384, [384, 70])])
def test_flash_bwd_plain_with_do_past_the_length_matches_pallas(n, lengths):
    """K9's function when dO is nonzero on every row: rows past the length
    inside the last live 64-row q tile have a real lse (K7 computes them, as
    Pallas does), so their dO carries a gradient. The plain version against
    `_flash_backward_fused` on the same saved residuals: K7's plain lse mode
    (those rows real, the q tiles past them -1e30)."""
    rng = np.random.default_rng(n + 9)
    q, k, v, do = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(4))
    lens = np.array(lengths, np.int32)
    o, lse = tatt.flash_attention_fwd_ref(_t(q), _t(k), _t(v), _t(lens), return_lse=True)
    lse_lanes = jnp.broadcast_to(jnp.asarray(_np(lse))[..., None], (*lse.shape, jatt.LSE_LANES))
    want = jatt._flash_backward_fused(*(jnp.asarray(t) for t in (q, k, v, lens)),
                                      jnp.asarray(_np(o)), lse_lanes, jnp.asarray(do))
    got = tatt.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(lens), o, lse, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    tile_end = -(-lengths[1] // 64) * 64
    dq = _np(got[0])[1]
    assert dq[:, lengths[1]:tile_end].any()  # those rows' dq
    assert not dq[:, tile_end:].any()  # dq of the dead tiles
    for g in got[1:]:  # dk, dv of dead keys
        assert not _np(g)[1, :, lengths[1]:].any()


def test_plain_backwards_are_the_autograd_of_the_plain_forwards():
    """With no rounding between them (f32), each plain backward equals torch
    autograd of its plain forward, for any cotangent: K8's on every row,
    K9's on the zeroed dead q tiles too."""
    rng = np.random.default_rng(5)
    b, h, n, d = 2, 2, 200, 64
    qkv = _t(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)).requires_grad_()
    cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n), n, h, dtype=torch.float32)
    kmask = torch.ones(b, n, dtype=torch.bool)
    kmask[0, 50:90] = False
    kmask[1, 150:] = False
    do = _t(rng.standard_normal((b, n, h * d)).astype(np.float32))
    (want,) = torch.autograd.grad(tatt.fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, h),
                                  qkv, do)
    got = tatt.fused_qkv_rope_attention_bias_bwd_ref(qkv.detach(), cos, sin, kmask, do, h)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6)
    q, k, v = (_t(rng.standard_normal((b, h, n, d)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    lens = torch.tensor([n, 77], dtype=torch.int32)
    do = _t(rng.standard_normal((b, h, n, d)).astype(np.float32))  # not masked
    want = torch.autograd.grad(tatt.flash_attention_fwd_ref(q, k, v, lens), (q, k, v), do)
    o, lse = tatt.flash_attention_fwd_ref(q.detach(), k.detach(), v.detach(), lens, True)
    got = tatt.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), lens, o, lse, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-6)


def test_differentiable_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    calls = []
    for name in ("fused_qkv_rope_attention_bias_bwd_from_lse_ref", "flash_attention_bwd_ref"):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name,
                            lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    _build.reset_launches()
    qkv = torch.randn(1, 64, 3 * 128, requires_grad=True)
    tab = torch.ones(64, 128), torch.zeros(64, 128)
    out = tatt.fused_qkv_rope_attention_bias(qkv, *tab, torch.ones(1, 64, dtype=torch.bool), 2)
    out.sum().backward()
    q = torch.randn(1, 2, 64, 64, requires_grad=True)
    tatt.attention(q, q, q, torch.tensor([40])).sum().backward()
    assert calls == ["fused_qkv_rope_attention_bias_bwd_from_lse_ref", "flash_attention_bwd_ref"]
    assert qkv.grad.shape == qkv.shape and q.grad.shape == q.shape
    assert _build.launches() == {}


def test_backward_wrappers_refuse_other_devices():
    meta = {"device": "meta"}
    qkv, tab = torch.empty(1, 64, 384, **meta), torch.empty(64, 128, **meta)
    with pytest.raises(ValueError):
        tatt.fused_qkv_rope_attention_bias_bwd(qkv, tab, tab,
                                               torch.empty(1, 64, dtype=torch.bool, **meta),
                                               torch.empty(1, 64, 128, **meta),
                                               torch.empty(1, 2, 64, **meta),
                                               torch.empty(1, 64, 128, **meta), 2)
    q = torch.empty(1, 2, 64, 64, **meta)
    lens = torch.empty(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        tatt.flash_attention_fwd(q, q, q, lens, return_lse=True)
    with pytest.raises(ValueError):
        tatt.flash_attention_bwd(q, q, q, lens, q, torch.empty(1, 2, 64, **meta), q)
