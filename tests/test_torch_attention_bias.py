"""Plain versions of kernels K5, K6 and K7 against the Pallas bodies they
replace, in interpret mode, on the CPU.

- K5 `fused_qkv_rope_attention_bias_ref` against the JAX
  `fused_qkv_rope_attention_bias` forced onto its Pallas kernel
  (`FORCE_BIAS_KERNEL`), both bodies (`FLAT_SINGLE_PASS_MAX_N` lowered to
  force the streaming one at a small n), and against the JAX
  `_bias_decomposed_ref`, with dead keys in the middle of the sequence; at
  a ragged n with two consecutive all-dead 64-key tiles against
  `_bias_decomposed_ref`, its lse against the JAX scores' logsumexp;
- K7 `mha_reference` (the `flash_attention` plain version) against the JAX
  `flash_attention` in both bodies (`SINGLE_PASS_MAX_N` set to 0 for the
  online-softmax loop), live rows;
- K6 `rms_norm_ref` against `_rms_norm_fwd_pallas` at eps 1e-8, and its
  autograd against the JAX `rms_norm_fused` VJP; at qk-norm's head width
  in bf16 (one bf16 ulp); on the head view of a projection, bit-equal to
  the `split_heads` copy; `_rms_check` on that view and on what it refuses;
- the wrappers take the plain versions for CPU tensors and count no launch.
All f32 on numpy-seeded inputs; differences are sum orders (atol 2e-5, as
`tests/test_torch_ops.py` holds K3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.ops import adaln_norm as jan
from f5tts_tpu.ops import attention as jatt
from f5tts_tpu.ops import rope as jrope
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import adaln_norm as tan
from f5tts_tpu_torch.ops import attention as tatt
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _live(a, lengths):
    return np.concatenate([a[i, :l] for i, l in enumerate(lengths)], axis=0)


# ---------------------------------------------------------------------------
# K5: key-masked flat fused QKV + RoPE attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,n", [("single", 256), ("stream", 1152)])
def test_bias_attention_plain_matches_pallas(body, n, monkeypatch):
    monkeypatch.setattr(jatt, "FORCE_BIAS_KERNEL", True)
    if body == "stream":  # the online-softmax body, over one 1024-key block and a tail
        monkeypatch.setattr(jatt, "FLAT_SINGLE_PASS_MAX_N", 128)
    heads, d, b = 2, 64, 2
    hd = heads * d
    rng = np.random.default_rng(21)
    qkv = rng.standard_normal((b, n, 3 * hd)).astype(np.float32)
    kmask = np.ones((b, n), bool)
    kmask[0, n // 3: n // 2] = False      # dead keys mid-sequence (audio padding)
    kmask[1, n // 4: n // 2] = False
    kmask[1, n - n // 8:] = False         # and the text stream's pad
    # joint tables: the first rows rotate with one stream's positions, the
    # rest restart at 0, as MMDiT joins its audio and text tables
    split = n - 128
    ang = jrope.rope_freqs_interleaved(d, n)
    ca, sa = jrope.rope_flat_tables(ang, split, heads, dtype=jnp.float32)
    ct, st = jrope.rope_flat_tables(ang, n - split, heads, dtype=jnp.float32)
    cos, sin = jnp.concatenate([ca, ct]), jnp.concatenate([sa, st])
    pallas = np.asarray(jatt.fused_qkv_rope_attention_bias(
        jnp.asarray(qkv), cos, sin, jnp.asarray(kmask), heads))
    xla = np.asarray(jatt._bias_decomposed_ref(jnp.asarray(qkv), cos, sin, jnp.asarray(kmask),
                                               heads))
    got = _np(tatt.fused_qkv_rope_attention_bias(_t(qkv), _t(np.asarray(cos)),
                                                 _t(np.asarray(sin)), _t(kmask), heads))
    assert got.shape == (b, n, hd)
    # every row is computed (dead rows too, as the Pallas kernel does)
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5)


@pytest.mark.parametrize("n", [200, 1124])
def test_bias_attention_plain_at_a_ragged_n_with_dead_tiles(n):
    """K5's plain version (and its lse mode) at an n that is no multiple of
    64, with two consecutive all-dead 64-key tiles in the middle of row 1 and
    a dead tail in the last, partial tile of row 0, against the JAX
    `_bias_decomposed_ref` (the JAX wrapper takes its Pallas body only at n %
    128 == 0) and the logsumexp of the JAX scores."""
    heads, d, b = 2, 64, 2
    hd = heads * d
    rng = np.random.default_rng(n + 24)
    qkv = rng.standard_normal((b, n, 3 * hd)).astype(np.float32)
    kmask = np.ones((b, n), bool)
    kmask[1, 64:192] = False              # tiles 1 and 2 dead
    kmask[0, n - n // 5:] = False         # a dead tail
    kmask[0, n // 3: n // 3 + 7] = False  # and a few keys mid-tile
    split = n - 100
    ang = jrope.rope_freqs_interleaved(d, n)
    ca, sa = jrope.rope_flat_tables(ang, split, heads, dtype=jnp.float32)
    ct, st = jrope.rope_flat_tables(ang, n - split, heads, dtype=jnp.float32)
    cos, sin = jnp.concatenate([ca, ct]), jnp.concatenate([sa, st])
    want = np.asarray(jatt._bias_decomposed_ref(jnp.asarray(qkv), cos, sin, jnp.asarray(kmask),
                                                heads))
    got, lse = tatt.fused_qkv_rope_attention_bias_ref(_t(qkv), _t(np.asarray(cos)),
                                                      _t(np.asarray(sin)), _t(kmask), heads,
                                                      return_lse=True)
    np.testing.assert_allclose(_np(got), want, atol=2e-5)
    q, k, _v = jnp.split(jnp.asarray(qkv), 3, axis=-1)
    qh, kh = (jrope.apply_rotary_flat_tables(t, cos, sin).reshape(b, n, heads, d)
              .transpose(0, 2, 1, 3) for t in (q, k))
    scores = jnp.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(d)
    scores = jnp.where(jnp.asarray(kmask)[:, None, None, :], scores, jatt.NEG_INF)
    np.testing.assert_allclose(_np(lse), np.asarray(jax.nn.logsumexp(scores, axis=-1)),
                               atol=1e-5, rtol=1e-5)


def test_bias_attention_equals_prefix_attention_on_a_prefix_mask():
    """Under a prefix mask K5's plain version is K3's on live rows."""
    heads, n = 2, 192
    rng = np.random.default_rng(22)
    qkv = _t(rng.standard_normal((2, n, 3 * 128)).astype(np.float32))
    cos, sin = (_t(np.asarray(t)) for t in jrope.rope_flat_tables(
        jrope.rope_freqs_interleaved(64, n), n, heads, dtype=jnp.float32))
    lens = np.array([n, 100], np.int32)
    kmask = torch.arange(n)[None, :] < _t(lens)[:, None]
    a = _np(tatt.fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, heads))
    b = _np(tatt.fused_qkv_rope_attention(qkv, cos, sin, _t(lens), heads))
    np.testing.assert_allclose(_live(a, lens), _live(b, lens), atol=1e-6)


# ---------------------------------------------------------------------------
# K7: head-layout attention over keys < lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,n,lengths", [("single", 256, [256, 177]),
                                            ("loop", 384, [384, 200])])
def test_flash_plain_matches_pallas(body, n, lengths, monkeypatch):
    if body == "loop":  # the online-softmax body over three 128-key blocks
        monkeypatch.setattr(jatt, "SINGLE_PASS_MAX_N", 0)
    rng = np.random.default_rng(23)
    q, k, v = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(3))
    lens = np.array(lengths, np.int32)
    pallas = np.asarray(jatt.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                             jnp.asarray(lens)))
    got = _np(tatt.flash_attention(_t(q), _t(k), _t(v), _t(lens)))
    for i, ln in enumerate(lens):  # rows past the length are unspecified
        np.testing.assert_allclose(got[i, :, :ln], pallas[i, :, :ln], atol=2e-5)
    # the dispatcher: all keys when no lengths are given
    full = np.asarray(jatt.mha_reference(*(jnp.asarray(t) for t in (q, k, v))))
    np.testing.assert_allclose(_np(tatt.attention(_t(q), _t(k), _t(v))), full, atol=2e-5)


# ---------------------------------------------------------------------------
# K6: RMSNorm
# ---------------------------------------------------------------------------

def test_rms_norm_plain_matches_pallas():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 512, 256)) * 1.7).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    pallas = np.asarray(jan._rms_norm_fwd_pallas(jnp.asarray(x), jnp.asarray(w), 1e-8))
    got = _np(tan.rms_norm(_t(x), _t(w), 1e-8))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jan.rms_norm_ref(jnp.asarray(x), jnp.asarray(w),
                                                                1e-8)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n", [37, 256])
def test_rms_norm_head_rows_bf16_match_pallas(n):
    """K6's plain version at qk-norm's head width (d = 64), bf16 x and a bf16
    weight, against `_rms_norm_fwd_pallas` (interpret mode) and the JAX
    `rms_norm_ref` on the [b * h, n, 64] rows: both round one f32 result
    to bf16, so they may differ by one bf16 ulp (2 ** -7 relative)."""
    rng = np.random.default_rng(n)
    b, h, d = 2, 4, 64
    xb = torch.from_numpy((2 * rng.standard_normal((b, h, n, d))).astype(np.float32)).bfloat16()
    wb = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).bfloat16()
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16).reshape(b * h, n, d)
    jw = jnp.asarray(wb.float().numpy(), jnp.bfloat16)
    got = _np(tan.rms_norm(xb, wb, 1e-6).float()).reshape(b * h, n, d)
    for want in (jan._rms_norm_fwd_pallas(jx, jw, 1e-6), jan.rms_norm_ref(jx, jw, 1e-6)):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_rms_norm_on_head_view_equals_split_heads_copy(fused):
    """qk-norm hands K6 the [b, h, n, 64] view of the projection (q of a
    fused qkv, or its own projection) instead of a `split_heads` copy: the
    port's rms_norm gives the same bits on both, contiguous."""
    from f5tts_tpu_torch.models import modules as tm

    rng = np.random.default_rng(5)
    b, n, h, d = 2, 37, 4, 64
    proj = torch.from_numpy(rng.standard_normal((b, n, (3 if fused else 1) * h * d))
                            .astype(np.float32)).bfloat16()
    q = proj.chunk(3, dim=-1)[0] if fused else proj
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).bfloat16()
    view = tm.head_view(q, h)
    assert view.data_ptr() == q.data_ptr() and not view.is_contiguous()
    got = tan.rms_norm(view, w, 1e-6)
    assert got.is_contiguous()
    assert torch.equal(got, tan.rms_norm(tm.split_heads(q, h), w, 1e-6))


def test_rms_norm_gradients_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    dy = rng.standard_normal((2, 64, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jan.rms_norm_fused(a, b, 1e-8), jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    tan.rms_norm(xt, wt, 1e-8).backward(_t(dy))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(_np(wt.grad), np.asarray(want[1]), atol=1e-4)


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version, nothing else does silently
# ---------------------------------------------------------------------------

def test_new_wrappers_cpu_plain_and_no_launch_counted():
    _build.reset_launches()
    x = torch.randn(1, 64, 128)
    tan.rms_norm(x, torch.ones(128), 1e-8)
    qkv = torch.randn(1, 64, 3 * 128)
    tatt.fused_qkv_rope_attention_bias(qkv, torch.ones(64, 128), torch.zeros(64, 128),
                                       torch.ones(1, 64, dtype=torch.bool), 2)
    q = torch.randn(1, 2, 64, 64)
    tatt.flash_attention(q, q, q, torch.tensor([40], dtype=torch.int32))
    assert _build.launches() == {}


def test_new_wrappers_refuse_other_devices():
    x = torch.empty(1, 64, 128, device="meta")
    with pytest.raises(ValueError):
        tan.rms_norm(x, torch.empty(128, device="meta"))
    with pytest.raises(ValueError):
        tatt.fused_qkv_rope_attention_bias(torch.empty(1, 64, 384, device="meta"), x[0], x[0],
                                           torch.empty(1, 64, dtype=torch.bool, device="meta"), 2)
    q = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError):
        tatt.flash_attention(q, q, q, torch.empty(1, dtype=torch.int32, device="meta"))


def test_rms_norm_argument_checks():
    bf = torch.bfloat16
    with pytest.raises(TypeError):  # f32 x
        tan._rms_check(torch.zeros(1, 8, 128), torch.ones(128))
    with pytest.raises(ValueError):  # d not a multiple of 8
        tan._rms_check(torch.zeros(1, 8, 100, dtype=bf), torch.ones(100))
    with pytest.raises(ValueError):  # weight of another width
        tan._rms_check(torch.zeros(1, 8, 128, dtype=bf), torch.ones(64))
    with pytest.raises(ValueError):  # a strided last dimension
        tan._rms_check(torch.zeros(1, 8, 256, dtype=bf)[..., ::2], torch.ones(128))
    with pytest.raises(ValueError):  # rows 264 bytes apart: not 16-byte aligned
        tan._rms_check(torch.zeros(1, 8, 132, dtype=bf)[..., :128], torch.ones(128))
    with pytest.raises(ValueError):  # four leading strides that do not merge
        tan._rms_check(torch.zeros(2, 3, 4, 5, 128, dtype=bf).permute(3, 2, 1, 0, 4),
                       torch.ones(128))
    # what the UNetT passes is accepted: bf16 x, f32 or bf16 weight
    tan._rms_check(torch.zeros(2, 64, 1024, dtype=bf), torch.ones(1024))
    tan._rms_check(torch.zeros(2, 64, 1024, dtype=bf), torch.ones(1024, dtype=bf))
    # and what qk-norm passes: the head view of a fused qkv projection, read
    # in place at three leading strides
    qkv = torch.zeros(2, 37, 3 * 4 * 64, dtype=bf)
    view = qkv.chunk(3, dim=-1)[1].view(2, 37, 4, 64).transpose(1, 2)
    assert tan._rms_check(view, torch.ones(64, dtype=bf)) == (2 * 4 * 37, 4, 37, 37 * 768, 64,
                                                               768)
    assert tan._rms_check(torch.zeros(2, 64, 1024, dtype=bf), torch.ones(1024)) == (
        128, 1, 128, 0, 0, 1024)
