"""Backward passes of the port's kernel modules against the JAX package, on the CPU.

- The plain attention backward `fused_qkv_rope_attention_bwd_ref` (the CPU
  counterpart of kernel K4) against `jax.grad` through the JAX
  `fused_qkv_rope_attention` with FORCE_FLAT_BWD, which runs the Pallas
  `_fused_qkv_bwd_kernel` (n = 256) and `_fused_qkv_bwd_kernel_long`
  (n = 1152) in interpret mode: masked cotangent, lengths [n, n - 79], f32,
  tolerance 3e-4 (the JAX package's own for the long kernel).
- The same plain backward against torch autograd of the plain forward with an
  UNMASKED cotangent: rows past the length are zero in the forward, so their
  gradient is zero whatever the cotangent holds there (tolerance 1e-5, f32).
- K3's lse mode: the plain forward's row lse against the Pallas
  `_flash_forward(return_lse=True)` in interpret mode on the same roped,
  split heads (tolerance 1e-5).
- K4's function from the saved lse, `fused_qkv_rope_attention_bwd_from_lse_ref`,
  fed the plain forward's out and lse, against the same `jax.grad` (n = 256 /
  1152, tolerance 3e-4); the CPU autograd path saves the forward's out and
  lse and hands them to it.
- The AdaLN-norm (K1) and conv-position (K2) backwards against the JAX VJPs
  of their XLA formulas (tolerance 1e-5 relative, f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.ops import attention as jatt
from f5tts_tpu.ops.adaln_norm import adaln_norm as j_adaln_norm
from f5tts_tpu.ops.grouped_conv import _xla_conv_pos
from f5tts_tpu.ops.rope import rope_flat_tables as j_rope_flat_tables
from f5tts_tpu.ops.rope import rope_freqs_interleaved as j_rope_freqs
from f5tts_tpu_torch.ops.adaln_norm import adaln_norm
from f5tts_tpu.ops.rope import apply_rotary_flat_tables as j_apply_rotary_flat_tables
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops.attention import (
    fused_qkv_rope_attention,
    fused_qkv_rope_attention_bwd_from_lse_ref,
    fused_qkv_rope_attention_bwd_ref,
    fused_qkv_rope_attention_ref,
)
from f5tts_tpu_torch.ops.grouped_conv import conv_pos_embedding
from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pallas_bwd_case(n, monkeypatch):
    """qkv, rope tables, lengths [n, n - 79], the masked cotangent and the
    JAX dQKV through the Pallas backward (interpret mode)."""
    monkeypatch.setattr(jatt, "FORCE_FLAT_BWD", True)
    heads, d, b = 2, 64, 2
    hd = heads * d
    rng = np.random.default_rng(n)
    qkv = (0.5 * rng.standard_normal((b, n, 3 * hd))).astype(np.float32)
    ct = rng.standard_normal((b, n, hd)).astype(np.float32)
    lengths = np.array([n, n - 79], np.int32)
    rowmask = (np.arange(n)[None, :] < lengths[:, None])[:, :, None]
    cos, sin = j_rope_flat_tables(j_rope_freqs(d, n), n, heads, dtype=jnp.float32)

    def loss(x):
        o = jatt.fused_qkv_rope_attention(x, cos, sin, jnp.asarray(lengths), heads)
        return jnp.sum(jnp.where(rowmask, o * ct, 0.0))

    want = np.asarray(jax.grad(loss)(jnp.asarray(qkv)))
    return qkv, cos, sin, lengths, ct, rowmask, want


@pytest.mark.parametrize("n", [256, 1152])  # whole-n kernel, q-block-looped long kernel
def test_plain_attention_bwd_matches_pallas_bwd(n, monkeypatch):
    heads = 2
    qkv, cos, sin, lengths, ct, rowmask, want = _pallas_bwd_case(n, monkeypatch)
    # the same inputs on both sides, the rope tables included
    got = fused_qkv_rope_attention_bwd_ref(_t(qkv), _t(cos), _t(sin), _t(lengths),
                                           _t(ct * rowmask), heads).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
    assert not got[1, n - 79:].any()  # dead rows and dead keys: exactly 0


def test_plain_attention_bwd_ignores_dead_rows_of_the_cotangent():
    heads, d, b, n = 2, 64, 2, 200
    rng = np.random.default_rng(1)
    qkv = _t(rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)).requires_grad_()
    ct = _t(rng.standard_normal((b, n, heads * d)).astype(np.float32))  # not masked
    cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n), n, heads, dtype=torch.float32)
    lengths = torch.tensor([n, 1], dtype=torch.int32)
    out = fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, heads)
    (want,) = torch.autograd.grad(out, qkv, ct)
    got = fused_qkv_rope_attention_bwd_ref(qkv.detach(), cos, sin, lengths, ct, heads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # the port's differentiable entry point takes K4's function on the CPU:
    # the backward from the forward's saved output and lse
    out = fused_qkv_rope_attention(qkv, cos, sin, lengths, heads)
    (via_fn,) = torch.autograd.grad(out, qkv, ct)
    o, lse = fused_qkv_rope_attention_ref(qkv.detach(), cos, sin, lengths, heads, return_lse=True)
    from_lse = fused_qkv_rope_attention_bwd_from_lse_ref(qkv.detach(), cos, sin, lengths, o, lse,
                                                         ct, heads)
    np.testing.assert_array_equal(via_fn.numpy(), from_lse.numpy())
    np.testing.assert_allclose(via_fn.numpy(), want.numpy(), atol=1e-5)
    assert not via_fn[1, 1:].any()


@pytest.mark.parametrize("n,lengths", [(256, [256, 177]), (384, [384, 70])])
def test_plain_lse_matches_pallas_flash_forward(n, lengths):
    """K3's lse mode: the plain forward's row lse against `_flash_forward(
    return_lse=True)` (interpret mode) on the same roped, split heads; NEG_INF
    on the q tiles wholly past the length."""
    heads, d = 2, 64
    rng = np.random.default_rng(n + 11)
    qkv = rng.standard_normal((2, n, 3 * heads * d)).astype(np.float32)
    cos, sin = j_rope_flat_tables(j_rope_freqs(d, n), n, heads, dtype=jnp.float32)
    q, k, v = jnp.split(jnp.asarray(qkv), 3, axis=-1)

    def heads_of(t):
        return t.reshape(2, n, heads, d).transpose(0, 2, 1, 3)

    qh, kh = (heads_of(j_apply_rotary_flat_tables(t, cos, sin)) for t in (q, k))
    lens = np.array(lengths, np.int32)
    _, lse_j = jatt._flash_forward(qh, kh, heads_of(v), jnp.asarray(lens), return_lse=True)
    lse_j = np.asarray(lse_j)[..., 0]
    o, lse = fused_qkv_rope_attention_ref(_t(qkv), _t(cos), _t(sin), _t(lens), heads,
                                          return_lse=True)
    assert lse.shape == (2, heads, n) and lse.dtype == torch.float32
    np.testing.assert_array_equal(o.numpy(), fused_qkv_rope_attention_ref(
        _t(qkv), _t(cos), _t(sin), _t(lens), heads).numpy())
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(lse[i, :, :ln].numpy(), lse_j[i, :, :ln], atol=1e-5, rtol=1e-5)
        tile_end = -(-ln // 64) * 64
        assert (lse[i, :, tile_end:] == tatt.NEG_INF).all()


@pytest.mark.parametrize("n", [256, 1152])
def test_from_lse_bwd_matches_pallas_bwd(n, monkeypatch):
    """K4's function, fed the plain forward's out and lse, against jax.grad
    through the Pallas backward; dead rows and keys exactly 0."""
    heads = 2
    qkv, cos, sin, lengths, ct, rowmask, want = _pallas_bwd_case(n, monkeypatch)
    o, lse = fused_qkv_rope_attention_ref(_t(qkv), _t(cos), _t(sin), _t(lengths), heads,
                                          return_lse=True)
    got = fused_qkv_rope_attention_bwd_from_lse_ref(_t(qkv), _t(cos), _t(sin), _t(lengths), o, lse,
                                                    _t(ct), heads).numpy()  # ct NOT masked
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
    assert not got[1, n - 79:].any()


def test_cpu_autograd_saves_and_uses_out_and_lse(monkeypatch):
    """The differentiable entry point saves the lse-mode forward's out and lse
    and hands exactly those to the backward, without launching a kernel."""
    seen = {}
    real_fwd, real_bwd = tatt.fused_qkv_rope_attention_ref, tatt.fused_qkv_rope_attention_bwd_from_lse_ref

    def fwd(*a, **kw):
        res = real_fwd(*a, **kw)
        seen.setdefault("fwd", []).append(res)
        return res

    def bwd(*a):
        seen["bwd"] = a
        return real_bwd(*a)

    monkeypatch.setattr(tatt, "fused_qkv_rope_attention_ref", fwd)
    monkeypatch.setattr(tatt, "fused_qkv_rope_attention_bwd_from_lse_ref", bwd)
    _build.reset_launches()
    rng = np.random.default_rng(4)
    heads, n = 2, 96
    qkv = _t(rng.standard_normal((2, n, 3 * heads * 64)).astype(np.float32)).requires_grad_()
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n), n, heads, dtype=torch.float32)
    lengths = torch.tensor([n, 40], dtype=torch.int32)
    out = fused_qkv_rope_attention(qkv, cos, sin, lengths, heads)
    (o, lse), = seen["fwd"]
    assert torch.equal(out, o) and lse.shape == (2, heads, n)
    ct = _t(rng.standard_normal((2, n, heads * 64)).astype(np.float32))
    out.backward(ct)
    saved_out, saved_lse = seen["bwd"][4], seen["bwd"][5]
    for saved, made in ((saved_out, o), (saved_lse, lse)):  # the same storage, not a recompute
        assert saved.data_ptr() == made.data_ptr() and torch.equal(saved, made)
    assert torch.equal(seen["bwd"][6], ct)
    assert _build.launches() == {}


def test_adaln_norm_bwd_matches_jax_vjp():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 128)).astype(np.float32)
    scale, shift = (0.3 * rng.standard_normal((2, 128))).astype(np.float32), \
        rng.standard_normal((2, 128)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(j_adaln_norm, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    want = vjp(jnp.asarray(dy))
    xs = [_t(a).requires_grad_() for a in (x, scale, shift)]
    got = torch.autograd.grad(adaln_norm(*xs), xs, _t(dy))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5


def test_conv_pos_bwd_matches_jax_vjp():
    rng = np.random.default_rng(3)
    b, n, c, k, groups = 2, 48, 128, 31, 16
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w1, w2 = ((rng.standard_normal((k, c // groups, c)) / np.sqrt(8 * k)).astype(np.float32)
              for _ in range(2))
    b1, b2 = ((0.1 * rng.standard_normal((c,))).astype(np.float32) for _ in range(2))
    lengths = np.array([n, 29], np.int32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _xla_conv_pos(*a, jnp.asarray(lengths), groups),
                     *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(dy))
    xs = [_t(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    got = torch.autograd.grad(conv_pos_embedding(*xs, _t(lengths), groups), xs, _t(dy))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5
    assert not got[0][1, 29:].any()  # masked rows get no gradient
