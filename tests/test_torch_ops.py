"""Port ops (f5tts_tpu_torch) against the JAX package on the CPU.

The three kernel modules run their plain PyTorch versions here (CPU tensors)
and are held against the Pallas kernels in interpret mode and against the
XLA oracles, on the same numpy-seeded inputs. Also: utils and the RoPE
tables (exact or f32-tight), and the wrappers' CPU-only dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu import utils as jutils
from f5tts_tpu.ops import adaln_norm as jan
from f5tts_tpu.ops import attention as jatt
from f5tts_tpu.ops import grouped_conv as jgc
from f5tts_tpu.ops import rope as jrope
from f5tts_tpu_torch import utils as tutils
from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import adaln_norm as tan
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.ops import grouped_conv as tgc
from f5tts_tpu_torch.ops import rope as trope
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# utils: exact equality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nfe", [4, 7, 16, 32])
@pytest.mark.parametrize("sway", [None, -1.0, 0.5])
def test_time_grid_exact(nfe, sway):
    want = np.asarray(jutils.make_time_grid(nfe, sway_sampling_coef=sway, use_epss=True))
    got = _np(tutils.make_time_grid(nfe, sway_sampling_coef=sway, use_epss=True))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jutils.make_time_grid(nfe, sway, use_epss=False))
    np.testing.assert_array_equal(_np(tutils.make_time_grid(nfe, sway, False)), want)


def test_epss_table_and_buckets_exact():
    assert tutils._EPSS_TIMESTEPS == jutils._EPSS_TIMESTEPS
    for nfe in list(jutils._EPSS_TIMESTEPS) + [3, 9]:
        np.testing.assert_array_equal(_np(tutils.get_epss_timesteps(nfe)),
                                      np.asarray(jutils.get_epss_timesteps(nfe)))
    for frames in [0, 1, 255, 256, 257, 971, 1024, 1025, 4095, 4096, 5000, 9999]:
        for bs in (128, 256):
            for extra in (0, 1):
                assert (tutils.duration_bucket(frames, bs, 4096, extra)
                        == jutils.duration_bucket(frames, bs, 4096, extra))


def test_lens_to_mask_exact():
    lens = np.array([0, 3, 7, 10], np.int32)
    np.testing.assert_array_equal(_np(tutils.lens_to_mask(_t(lens), 10)),
                                  np.asarray(jutils.lens_to_mask(jnp.asarray(lens), 10)))


def test_resolve_device():
    assert tutils.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# RoPE tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe", [None, 1])
def test_rope_tables_match_jax(pe):
    d, n, heads = 64, 96, 2
    ang_j = jrope.rope_freqs_interleaved(d, n)
    ang_t = trope.rope_freqs_interleaved(d, n)
    np.testing.assert_array_equal(_np(ang_t), np.asarray(ang_j))
    cj, sj = jrope.rope_flat_tables(ang_j, n, heads, pe, dtype=jnp.float32)
    ct, st = trope.rope_flat_tables(ang_t, n, heads, pe, dtype=torch.float32)
    np.testing.assert_allclose(_np(ct), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(_np(st), np.asarray(sj), atol=1e-6)
    x = np.random.default_rng(0).standard_normal((2, n, heads * d)).astype(np.float32)
    want = np.asarray(jrope.apply_rotary_flat(jnp.asarray(x), ang_j, heads, pe))
    got = _np(trope.apply_rotary_flat(_t(x), ang_t, heads, pe))
    np.testing.assert_allclose(got, want, atol=1e-5)  # f32, |x| <~ 5
    np.testing.assert_array_equal(_np(trope.precompute_freqs_cis(64, 200)),
                                  np.asarray(jrope.precompute_freqs_cis(64, 200)))


def test_rope_rotates_interleaved_pairs():
    # out[2i] = x[2i] c - x[2i+1] s, out[2i+1] = x[2i+1] c + x[2i] s
    x = torch.tensor([[[1.0, 2.0, 3.0, 4.0]]])
    cos = torch.full((1, 4), 0.5)
    sin = torch.full((1, 4), 0.25)
    out = trope.apply_rotary_flat_tables(x, cos, sin)
    want = [1 * .5 - 2 * .25, 2 * .5 + 1 * .25, 3 * .5 - 4 * .25, 4 * .5 + 3 * .25]
    np.testing.assert_allclose(_np(out)[0, 0], want, atol=1e-7)


# ---------------------------------------------------------------------------
# K1: AdaLN norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [32, 37])
def test_adaln_norm_plain_matches_pallas_and_xla(d, b, n):
    """At the model widths, one and three batch rows, and an n that no block
    of 256 divides (the Pallas body then takes a block of n); scale and
    shift are the strided row views of a [b, 6d] modulation, as a block
    hands them over."""
    rng = np.random.default_rng(d + 10 * b + n)
    x = (rng.standard_normal((b, n, d)) * 3 + 0.5).astype(np.float32)
    mods = (rng.standard_normal((b, 6 * d)) * 0.2).astype(np.float32)
    shift, scale = mods[:, :d], mods[:, d:2 * d]
    mods_t = _t(mods)
    got = _np(tan.adaln_norm(_t(x), mods_t[:, d:2 * d], mods_t[:, :d]))
    pallas = np.asarray(jan._adaln_norm_fwd_pallas(jnp.asarray(x), jnp.asarray(scale),
                                                   jnp.asarray(shift), 1e-6))
    xla = np.asarray(jan.adaln_norm_ref(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift)))
    # f32 throughout, outputs |y| < ~6: sum-order differences only
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)


# ---------------------------------------------------------------------------
# K2: conv position embedding (c=128, groups=2: 64 channels a group)
# ---------------------------------------------------------------------------

def _cpe_inputs(b=2, n=384, c=128, k=31, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w1 = (rng.standard_normal((k, c // 2, c)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((k, c // 2, c)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    lengths = np.array([n, 277], np.int32)
    return x, w1, b1, w2, b2, lengths


def _live(a, lengths):
    return np.concatenate([a[i, :l] for i, l in enumerate(lengths)], axis=0)


def test_conv_pos_plain_matches_xla_f32():
    x, w1, b1, w2, b2, lengths = _cpe_inputs()
    got = _np(tgc.conv_pos_embedding(*map(_t, (x, w1, b1, w2, b2, lengths)), groups=2))
    want = np.asarray(jgc._xla_conv_pos(*map(jnp.asarray, (x, w1, b1, w2, b2, lengths)), 2))
    # f32 sums of 1984 products, values up to ~17: 1e-4 absolute
    np.testing.assert_allclose(_live(got, lengths), _live(want, lengths), atol=1e-4, rtol=1e-5)
    assert np.all(got[1, lengths[1]:] == 0)


def test_conv_pos_plain_bf16_matches_pallas_interpret():
    x, w1, b1, w2, b2, lengths = _cpe_inputs()
    xb = _t(x).to(torch.bfloat16)
    w1b, w2b = _t(w1).to(torch.bfloat16), _t(w2).to(torch.bfloat16)
    got = _np(tgc.conv_pos_embedding(xb, w1b, _t(b1), w2b, _t(b2), _t(lengths), groups=2).float())
    want = np.asarray(jgc.conv_pos_embedding_pallas(
        jnp.asarray(np.asarray(xb.float())), jnp.asarray(np.asarray(w1b.float())), jnp.asarray(b1),
        jnp.asarray(np.asarray(w2b.float())), jnp.asarray(b2), jnp.asarray(lengths), 2))
    # both compute in bf16 (f32 sums, bf16 intermediate); the port also
    # rounds its output to bf16: 1 bf16 ulp at |y| <= 17 is 0.0625
    np.testing.assert_allclose(_live(got, lengths), _live(want, lengths), atol=7e-2, rtol=1e-2)


@pytest.mark.parametrize("length", [0, 1, 64, 65, 128, 129, 200])
def test_conv_pos_plain_length_edges_match_pallas_and_xla(length):
    """K2's LENGTH + MISH mode edges at n = 200 (no multiple of 64), b = 2:
    row 0 full, row 1 live to `length` (0: a wholly dead row; 64 / 128 a
    tile's end; 65 / 129 one row into the next). Live rows against the Pallas
    body in interpret mode (bf16, tolerance as above) and `_xla_conv_pos`
    (f32, 1e-4); dead rows exactly 0."""
    x, w1, b1, w2, b2, _ = _cpe_inputs(n=200, seed=length)
    lengths = np.array([200, length], np.int32)
    got = _np(tgc.conv_pos_embedding(*map(_t, (x, w1, b1, w2, b2, lengths)), groups=2))
    want = np.asarray(jgc._xla_conv_pos(*map(jnp.asarray, (x, w1, b1, w2, b2, lengths)), 2))
    np.testing.assert_allclose(_live(got, lengths), _live(want, lengths), atol=1e-4, rtol=1e-5)
    assert np.all(got[1, length:] == 0)
    xb, w1b, w2b = (_t(a).to(torch.bfloat16) for a in (x, w1, w2))
    got = _np(tgc.conv_pos_embedding(xb, w1b, _t(b1), w2b, _t(b2), _t(lengths), groups=2).float())
    want = np.asarray(jgc.conv_pos_embedding_pallas(
        *(jnp.asarray(np.asarray(a.float())) for a in (xb, w1b)), jnp.asarray(b1),
        jnp.asarray(np.asarray(w2b.float())), jnp.asarray(b2), jnp.asarray(lengths), 2))
    np.testing.assert_allclose(_live(got, lengths), _live(want, lengths), atol=7e-2, rtol=1e-2)
    assert np.all(got[1, length:] == 0)


# ---------------------------------------------------------------------------
# K3: fused QKV + RoPE attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,lengths", [(256, [256, 177]), (384, [300, 64]), (384, [130, 64]),
                                       (384, [40, 384])])
def test_attention_plain_matches_pallas_and_mha(n, lengths):
    heads, d, b = 2, 64, 2
    hd = heads * d
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((b, n, 3 * hd)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    ang = jrope.rope_freqs_interleaved(d, n)
    cos, sin = jrope.rope_flat_tables(ang, n, heads, dtype=jnp.float32)
    pallas = np.asarray(jatt._fused_qkv_rope_attention_impl(
        jnp.asarray(qkv), cos, sin, jnp.asarray(lens), heads))
    q, k, v = np.split(qkv, 3, axis=-1)
    qr = jrope.apply_rotary_flat(jnp.asarray(q), ang, heads)
    kr = jrope.apply_rotary_flat(jnp.asarray(k), ang, heads)

    def sh(t):
        return jnp.asarray(t).reshape(b, n, heads, d).transpose(0, 2, 1, 3)

    mha = np.asarray(jatt.mha_reference(sh(qr), sh(kr), sh(v), jnp.asarray(lens))
                     ).transpose(0, 2, 1, 3).reshape(b, n, hd)
    got = _np(tatt.fused_qkv_rope_attention(_t(qkv), _t(np.asarray(cos)), _t(np.asarray(sin)),
                                            _t(lens), heads))
    # f32 throughout, |o| < ~2: sum-order differences only
    np.testing.assert_allclose(_live(got, lens), _live(pallas, lens), atol=2e-5)
    np.testing.assert_allclose(_live(got, lens), _live(mha, lens), atol=2e-5)
    assert np.all(got[1, lens[1]:] == 0)
    # the port's head-layout oracle agrees with the JAX one
    tm = _np(tatt.mha_reference(*(_t(sh(t)) for t in (qr, kr, v)),
                                _t(lens))).transpose(0, 2, 1, 3).reshape(b, n, hd)
    np.testing.assert_allclose(_live(tm, lens), _live(mha, lens), atol=2e-5)


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version, nothing else does silently
# ---------------------------------------------------------------------------

def test_wrappers_cpu_plain_and_no_launch_counted():
    _build.reset_launches()
    x = torch.randn(1, 64, 128)
    tan.adaln_norm(x, torch.zeros(1, 128), torch.zeros(1, 128))
    w = torch.randn(31, 64, 128) * 0.02
    tgc.conv_pos_embedding(x, w, torch.zeros(128), w, torch.zeros(128),
                           torch.tensor([64], dtype=torch.int32), groups=2)
    qkv = torch.randn(1, 64, 3 * 128)
    cos, sin = trope.rope_flat_tables(trope.rope_freqs_interleaved(64, 64), 64, 2)
    tatt.fused_qkv_rope_attention(qkv, cos.float(), sin.float(),
                                  torch.tensor([64], dtype=torch.int32), 2)
    assert _build.launches() == {}


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 64, 128, device="meta")
    with pytest.raises(ValueError):
        tan.adaln_norm(x, torch.empty(1, 128, device="meta"), torch.empty(1, 128, device="meta"))
    with pytest.raises(ValueError):
        tatt.fused_qkv_rope_attention(torch.empty(1, 64, 384, device="meta"), x, x, x, 2)
    with pytest.raises(ValueError):
        tgc.conv_pos_embedding(x, x, x, x, x, x, groups=2)


def test_kernel_argument_checks():
    bf = torch.bfloat16
    with pytest.raises(TypeError):
        tan._check(torch.zeros(1, 8, 128), torch.zeros(1, 128), torch.zeros(1, 128))
    with pytest.raises(ValueError):  # d not a multiple of 8
        tan._check(torch.zeros(1, 8, 100, dtype=bf), torch.zeros(1, 100, dtype=bf),
                   torch.zeros(1, 100, dtype=bf))
    with pytest.raises(ValueError):  # head width 128 is not the kernel's
        tatt._check(torch.zeros(1, 8, 3 * 256, dtype=bf), torch.zeros(8, 256, dtype=bf),
                    torch.zeros(8, 256, dtype=bf), torch.zeros(1, dtype=torch.int32), 2)
    with pytest.raises(ValueError):  # 8 channels a group
        x = torch.zeros(1, 8, 128, dtype=bf)
        w = torch.zeros(31, 8, 128, dtype=bf)
        tgc._check(x, (w, w), (torch.zeros(128, dtype=bf),) * 2,
                   torch.zeros(1, dtype=torch.int32), 16)
    # what the main path passes is accepted
    tatt._check(torch.zeros(2, 64, 3 * 1024, dtype=bf), torch.zeros(64, 1024, dtype=bf),
                torch.zeros(64, 1024, dtype=bf), torch.zeros(2, dtype=torch.int32), 16)
    mods = torch.zeros(2, 6 * 1024, dtype=bf)
    tan._check(torch.zeros(2, 64, 1024, dtype=bf), mods[:, 1024:2048], mods[:, :1024])


@pytest.mark.parametrize("num", [2, 5, 8, 17, 33, 65])
def test_linspace_exact(num):
    # grids from t = 0 and from t_start > 0 (duplicate_test_start's) are
    # bit-equal to jnp.linspace
    np.testing.assert_array_equal(
        _np(tutils.linspace_f32(0.0, 1.0, num)),
        np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32)))
    got = _np(tutils.linspace_f32(0.1, 1.0, num))
    want = np.asarray(jnp.linspace(0.1, 1.0, num, dtype=jnp.float32))
    np.testing.assert_array_equal(got, want)
