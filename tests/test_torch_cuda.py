"""Port kernels on the card (marker `cuda`; skipped where there is no GPU).

Each hand-written kernel against its plain PyTorch version at small shapes,
including ragged lengths and an n that is no multiple of the tiles; the
lse modes of K3, K5 and K7 (K3 at lengths 0, 1, 64, 65 and n, K7 at 1, 63,
64, 65, n - 1 and n; K11 with all-dead key tiles between live ones and a
row with no live key); the attention backwards K4, K8 (each against both of
its plain versions; K4 also at K3's edge lengths) and K9 alone and through
autograd (K3's lse mode -> K4, K5's lse mode -> K8, K7's lse mode -> K9);
the generic grouped conv1d K10 (every padded width at k 1, 2, 4 and 31) and
the key-masked head-layout attention K11; K2's length edges (0, 1, 64, 65,
128, 129, n); K6 at qk-norm's head rows, at d = 768 and on the strided
head view of a projection, and K1 at the main paths' shapes and at b = 3
with n = 1 and 37 (d 64 to 4096: batch boundaries inside a block and a
thread's rows); one tiny DiT, UNetT and MMDiT
forward (also at the dim-768 widths and with qk-norm) and one tiny training
step of each backbone through the kernels against the CPU plain path; the
pipeline's CUDA-graph replay against the eager generate (DiT, MMDiT; bf16
and int8), with each capture's launch counts and none on the host for a
replay; K12 and K13 bit-equal to their plain versions (m 17, 37, 2048; k and
n 8 to 4096; zero rows; K12 on strided rows), K1Q and K6Q bit-equal to the
K1 / K6 -> K12 chain (K6Q also on a strided head view), K12's GELU mode
against F.gelu + K12, one int8 projection and a depth-2 int8 forward of
each backbone against the CPU's int8 path.
Run on a GPU machine with:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops.adaln_norm import adaln_norm, adaln_norm_ref, rms_norm, rms_norm_ref
from f5tts_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    fused_qkv_rope_attention,
    fused_qkv_rope_attention_bias,
    fused_qkv_rope_attention_bias_bwd,
    fused_qkv_rope_attention_bias_bwd_from_lse_ref,
    fused_qkv_rope_attention_bias_bwd_ref,
    fused_qkv_rope_attention_bias_fwd,
    fused_qkv_rope_attention_bias_ref,
    fused_qkv_rope_attention_bwd,
    fused_qkv_rope_attention_bwd_from_lse_ref,
    fused_qkv_rope_attention_bwd_ref,
    fused_qkv_rope_attention_fwd,
    fused_qkv_rope_attention_ref,
    masked_flash_attention,
    masked_flash_attention_bwd,
    mha_reference,
    mha_reference_masked,
)
from f5tts_tpu_torch.ops.grouped_conv import (
    conv_pos_embedding,
    conv_pos_embedding_ref,
    grouped_conv1d,
    grouped_conv1d_ref,
)
from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev, torch.bfloat16)


def _live_max(a, b, lengths):
    n = a.shape[1]
    live = torch.arange(n, device=a.device)[None, :] < lengths[:, None]
    return float((a.float() - b.float()).abs()[live].max())


def _close(got, want, live=None):
    """The backward tolerance: rel-L2 <= 1e-2 and max-abs <= 2e-2 of the
    largest entry (over `live` entries when given)."""
    a, b = got.float(), want.float()
    if live is not None:
        a, b = a[live], b[live]
    assert float((a - b).norm() / b.norm()) <= 1e-2
    assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


# K1's (b, n, d): the main paths' shapes ([2, 1024 / 4096, 1024] DiT and
# MMDiT audio, [2, 256, 1024] the MMDiT text stream, [2, 1024 / 4096, 768]
# F5TTS_v1_Small), and b = 3 at n = 1 and 37 over every vector count a lane
# can hold (d = 64: 8 lanes and 4 rows a thread, so a thread's rows cross a
# batch boundary; d = 4096: scale and shift read at use, not kept)
K1_SHAPES = ([(2, 1, 1024), (2, 100, 1024), (2, 1024, 1024), (2, 4096, 1024), (2, 256, 1024),
              (2, 1024, 768), (2, 4096, 768)]
             + [(3, n, d) for n in (1, 37) for d in (64, 768, 1024, 4096)])


@pytest.mark.parametrize("b,n,d", K1_SHAPES)
def test_adaln_norm_kernel(dev, b, n, d):
    rng = np.random.default_rng(b * n + d)
    x = _bf16(rng, (b, n, d), dev)
    mods = _bf16(rng, (b, 6 * d), dev, 0.05)
    scale, shift = mods[:, d:2 * d], mods[:, :d]  # strided views, as a block hands them over
    _build.reset_launches()
    out = adaln_norm(x, scale, shift)
    assert _build.launches() == {"adaln_norm": 1}
    ref = adaln_norm_ref(x.float(), scale.float(), shift.float())
    assert _live_max(out, ref, torch.full((b,), n, device=dev)) <= 2e-2


@pytest.mark.parametrize("n,length", [(64, 64), (200, 131), (1024, 777)])
def test_conv_pos_kernel(dev, n, length):
    rng = np.random.default_rng(n)
    x = _bf16(rng, (2, n, 1024), dev)
    w1, w2 = _bf16(rng, (31, 64, 1024), dev, 0.02), _bf16(rng, (31, 64, 1024), dev, 0.02)
    b1, b2 = _bf16(rng, (1024,), dev, 0.02), _bf16(rng, (1024,), dev, 0.02)
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    out = conv_pos_embedding(x, w1, b1, w2, b2, lengths, 16)
    ref = conv_pos_embedding_ref(x.float(), w1.float(), b1.float(), w2.float(), b2.float(),
                                 lengths, 16)
    assert _live_max(out, ref, lengths) <= 3e-2
    assert not out[1, length:].any()


# K2's edges: lengths 0 (a wholly dead batch row), 1, 64, 65, 128 (a tile's
# end), 129 (one row in the next tile) and n, at n no multiple of 64
K2_EDGES = [0, 1, 64, 65, 128, 129, 200]


@pytest.mark.parametrize("n,length", [(200, e) for e in K2_EDGES] + [(4096, 3001), (4096, 4096)])
def test_conv_pos_kernel_length_edges(dev, n, length):
    """K2's LENGTH + MISH mode at b = 2 (row 0 full, row 1 at the edge): live
    rows within 3e-2 of the plain version, dead rows (and the dead tiles it
    walks past) exactly 0, two launches of the one kernel counted once."""
    rng = np.random.default_rng(n + length)
    x = _bf16(rng, (2, n, 1024), dev)
    w1, w2 = _bf16(rng, (31, 64, 1024), dev, 0.02), _bf16(rng, (31, 64, 1024), dev, 0.02)
    b1, b2 = _bf16(rng, (1024,), dev, 0.02), _bf16(rng, (1024,), dev, 0.02)
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out = conv_pos_embedding(x, w1, b1, w2, b2, lengths, 16)
    assert _build.launches() == {"conv_pos_embedding": 1}
    ref = conv_pos_embedding_ref(x.float(), w1.float(), b1.float(), w2.float(), b2.float(),
                                 lengths, 16)
    assert _live_max(out, ref, lengths) <= 3e-2
    assert not out[1, length:].any()


# K3's edges: lengths 0, 1, 64 (a tile's end), 65 (one key in the next
# tile) and n, at n no multiple of 64
K3_EDGES = [(200, 0), (200, 1), (200, 64), (200, 65), (200, 200)]


@pytest.mark.parametrize("n,length", [(64, 1), (100, 37), (1024, 777), (3200, 3001)] + K3_EDGES)
def test_attention_kernel(dev, n, length):
    rng = np.random.default_rng(n)
    qkv = _bf16(rng, (2, n, 3 * 1024), dev)
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, 16)
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    out = fused_qkv_rope_attention(qkv, cos, sin, lengths, 16)
    ref = fused_qkv_rope_attention_ref(qkv.float(), cos.float(), sin.float(), lengths, 16)
    assert _live_max(out, ref, lengths) <= 2e-2
    assert not out[1, length:].any()


@pytest.mark.parametrize("n,length", [(64, 1), (100, 37), (1024, 777), (3200, 3001)] + K3_EDGES)
def test_attention_lse_kernel(dev, n, length):
    """K3's lse mode: the output as K3's, the lse within 1e-3 of the plain
    version's (on the same bf16 inputs) on live q tiles and exactly -1e30 on
    the tiles past the length."""
    rng = np.random.default_rng(n + 9)
    qkv = _bf16(rng, (2, n, 3 * 1024), dev)
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, 16)
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out, lse = fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, 16, return_lse=True)
    assert _build.launches() == {"fused_qkv_rope_attention_lse": 1}
    assert torch.equal(out, fused_qkv_rope_attention(qkv, cos, sin, lengths, 16))
    # the plain version on the same bf16 inputs rounds roped q and k where K3 does
    _, want = fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, 16, return_lse=True)
    tile_end = -(-length // 64) * 64
    assert float((lse[0] - want[0]).abs().max()) <= 1e-3
    if length:
        assert float((lse[1, :, :tile_end] - want[1, :, :tile_end]).abs().max()) <= 1e-3
    assert bool((lse[1, :, tile_end:] == NEG_INF).all())


@pytest.mark.parametrize("n,length", [(64, 1), (100, 37), (960, 960), (1024, 777), (3200, 3001),
                                      (200, 0), (200, 65), (130, 64)])
def test_attention_bwd_kernel(dev, n, length):
    """K4 from K3's saved output and lse against both plain versions (the
    from-lse one it computes and the JAX function's recompute): dQKV over
    live rows by rel-L2 (<= 1e-2) and max-abs (<= 2e-2 of the largest
    entry); dead rows exactly 0."""
    rng = np.random.default_rng(n + 1)
    qkv = _bf16(rng, (2, n, 3 * 1024), dev)
    dout = _bf16(rng, (2, n, 1024), dev)  # not masked: K4 must ignore dead rows
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, 16)
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    out, lse = fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, 16, return_lse=True)
    _build.reset_launches()
    got = fused_qkv_rope_attention_bwd(qkv, cos, sin, lengths, out, lse, dout, 16)
    assert _build.launches() == {"fused_qkv_rope_attention_bwd": 1}
    live = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    for want in (fused_qkv_rope_attention_bwd_from_lse_ref(qkv, cos, sin, lengths, out, lse, dout, 16),
                 fused_qkv_rope_attention_bwd_ref(qkv, cos, sin, lengths, dout, 16)):
        _close(got, want, live)
    assert not got[1, length:].any()


def test_attention_autograd_launches_k4(dev):
    rng = np.random.default_rng(3)
    qkv = _bf16(rng, (1, 128, 3 * 1024), dev).requires_grad_()
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, 128).to(dev), 128, 16)
    lengths = torch.tensor([100], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out = fused_qkv_rope_attention(qkv, cos, sin, lengths, 16)
    out.float().sum().backward()
    assert _build.launches() == {"fused_qkv_rope_attention_lse": 1,
                                 "fused_qkv_rope_attention_bwd": 1}
    want = fused_qkv_rope_attention_bwd_ref(qkv.detach(), cos, sin, lengths,
                                            torch.ones_like(out), 16)
    assert float((qkv.grad.float() - want.float()).norm() / want.float().norm()) <= 1e-2
    with torch.no_grad():  # inference keeps the mode without lse
        _build.reset_launches()
        fused_qkv_rope_attention(qkv, cos, sin, lengths, 16)
        assert _build.launches() == {"fused_qkv_rope_attention": 1}


@pytest.mark.parametrize("n,w_dtype", [(1, torch.float32), (100, torch.bfloat16),
                                       (1024, torch.float32)])
def test_rms_norm_kernel(dev, n, w_dtype):
    rng = np.random.default_rng(n)
    x = _bf16(rng, (2, n, 1024), dev, 2.0)
    w = (1.0 + 0.1 * torch.from_numpy(rng.standard_normal(1024).astype(np.float32))).to(dev, w_dtype)
    _build.reset_launches()
    out = rms_norm(x, w, 1e-8)
    assert _build.launches() == {"rms_norm": 1}
    ref = rms_norm_ref(x.float(), w.float(), 1e-8)
    assert _live_max(out, ref, torch.full((2,), n, device=dev)) <= 2e-2


@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_head_rows(dev, n, w_dtype):
    """K6 at qk-norm's per-head rows [2, 16, n, 64]."""
    rng = np.random.default_rng(n + 5)
    x = _bf16(rng, (2, 16, n, 64), dev, 2.0)
    w = (1.0 + 0.1 * torch.from_numpy(rng.standard_normal(64).astype(np.float32))).to(dev, w_dtype)
    out = rms_norm(x, w, 1e-6)
    ref = rms_norm_ref(x.float(), w.float(), 1e-6)
    assert float((out.float() - ref).abs().max()) <= 2e-2


@pytest.mark.parametrize("shape", [(2, 1024, 768), (3, 5, 768)])
def test_rms_norm_kernel_d768(dev, shape):
    """K6 at the dim-768 presets' rows (a warp a row, 3 vectors a lane)."""
    rng = np.random.default_rng(shape[1])
    x = _bf16(rng, shape, dev, 2.0)
    w = _bf16(rng, (768,), dev, 0.1) + 1.0
    out = rms_norm(x, w, 1e-8)
    assert float((out.float() - rms_norm_ref(x.float(), w.float(), 1e-8)).abs().max()) <= 2e-2


@pytest.mark.parametrize("n,fused", [(37, True), (4096, True), (200, False)])
def test_rms_norm_kernel_strided_head_view(dev, n, fused):
    """K6 reads the [b, h, n, 64] head view of a projection in place (q of a
    fused [b, n, 3 * h * 64] qkv, or a [b, n, h * 64] one) and writes a
    contiguous result bit-equal to K6 on the contiguous copy."""
    rng = np.random.default_rng(n)
    proj = _bf16(rng, (2, n, (3 if fused else 1) * 1024), dev, 2.0)
    view = proj[..., :1024].view(2, n, 16, 64).transpose(1, 2)
    w = _bf16(rng, (64,), dev, 0.1) + 1.0
    _build.reset_launches()
    out = rms_norm(view, w, 1e-6)
    assert _build.launches() == {"rms_norm": 1}
    assert out.is_contiguous() and out.shape == view.shape
    assert torch.equal(out, rms_norm(view.contiguous(), w, 1e-6))
    assert float((out.float() - rms_norm_ref(view.float(), w.float(), 1e-6)).abs().max()) <= 2e-2


@pytest.mark.parametrize("n", [64, 200, 1152])
def test_bias_attention_kernel(dev, n):
    """K5 with dead keys mid-sequence, a whole dead 64-key tile and a dead
    tail; every row is computed, all rows compared."""
    rng = np.random.default_rng(n + 2)
    qkv = _bf16(rng, (2, n, 3 * 1024), dev)
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, 16)
    kmask = torch.ones(2, n, dtype=torch.bool, device=dev)
    kmask[0, n // 4: n // 2] = False
    kmask[1, n - n // 3:] = False
    if n >= 192:
        kmask[1, 64:128] = False
    _build.reset_launches()
    out = fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, 16)
    assert _build.launches() == {"fused_qkv_rope_attention_bias": 1}
    ref = fused_qkv_rope_attention_bias_ref(qkv.float(), cos.float(), sin.float(), kmask, 16)
    assert _live_max(out, ref, torch.full((2,), n, device=dev)) <= 2e-2


@pytest.mark.parametrize("n,length", [(64, 1), (100, 37), (1024, 777), (4224, 3001)])
def test_flash_attention_kernel(dev, n, length):
    """K7 over live rows; q tiles wholly past the length are zeros."""
    rng = np.random.default_rng(n + 3)
    q, k, v = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(3))
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out = flash_attention(q, k, v, lengths)
    assert _build.launches() == {"flash_attention": 1}
    ref = mha_reference(q.float(), k.float(), v.float(), lengths)
    for i, ln in enumerate((n, length)):
        assert float((out[i, :, :ln].float() - ref[i, :, :ln]).abs().max()) <= 2e-2
    assert not out[1, :, -(-length // 64) * 64:].any()


def _bias_case(rng, n, dev):
    qkv = _bf16(rng, (2, n, 3 * 1024), dev)
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, 16)
    kmask = torch.ones(2, n, dtype=torch.bool, device=dev)
    kmask[0, n // 4: n // 2] = False
    kmask[1, n - n // 3:] = False
    if n >= 192:
        kmask[1, 64:128] = False  # a whole dead 64-key tile
    return qkv, cos, sin, kmask


@pytest.mark.parametrize("n", [64, 200, 1152, 3200])
def test_bias_attention_lse_kernel(dev, n):
    """K5's lse mode: the output as K5's, the lse of every row within 1e-3."""
    rng = np.random.default_rng(n + 10)
    qkv, cos, sin, kmask = _bias_case(rng, n, dev)
    _build.reset_launches()
    out, lse = fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, 16, return_lse=True)
    assert _build.launches() == {"fused_qkv_rope_attention_bias_lse": 1}
    assert torch.equal(out, fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, 16))
    _, want = fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, 16, return_lse=True)
    assert float((lse - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("n", [64, 200, 1152, 3200])
def test_bias_attention_bwd_kernel(dev, n):
    """K8 from K5's saved output and lse against both plain versions on every
    row (dO unmasked: every row of K5 is computed); dead keys' dk and dv
    exactly 0."""
    rng = np.random.default_rng(n + 4)
    qkv, cos, sin, kmask = _bias_case(rng, n, dev)
    dout = _bf16(rng, (2, n, 1024), dev)
    out, lse = fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, 16, return_lse=True)
    _build.reset_launches()
    got = fused_qkv_rope_attention_bias_bwd(qkv, cos, sin, kmask, out, lse, dout, 16)
    assert _build.launches() == {"fused_qkv_rope_attention_bias_bwd": 1}
    _close(got, fused_qkv_rope_attention_bias_bwd_from_lse_ref(qkv, cos, sin, kmask, out, lse,
                                                               dout, 16))
    _close(got, fused_qkv_rope_attention_bias_bwd_ref(qkv, cos, sin, kmask, dout, 16))
    assert not got[:, :, 1024:][~kmask].any()


@pytest.mark.parametrize("n", [200, 1124])
def test_bias_attention_kernel_ragged_with_dead_tiles(dev, n):
    """K5 and its lse mode at an n that is no multiple of 64, with two
    consecutive all-dead 64-key tiles mid-row (row 1) and a dead tail in the
    partial last tile (row 0): every row against the plain version, the lse
    within 1e-3."""
    rng = np.random.default_rng(n + 11)
    qkv = _bf16(rng, (2, n, 3 * 1024), dev)
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, 16)
    kmask = torch.ones(2, n, dtype=torch.bool, device=dev)
    kmask[1, 64:192] = False
    kmask[0, n - n // 5:] = False
    _build.reset_launches()
    out = fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, 16)
    out_lse, lse = fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, 16, return_lse=True)
    assert _build.launches() == {"fused_qkv_rope_attention_bias": 1,
                                 "fused_qkv_rope_attention_bias_lse": 1}
    ref, ref_lse = fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, 16, return_lse=True)
    assert torch.equal(out, out_lse)
    assert _live_max(out, ref, torch.full((2,), n, device=dev)) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3


def test_bias_attention_autograd_launches_k8(dev):
    rng = np.random.default_rng(5)
    qkv, cos, sin, kmask = _bias_case(rng, 256, dev)
    qkv.requires_grad_()
    _build.reset_launches()
    out = fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, 16)
    out.float().sum().backward()
    assert _build.launches() == {"fused_qkv_rope_attention_bias_lse": 1,
                                 "fused_qkv_rope_attention_bias_bwd": 1}
    _close(qkv.grad, fused_qkv_rope_attention_bias_bwd_ref(qkv.detach(), cos, sin, kmask,
                                                           torch.ones_like(out), 16))


@pytest.mark.parametrize("n,length", [(64, 1), (100, 37), (1024, 777), (4224, 3001)])
def test_flash_attention_lse_kernel(dev, n, length):
    """K7's lse mode: the output as K7's, the lse within 1e-3 on live tiles
    and exactly -1e30 on the tiles past the length."""
    rng = np.random.default_rng(n + 6)
    q, k, v = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(3))
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out, lse = flash_attention_fwd(q, k, v, lengths, return_lse=True)
    assert _build.launches() == {"flash_attention_lse": 1}
    assert torch.equal(out, flash_attention(q, k, v, lengths))
    _, want = flash_attention_fwd_ref(q.float(), k.float(), v.float(), lengths, return_lse=True)
    tile_end = -(-length // 64) * 64
    assert float((lse[1, :, :tile_end] - want[1, :, :tile_end]).abs().max()) <= 1e-3
    assert float((lse[0] - want[0]).abs().max()) <= 1e-3
    assert bool((lse[1, :, tile_end:] == NEG_INF).all())


@pytest.mark.parametrize("length", [1, 63, 64, 65, 199, 200])
def test_flash_attention_kernel_edges(dev, length):
    """K7 and its lse mode at n = 200 (no multiple of 64) and lengths at the
    tile edges: every row of a live q tile against the plain version (the
    rows past the length inside it are computed over the live keys, with
    their real lse, which K9 reads), the q tiles wholly past the length
    exactly 0 with lse -1e30."""
    n = 200
    rng = np.random.default_rng(length + 13)
    q, k, v = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(3))
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out = flash_attention_fwd(q, k, v, lengths)
    out_lse, lse = flash_attention_fwd(q, k, v, lengths, return_lse=True)
    assert _build.launches() == {"flash_attention": 1, "flash_attention_lse": 1}
    assert torch.equal(out, out_lse)
    want, want_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(), lengths,
                                             return_lse=True)
    tile_end = -(-length // 64) * 64
    for i, end in enumerate((n, tile_end)):
        assert float((out[i, :, :end].float() - want[i, :, :end]).abs().max()) <= 2e-2
        assert float((lse[i, :, :end] - want_lse[i, :, :end]).abs().max()) <= 1e-3
    assert not out[1, :, tile_end:].any()
    assert bool((lse[1, :, tile_end:] == NEG_INF).all())


@pytest.mark.parametrize("n,length", [(64, 1), (100, 37), (1024, 777), (4224, 3001)])
def test_flash_attention_bwd_kernel(dev, n, length):
    """K9 against its plain version from K7's saved output and lse, dO zero
    on rows >= length; dq of dead tiles and dk, dv of dead keys exactly 0."""
    rng = np.random.default_rng(n + 7)
    q, k, v = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(3))
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    live = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, :, None]
    dout = _bf16(rng, (2, 16, n, 64), dev) * live
    o, lse = flash_attention_fwd(q, k, v, lengths, return_lse=True)
    _build.reset_launches()
    got = flash_attention_bwd(q, k, v, lengths, o, lse, dout)
    assert _build.launches() == {"flash_attention_bwd": 1}
    want = flash_attention_bwd_ref(q, k, v, lengths, o, lse, dout)
    for g, w in zip(got, want):
        _close(g, w)
        assert not g[1, :, length:].any()


@pytest.mark.parametrize("n,length", [(200, 77), (1024, 777)])
def test_flash_attention_bwd_kernel_do_past_the_length(dev, n, length):
    """K9 with dO nonzero on every row: the rows past the length inside the
    last live q tile carry a gradient. All rows against the plain version;
    dq of the dead q tiles and dk, dv of the dead keys exactly 0."""
    rng = np.random.default_rng(n + 12)
    q, k, v, dout = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(4))
    lengths = torch.tensor([n, length], dtype=torch.int32, device=dev)
    o, lse = flash_attention_fwd(q, k, v, lengths, return_lse=True)
    got = flash_attention_bwd(q, k, v, lengths, o, lse, dout)
    want = flash_attention_bwd_ref(q, k, v, lengths, o, lse, dout)
    for g, w in zip(got, want):
        _close(g, w)
    tile_end = -(-length // 64) * 64
    assert got[0][1, :, length:tile_end].any()
    assert not got[0][1, :, tile_end:].any()
    for g in got[1:]:
        assert not g[1, :, length:].any()


def test_flash_attention_autograd_launches_k7_lse_and_k9(dev):
    rng = np.random.default_rng(8)
    q, k, v = (_bf16(rng, (1, 16, 192, 64), dev).requires_grad_() for _ in range(3))
    lengths = torch.tensor([150], dtype=torch.int32, device=dev)
    _build.reset_launches()
    out = flash_attention(q, k, v, lengths)
    (out.float() * (torch.arange(192, device=dev) < 150)[:, None]).sum().backward()
    assert _build.launches() == {"flash_attention_lse": 1, "flash_attention_bwd": 1}
    with torch.no_grad():  # inference keeps the mode without lse
        _build.reset_launches()
        flash_attention(q, k, v, lengths)
        assert _build.launches() == {"flash_attention": 1}


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 8, 1024, device=dev)  # f32, not bf16
    with pytest.raises(TypeError):
        adaln_norm(x, x[:, 0], x[:, 0])
    with pytest.raises(ValueError):
        fused_qkv_rope_attention(torch.zeros(1, 8, 3 * 1024, device=dev), x[0], x[0],
                                 torch.zeros(1, dtype=torch.int32, device=dev), 16)
    xb = torch.zeros(1, 8, 320, dtype=torch.bfloat16, device=dev)
    bias = torch.zeros(320, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):  # 16 groups of 20 channels
        grouped_conv1d(xb, torch.zeros(31, 20, 320, dtype=torch.bfloat16, device=dev), bias, 16)
    with pytest.raises(ValueError, match="k <= 31"):
        grouped_conv1d(xb, torch.zeros(33, 40, 320, dtype=torch.bfloat16, device=dev), bias, 8)
    with pytest.raises(ValueError):  # f32 x
        grouped_conv1d(xb.float(), torch.zeros(31, 40, 320, dtype=torch.bfloat16, device=dev),
                       bias, 8)
    qh = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="key mask"):  # an int mask, not bool
        masked_flash_attention(qh, qh, qh, torch.ones(1, 64, dtype=torch.int32, device=dev))
    q128 = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="64"):  # head width 128 is not ported
        masked_flash_attention(q128, q128, q128, torch.ones(1, 64, dtype=torch.bool, device=dev))


@pytest.mark.parametrize("n,width,k", [(64, 48, 31), (200, 48, 31), (1024, 48, 31), (100, 24, 4),
                                       (77, 64, 7), (130, 128, 31), (50, 8, 1)])
def test_grouped_conv1d_kernel(dev, n, width, k):
    """K10 (16 groups of `width`, same padding, odd and even k) against its
    plain version in f32: max-abs <= 3e-2, K2's tolerance."""
    rng = np.random.default_rng(n + width + k)
    c = 16 * width
    x = _bf16(rng, (2, n, c), dev)
    w = _bf16(rng, (k, width, c), dev, 1.0 / np.sqrt(width * k))
    bias = _bf16(rng, (c,), dev, 0.1)
    _build.reset_launches()
    out = grouped_conv1d(x, w, bias, 16)
    assert _build.launches() == {"grouped_conv1d": 1}
    ref = grouped_conv1d_ref(x.float(), w.float(), bias.float(), 16)
    assert _live_max(out, ref, torch.full((2,), n, device=dev)) <= 3e-2


@pytest.mark.parametrize("width", [8, 16, 24, 48, 64, 120, 128])
@pytest.mark.parametrize("k", [1, 2, 4, 31])
def test_grouped_conv1d_kernel_widths(dev, width, k):
    """K10 at every padded width (resident weights, and the ring of tap
    chunks at W >= 64, k = 31), at an n below k (k > 2) and at an n that is
    no multiple of the row tile: max-abs <= 3e-2 against the plain version."""
    rng = np.random.default_rng(width * 32 + k)
    c = 16 * width
    w = _bf16(rng, (k, width, c), dev, 1.0 / np.sqrt(width * k))
    bias = _bf16(rng, (c,), dev, 0.1)
    for n in (max(1, k - 2), 200):
        x = _bf16(rng, (2, n, c), dev)
        _build.reset_launches()
        out = grouped_conv1d(x, w, bias, 16)
        assert _build.launches() == {"grouped_conv1d": 1}
        ref = grouped_conv1d_ref(x.float(), w.float(), bias.float(), 16)
        assert _live_max(out, ref, torch.full((2,), n, device=dev)) <= 3e-2


def test_grouped_conv1d_autograd_launches_k10(dev):
    rng = np.random.default_rng(1)
    x = _bf16(rng, (2, 96, 768), dev).requires_grad_()
    w = _bf16(rng, (31, 48, 768), dev, 0.03).requires_grad_()
    bias = _bf16(rng, (768,), dev, 0.1).requires_grad_()
    _build.reset_launches()
    grouped_conv1d(x, w, bias, 16).float().sum().backward()
    assert _build.launches() == {"grouped_conv1d": 1}
    xs = [t.detach().float().requires_grad_() for t in (x, w, bias)]
    grouped_conv1d_ref(*xs, 16).sum().backward()
    for got, want in zip((x, w, bias), xs):
        _close(got.grad, want.grad)


@pytest.mark.parametrize("n", [64, 200, 1152, 4352])
def test_masked_flash_attention_kernel(dev, n):
    """K11 on every row against its plain version (max-abs <= 2e-2), dead
    keys mid-sequence, a whole dead 64-key tile and a dead tail."""
    rng = np.random.default_rng(n + 9)
    q, k, v = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(3))
    kmask = _bias_case(rng, n, dev)[3]
    _build.reset_launches()
    out = masked_flash_attention(q, k, v, kmask)
    assert _build.launches() == {"masked_flash_attention": 1}
    ref = mha_reference_masked(q.float(), k.float(), v.float(), kmask)
    assert float((out.float() - ref).abs().max()) <= 2e-2


def test_masked_flash_attention_autograd_launches_k11(dev):
    """The forward is K11; the backward is the plain formula's VJP (as the
    JAX package's), which launches no kernel of the port."""
    rng = np.random.default_rng(10)
    q, k, v = (_bf16(rng, (1, 16, 192, 64), dev).requires_grad_() for _ in range(3))
    kmask = torch.ones(1, 192, dtype=torch.bool, device=dev)
    kmask[0, 50:100] = False
    _build.reset_launches()
    out = masked_flash_attention(q, k, v, kmask)
    out.float().sum().backward()
    assert _build.launches() == {"masked_flash_attention": 1}
    want = masked_flash_attention_bwd(q.detach(), k.detach(), v.detach(), kmask,
                                      torch.ones_like(out))
    for got, w in zip((q.grad, k.grad, v.grad), want):
        _close(got, w)


@pytest.mark.parametrize("n", [330, 1100])
def test_masked_flash_attention_kernel_dead_tiles(dev, n):
    """K11 at an n that is no multiple of 64: row 0 with two all-dead 64-key
    tiles between live ones and a live key alone in the partial last tile,
    row 1 with no live key at all (zeros, where the plain version gives the
    uniform mean of v). Every row of row 0 against the plain version."""
    rng = np.random.default_rng(n + 12)
    q, k, v = (_bf16(rng, (2, 16, n, 64), dev) for _ in range(3))
    kmask = torch.zeros(2, n, dtype=torch.bool, device=dev)
    kmask[0, :64] = True
    kmask[0, 192:256] = True
    kmask[0, 260:n - n % 64] = True
    kmask[0, n - 1] = True
    _build.reset_launches()
    out = masked_flash_attention(q, k, v, kmask)
    assert _build.launches() == {"masked_flash_attention": 1}
    ref = mha_reference_masked(q.float(), k.float(), v.float(), kmask)
    assert float((out[0].float() - ref[0]).abs().max()) <= 2e-2
    assert not out[1].any()


def test_tiny_dit_through_the_kernels(dev):
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast

    arch = ModelArch(dim=1024, depth=2, heads=16, dim_head=64, text_dim=64, conv_layers=1,
                     text_num_embeds=32)
    gen = torch.Generator().manual_seed(0)
    params = fuse_backbone_qkv(dit.activate_zero_init(dit.init_dit(gen, arch), gen))
    rng = np.random.default_rng(0)
    n = 256
    x = torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 32, (1, 40)).astype(np.int32))
    lens = torch.tensor([201], dtype=torch.int32)
    t = torch.tensor([0.4])
    outs = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        _build.reset_launches()
        outs[where.type] = dit.dit_forward(
            tree_cast(params, dtype, where), dit.DiTStatics(arch, where), x.to(where),
            x.to(where), text.to(where), t.to(where), lengths=lens.to(where), cfg_infer=True,
            dtype=dtype).cpu()
        if where.type == "cuda":
            assert _build.launches() == {"conv_pos_embedding": 2, "adaln_norm": 5,
                                         "fused_qkv_rope_attention": 2}
    a, b = outs["cuda"][:, :201], outs["cpu"][:, :201]
    assert float((a - b).norm() / b.norm()) <= 3e-2


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
def test_tiny_new_backbones_through_the_kernels(dev, backbone):
    """A depth-2 UNetT (K3, K6, K2) and MMDiT (K5, K1, K2) forward on the card
    in bf16 against the CPU in f32: rel-L2 <= 3e-2, launch counts exact."""
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast

    arch = ModelArch(dim=1024, depth=2, heads=16, dim_head=64, text_dim=None, conv_layers=0,
                     text_num_embeds=32)
    bdef = BACKBONES[backbone]
    gen = torch.Generator().manual_seed(0)
    params = fuse_backbone_qkv(dit.activate_zero_init(bdef.init(gen, arch), gen))
    rng = np.random.default_rng(0)
    n = 255
    x = torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 32, (1, 40)).astype(np.int32))
    lens = torch.tensor([201], dtype=torch.int32)
    t = torch.tensor([0.4])
    want = ({"fused_qkv_rope_attention": 2, "rms_norm": 5, "conv_pos_embedding": 2}
            if backbone == "UNetT" else
            {"fused_qkv_rope_attention_bias": 2, "adaln_norm": 8, "conv_pos_embedding": 2})
    outs = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        _build.reset_launches()
        with torch.no_grad():
            outs[where.type] = bdef.forward(
                tree_cast(params, dtype, where), bdef.statics_cls(arch, where), x.to(where),
                x.to(where), text.to(where), t.to(where), lengths=lens.to(where),
                cfg_infer=True, dtype=dtype).cpu()
        if where.type == "cuda":
            assert _build.launches() == want
    a, b = outs["cuda"][:, :201], outs["cpu"][:, :201]
    assert float((a - b).norm() / b.norm()) <= 3e-2


@pytest.mark.parametrize("case", ["DiT-768", "DiT-qk", "UNetT-768", "UNetT-qk", "MMDiT-qk",
                                  "MMDiT-unfused"])
def test_tiny_small_and_qk_norm_through_the_kernels(dev, case):
    """Depth-2 forwards on the card in bf16 against the CPU in f32 (rel-L2
    <= 3e-2, launch counts exact): the dim-768 widths (two K10 launches an
    input embedding, K2 none), qk-norm (K6 per head, then K7 at every n,
    or K11 for the MMDiT) and the MMDiT with unfused projections (K11)."""
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast

    backbone, kind = case.split("-")
    text = dict(text_dim=64, conv_layers=1) if backbone == "DiT" else dict(text_dim=None,
                                                                           conv_layers=0)
    width = dict(dim=768, heads=12) if kind == "768" else dict(dim=1024, heads=16)
    arch = ModelArch(depth=2, dim_head=64, text_num_embeds=32,
                     qk_norm="rms_norm" if kind == "qk" else None, **width, **text)
    bdef = BACKBONES[backbone]
    gen = torch.Generator().manual_seed(0)
    params = dit.activate_zero_init(bdef.init(gen, arch), gen)
    if kind != "unfused":
        params = fuse_backbone_qkv(params)
    conv = {"grouped_conv1d": 4} if kind == "768" else {"conv_pos_embedding": 2}
    qk = int(kind == "qk")  # qk-norm: K6 on q and k, per stream, in each of the 2 blocks
    want = {"DiT": {"adaln_norm": 5, "rms_norm": 4 * qk},
            "UNetT": {"rms_norm": 5 + 4 * qk},
            "MMDiT": {"adaln_norm": 8, "rms_norm": 8 * qk, "masked_flash_attention": 2}}[backbone]
    if backbone != "MMDiT":
        want["flash_attention" if kind == "qk" else "fused_qkv_rope_attention"] = 2
    want = {k: v for k, v in {**want, **conv}.items() if v}
    rng = np.random.default_rng(0)
    n = 255
    x = torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 32, (1, 40)).astype(np.int32))
    lens = torch.tensor([201], dtype=torch.int32)
    t = torch.tensor([0.4])
    outs = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        _build.reset_launches()
        with torch.no_grad():
            outs[where.type] = bdef.forward(
                tree_cast(params, dtype, where), bdef.statics_cls(arch, where), x.to(where),
                x.to(where), ids.to(where), t.to(where), lengths=lens.to(where),
                cfg_infer=True, dtype=dtype).cpu()
        if where.type == "cuda":
            assert _build.launches() == want
    a, b = outs["cuda"][:, :201], outs["cpu"][:, :201]
    assert float((a - b).norm() / b.norm()) <= 3e-2


def _tiny_training_step(dev, backbone: str, arch, expect: dict):
    """One grad step of a depth-2 model on the card (bf16, the kernels)
    against the CPU (f32, the plain versions) with the same draws: loss
    within 2e-2 relative, every gradient leaf's rel-L2 <= 1e-1; launch
    counts exact."""
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.cfm import BACKBONES, make_draws
    from f5tts_tpu_torch.models.modules import tree_cast, tree_leaves
    from f5tts_tpu_torch.train.step import make_optimizer, make_train_step

    bdef = BACKBONES[backbone]
    gen = torch.Generator().manual_seed(0)
    params = dit.activate_zero_init(bdef.init(gen, arch), gen)
    rng = np.random.default_rng(0)
    b, n = 2, 200
    mel = torch.from_numpy(rng.standard_normal((b, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 32, (b, 40)).astype(np.int32))
    lens = torch.tensor([200, 131], dtype=torch.int32)
    draws = make_draws(torch.Generator().manual_seed(1), b, n, 100)
    out = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        step = make_train_step(bdef.statics_cls(arch, where), make_optimizer(1e-4, 10, 100),
                               dtype=dtype, backbone=bdef)
        _build.reset_launches()
        loss, grads = step.grad_step(tree_cast(params, torch.float32, where), mel.to(where),
                                     text.to(where), lens.to(where), draws=draws)
        if where.type == "cuda":
            assert _build.launches() == expect
        out[where.type] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)])
    (la, ga), (lb, gb) = out["cuda"], out["cpu"]
    assert abs(la - lb) <= 2e-2 * abs(lb)
    for a, w in zip(ga, gb):
        if float(w.norm()) > 0:
            assert float((a - w).norm() / w.norm()) <= 1e-1


def test_tiny_dit_training_step_on_the_card(dev):
    from f5tts_tpu_torch.config import ModelArch

    arch = ModelArch(dim=1024, depth=2, heads=16, dim_head=64, text_dim=64, conv_layers=1,
                     text_num_embeds=32)
    _tiny_training_step(dev, "DiT", arch, {
        "fused_qkv_rope_attention_lse": 2, "fused_qkv_rope_attention_bwd": 2, "adaln_norm": 5,
        "conv_pos_embedding": 1})


@pytest.mark.parametrize("backbone,gate", [("UNetT", "flat"), ("UNetT", "heads"),
                                           ("MMDiT", "joint")])
def test_tiny_new_backbone_training_steps_on_the_card(dev, backbone, gate, monkeypatch):
    """The UNetT on both sides of the self-attention gate (K3's lse mode / K4,
    or K7's lse mode and K9 with FLAT_ATTN_MAX_N lowered) and the MMDiT (K5's
    lse mode / K8)."""
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.models import modules

    if gate == "heads":
        monkeypatch.setattr(modules, "FLAT_ATTN_MAX_N", 128)
    arch = ModelArch(dim=1024, depth=2, heads=16, dim_head=64, text_dim=None, conv_layers=0,
                     text_num_embeds=32)
    attn = {"flat": {"fused_qkv_rope_attention_lse": 2, "fused_qkv_rope_attention_bwd": 2},
            "heads": {"flash_attention_lse": 2, "flash_attention_bwd": 2},
            "joint": {"fused_qkv_rope_attention_bias_lse": 2,
                      "fused_qkv_rope_attention_bias_bwd": 2}}[gate]
    rest = ({"rms_norm": 5, "conv_pos_embedding": 1} if backbone == "UNetT"
            else {"adaln_norm": 8, "conv_pos_embedding": 1})
    _tiny_training_step(dev, backbone, arch, {**attn, **rest})


@pytest.mark.parametrize("backbone", ["DiT", "MMDiT"])
def test_pipeline_graph_replay_equals_eager(dev, backbone):
    """`InferencePipeline.fused_generate` on the card: the first call warms up
    (eager launches on the host counter) and captures (the capture's counts
    on the graph entry: one generate's); a repeat in the captured key adds 0
    to the host counter and equals the eager cfm_sample + Vocos on the same
    inputs (the same kernels in the same order: bit-equal, or within mel
    rel-L2 1e-3 and wav max-abs 1e-3)."""
    _graph_replay_case(dev, backbone, "none")


@pytest.mark.parametrize("backbone", ["DiT", "MMDiT"])
def test_int8_pipeline_graph_replay_equals_eager(dev, backbone):
    """As above with quantization="int8": the capture records the int8
    product and K13 once per quantized projection (4 a DiT block, 8 an
    MMDiT block and 5 in its last block), K1Q for every norm of a block
    (the final one stays K1), the GELU mode before each ff.out and the
    plain K12 before each to_out (`_int8_step`)."""
    _graph_replay_case(dev, backbone, "int8")


def _graph_replay_case(dev, backbone: str, quantization: str):
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models import cfm, dit
    from f5tts_tpu_torch.utils import make_time_grid
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig, init_vocos

    bdef = cfm.BACKBONES[backbone]
    arch = ModelArch(dim=1024, depth=2, heads=16, dim_head=64, text_num_embeds=32,
                     text_dim=64 if backbone == "DiT" else None,
                     conv_layers=1 if backbone == "DiT" else 0)
    gen = torch.Generator().manual_seed(0)
    params = dit.activate_zero_init(bdef.init(gen, arch), gen)
    vcfg = VocosConfig(dim=64, intermediate_dim=128, num_layers=2)
    pipe = InferencePipeline(params, bdef.statics_cls(arch),
                             Vocos(init_vocos(torch.Generator().manual_seed(1), vcfg), vcfg,
                                   device=dev), device=dev, backbone=backbone,
                             quantization=quantization)
    rng = np.random.default_rng(0)
    n, nfe = 256, 2
    dur = torch.tensor([201], dtype=torch.int32, device=dev)
    req = dict(cond=torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32)).to(dev),
               text=torch.from_numpy(rng.integers(0, 32, (1, 64)).astype(np.int32)).to(dev),
               lens=torch.tensor([50], dtype=torch.int32, device=dev), duration=dur,
               t_grid=make_time_grid(nfe, sway_sampling_coef=-1.0))
    per_step = ({"fused_qkv_rope_attention": 2, "adaln_norm": 5, "conv_pos_embedding": 2}
                if backbone == "DiT" else
                {"fused_qkv_rope_attention_bias": 2, "adaln_norm": 8, "conv_pos_embedding": 2})
    if quantization == "int8":
        per_step.update(_int8_step(backbone))
    expect = {k: v * nfe for k, v in per_step.items()}

    def noise(seed):
        return cfm.make_noise(torch.Generator(device=dev).manual_seed(seed), 1, n, 100, dur, 4096)

    _build.reset_launches()
    pipe.fused_generate(**req, y0=noise(0), cfg_strength=2.0)
    torch.cuda.synchronize()
    (entry,) = pipe.graphs.values()
    assert _build.launches() == expect  # the warm-up
    assert entry.counts == expect and entry.replays == 1
    _build.reset_launches()
    mel, wav = pipe.fused_generate(**req, y0=noise(1), cfg_strength=1.5)
    torch.cuda.synchronize()
    assert _build.launches() == {} and entry.replays == 2
    want = cfm.cfm_sample(pipe.params, pipe.statics, req["cond"], req["text"], req["lens"], dur,
                          req["t_grid"].to(dev), y0=noise(1), cfg_strength=1.5,
                          dtype=torch.bfloat16, backbone=bdef)
    want_wav = pipe.vocoder(want.transpose(1, 2))
    if not (torch.equal(mel, want) and torch.equal(wav, want_wav)):
        assert float((mel - want).norm() / want.norm()) <= 1e-3
        assert float((wav - want_wav).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# int8 W8A8: K12 (the row quantize), K13 (the dequant + bias), the int8 product
# ---------------------------------------------------------------------------

INT8_KERNELS = ("quantize_rows", "int8_mm", "dequant_bias")


def _int8_step(backbone: str) -> dict:
    """A depth-2 int8 step's launches beside bf16's attention and conv
    position: the product and K13 a projection; K1Q / K6Q for each norm of a
    block (the final norm stays K1 / K6); the GELU mode before each ff.out
    and the plain K12 before each to_out (the MMDiT: one block and its
    context_pre_only last block)."""
    if backbone == "MMDiT":
        return {"int8_mm": 13, "dequant_bias": 13, "adaln_norm": 1, "adaln_norm_quant": 7,
                "gelu_quantize_rows": 3, "quantize_rows": 3}
    norm = "rms_norm" if backbone == "UNetT" else "adaln_norm"
    return {"int8_mm": 8, "dequant_bias": 8, norm: 1, f"{norm}_quant": 4,
            "gelu_quantize_rows": 2, "quantize_rows": 2}


@pytest.mark.parametrize("m", [17, 37, 2048])
@pytest.mark.parametrize("k", [8, 1024, 3072, 4096])
def test_quantize_rows_kernel_bit_equal(dev, m, k):
    """K12's codes and scales equal its plain version's bit for bit; an
    all-zero row gets scale 1 and codes 0."""
    from f5tts_tpu_torch.ops.quant import quantize_rows, quantize_rows_ref

    rng = np.random.default_rng(m + k)
    x = _bf16(rng, (m, k), dev, scale=3.0)
    x[m // 2] = 0
    _build.reset_launches()
    codes, scale = quantize_rows(x)
    assert _build.launches() == {"quantize_rows": 1}
    ref_c, ref_s = quantize_rows_ref(x)
    assert torch.equal(codes, ref_c) and torch.equal(scale, ref_s)
    assert not codes[m // 2].any() and float(scale[m // 2]) == 1.0


def test_quantize_rows_kernel_strided_rows(dev):
    """K12 reads the MMDiT's text rows in place from a joint output (rows at
    two strides) and writes them contiguous."""
    from f5tts_tpu_torch.ops.quant import quantize_rows, quantize_rows_ref

    o = _bf16(np.random.default_rng(3), (3, 200 + 56, 1024), dev)
    view = o[:, 200:]
    codes, scale = quantize_rows(view)
    ref_c, ref_s = quantize_rows_ref(view)
    assert codes.is_contiguous() and codes.shape == view.shape
    assert torch.equal(codes, ref_c) and torch.equal(scale, ref_s)
    with pytest.raises(TypeError):
        quantize_rows(o.float())


# K1Q / K6Q's (b, n, d): the main paths' rows, and b = 3 at n = 1 and 37
# over the lane layouts (d = 64: 8 lanes and 4 rows a thread; 4096: the
# epilogue's columns read at use)
FUSED_NORM_SHAPES = [(2, 1024, 1024), (2, 256, 1024), (2, 100, 768)] + [
    (3, n, d) for n in (1, 37) for d in (64, 1024, 4096)]


@pytest.mark.parametrize("b,n,d", FUSED_NORM_SHAPES)
@pytest.mark.parametrize("mode", ["adaln", "rms"])
def test_fused_norm_quant_kernels_bit_equal(dev, mode, b, n, d):
    """K1Q and K6Q (the row engine's quantize stage) equal K1 -> K12 and K6
    -> K12 on the card bit for bit, one launch each; an all-zero row (in
    K1Q a batch whose shift is 0) gets scale 1 and codes 0."""
    from f5tts_tpu_torch.ops.adaln_norm import adaln_norm_quant, rms_norm_quant
    from f5tts_tpu_torch.ops.quant import quantize_rows

    rng = np.random.default_rng(b * n + d)
    x = _bf16(rng, (b, n, d), dev, scale=2.0)
    x[0, n // 2] = 0
    if mode == "adaln":
        mods = _bf16(rng, (b, 6 * d), dev, scale=0.2)
        mods[0, :d] = 0
        shift, scale = mods[:, :d], mods[:, d:2 * d]
        _build.reset_launches()
        codes, sc = adaln_norm_quant(x, scale, shift)
        assert _build.launches() == {"adaln_norm_quant": 1}
        want_c, want_s = quantize_rows(adaln_norm(x, scale, shift))
    else:
        w = _bf16(rng, (d,), dev, scale=0.1) + 1
        _build.reset_launches()
        codes, sc = rms_norm_quant(x, w, 1e-8)
        assert _build.launches() == {"rms_norm_quant": 1}
        want_c, want_s = quantize_rows(rms_norm(x, w, 1e-8))
    assert codes.shape == x.shape and sc.shape == (b, n, 1)
    assert torch.equal(codes, want_c) and torch.equal(sc, want_s)
    assert not codes[0, n // 2].any() and float(sc[0, n // 2]) == 1.0


def test_rms_norm_quant_kernel_strided_head_view(dev):
    """K6Q reads a head view of a fused projection in place (three leading
    strides), as K6 does, and writes contiguous codes."""
    from f5tts_tpu_torch.ops.adaln_norm import rms_norm_quant
    from f5tts_tpu_torch.ops.quant import quantize_rows

    qkv = _bf16(np.random.default_rng(4), (2, 77, 3 * 4 * 64), dev)
    view = qkv[..., 256:512].view(2, 77, 4, 64).transpose(1, 2)
    w = torch.ones(64, device=dev)
    codes, sc = rms_norm_quant(view, w)
    want_c, want_s = quantize_rows(rms_norm(view, w))
    assert codes.is_contiguous() and torch.equal(codes, want_c) and torch.equal(sc, want_s)


@pytest.mark.parametrize("m", [17, 37, 2048])
@pytest.mark.parametrize("k", [8, 1024, 2048, 4096])
def test_gelu_quantize_rows_kernel(dev, m, k):
    """K12's GELU mode against F.gelu(x, "tanh") + K12 on the card: bit-equal,
    or codes within 1 at no more than 0.1% of the entries and scales within
    2 f32 ulp (the card's tanhf may round apart from PyTorch's build); an
    all-zero row gets scale 1 and codes 0; one launch."""
    from f5tts_tpu_torch.ops.quant import gelu_quantize_rows, quantize_rows

    rng = np.random.default_rng(m * k)
    x = _bf16(rng, (m, k), dev, scale=2.0)
    x[m // 2] = 0
    _build.reset_launches()
    codes, sc = gelu_quantize_rows(x)
    assert _build.launches() == {"gelu_quantize_rows": 1}
    want_c, want_s = quantize_rows(torch.nn.functional.gelu(x, approximate="tanh"))
    dc = (codes.int() - want_c.int()).abs()
    assert int(dc.max()) <= 1 and int((dc > 0).sum()) <= 1e-3 * dc.numel()
    ulp = torch.nextafter(want_s, want_s + 1) - want_s
    assert bool(((sc - want_s).abs() <= 2 * ulp).all())
    assert not codes[m // 2].any() and float(sc[m // 2]) == 1.0


@pytest.mark.parametrize("m", [17, 37, 2048])
@pytest.mark.parametrize("n", [8, 1024, 3072, 4096])
def test_dequant_bias_kernel_bit_equal(dev, m, n):
    """K13 equals its plain version bit for bit (as int16 views), with and
    without a bias."""
    from f5tts_tpu_torch.ops.quant import dequant_bias, dequant_bias_ref

    gen = torch.Generator(device=dev).manual_seed(m * n)
    acc = torch.randint(-2**24, 2**24, (m, n), dtype=torch.int32, device=dev, generator=gen)
    acc[0] = 0
    xs = torch.rand(m, device=dev, generator=gen) * 3e-2 + 1e-3
    ws = torch.rand((1, n), device=dev, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(n, device=dev, generator=gen).to(torch.bfloat16)
    for b in (bias, None):
        _build.reset_launches()
        y = dequant_bias(acc, xs, ws, b, torch.bfloat16)
        assert _build.launches() == {"dequant_bias": 1}
        ref = dequant_bias_ref(acc, xs, ws, b, torch.bfloat16)
        assert torch.equal(y.view(torch.int16), ref.view(torch.int16))


def test_int8_linear_on_the_card(dev):
    """One int8 projection (K12, `torch._int_mm`, K13) on bf16 against the
    CPU's f32 plain path on the same int8 leaf: the codes may differ where
    bf16 and f32 round x differently, so rel-L2 <= 1e-2; the int8 product
    is exact (against an f64 product of the same codes)."""
    from f5tts_tpu_torch.ops.quant import int8_linear, quantize_weight

    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((1024, 3072)) / 32).astype(np.float32))
    w_i8, scale = quantize_weight(w)
    p = {"w_i8": w_i8.t().contiguous(), "w_scale": scale,
         "b": torch.from_numpy((0.1 * rng.standard_normal(3072)).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((2, 300, 1024)).astype(np.float32))
    pd = {"w_i8": p["w_i8"].to(dev), "w_scale": p["w_scale"].to(dev),
          "b": p["b"].to(dev, torch.bfloat16)}
    _build.reset_launches()
    got = int8_linear(pd, x.to(dev, torch.bfloat16))
    assert _build.launches() == {name: 1 for name in INT8_KERNELS}
    want = int8_linear(p, x)
    assert float((got.float().cpu() - want).norm() / want.norm()) <= 1e-2
    xq = torch.randint(-127, 128, (600, 1024), dtype=torch.int8, device=dev)
    exact = (xq.double() @ pd["w_i8"].double().t()).to(torch.int32)
    assert torch.equal(torch._int_mm(xq, pd["w_i8"].t()), exact)


@pytest.mark.parametrize("backbone", ["DiT", "UNetT", "MMDiT"])
def test_tiny_int8_backbones_through_the_kernels(dev, backbone):
    """A depth-2 int8 forward at dim 1024 on the card in bf16 against the
    CPU's int8 plain path in f32: rel-L2 <= 3e-2, launch counts exact."""
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast
    from f5tts_tpu_torch.ops.quant import quantize_dit_params

    dit_like = backbone == "DiT"
    arch = ModelArch(dim=1024, depth=2, heads=16, dim_head=64, text_num_embeds=32,
                     text_dim=64 if dit_like else None, conv_layers=1 if dit_like else 0)
    bdef = BACKBONES[backbone]
    gen = torch.Generator().manual_seed(0)
    params = fuse_backbone_qkv(dit.activate_zero_init(bdef.init(gen, arch), gen))
    rng = np.random.default_rng(0)
    n = 256 - bdef.seq_extra_tokens
    x = torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 32, (1, 40)).astype(np.int32))
    lens = torch.tensor([201], dtype=torch.int32)
    t = torch.tensor([0.4])
    want = {"DiT": {"fused_qkv_rope_attention": 2}, "UNetT": {"fused_qkv_rope_attention": 2},
            "MMDiT": {"fused_qkv_rope_attention_bias": 2}}[backbone]
    want.update(conv_pos_embedding=2, **_int8_step(backbone))
    outs = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        _build.reset_launches()
        with torch.no_grad():
            outs[where.type] = bdef.forward(
                quantize_dit_params(tree_cast(params, dtype, where)),
                bdef.statics_cls(arch, where), x.to(where), x.to(where), text.to(where),
                t.to(where), lengths=lens.to(where), cfg_infer=True, dtype=dtype).cpu()
        if where.type == "cuda":
            assert _build.launches() == want
    a, b = outs["cuda"][:, :201], outs["cpu"][:, :201]
    assert float((a - b).norm() / b.norm()) <= 3e-2
