"""Port sampler (f5tts_tpu_torch.models.cfm) against the JAX sampler on the CPU.

`cfm_sample(y0=...)` over 4 Euler steps (sway -1, CFG 2) with the same
numpy-seeded weights, prompt, text and noise on both sides, f32; plus the
noise semantics of `make_noise` and `compute_duration`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.utils import make_time_grid
from tests.test_torch_dit import _live, _np, _t, jx, small_dit
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def model():
    return small_dit(seed=1)


@pytest.mark.parametrize("cfg_strength", [2.0, 0.0])
def test_cfm_sample_matches_jax(model, cfg_strength):
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(11)
    b, n, nfe = 2, 256, 4
    lens = np.array([60, 90], np.int32)
    dur = np.array([256, 201], np.int32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, 80)).astype(np.int32)
    text[1, 70:] = -1
    y0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    y0[1, 201:] = 0
    grid_j = j_make_time_grid(nfe, sway_sampling_coef=-1.0)
    grid_t = make_time_grid(nfe, sway_sampling_coef=-1.0)
    np.testing.assert_array_equal(_np(grid_t), np.asarray(grid_j))
    want = np.asarray(jcfm.cfm_sample(
        jx(tree), jdit.DiTStatics(jarch), jnp.asarray(cond), jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(dur), grid_j, y0=jnp.asarray(y0),
        cfg_strength=cfg_strength, dtype=jnp.float32, backend="xla"))
    got = _np(tcfm.cfm_sample(tp, tdit.DiTStatics(tarch), _t(cond), _t(text), _t(lens),
                              _t(dur), grid_t, y0=_t(y0), cfg_strength=cfg_strength,
                              dtype=torch.float32))
    # prompt frames are re-imposed exactly
    for i in range(b):
        np.testing.assert_array_equal(got[i, :lens[i]], cond[i, :lens[i]])
    # f32 through 4 steps of a 2-block DiT: sum-order drift only
    np.testing.assert_allclose(_live(got, dur), _live(want, dur), atol=2e-3, rtol=1e-3)
    assert np.abs(_live(got, dur) - _live(y0, dur)).max() > 0.1  # the flow moved x


def test_make_noise_shared_panel_and_bucket_invariant():
    dur = torch.tensor([300, 120], dtype=torch.int32)
    a = tcfm.make_noise(torch.Generator().manual_seed(5), 2, 384, 100, dur, noise_max_len=4096)
    b = tcfm.make_noise(torch.Generator().manual_seed(5), 2, 512, 100, dur, noise_max_len=4096)
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, 384, 100)
    # one panel shared by every row; rows >= duration are zero
    torch.testing.assert_close(a[0, :120], a[1, :120])
    assert not a[1, 120:].any() and not a[0, 300:].any()
    assert a[0, :300].std() > 0.9
    # the same seed gives the same noise in another bucket
    torch.testing.assert_close(a[:, :384], b[:, :384])


def test_compute_duration_matches_jax():
    text_lens = np.array([10, 400, 90], np.int32)
    prompt = np.array([200, 100, 300], np.int32)
    req = np.array([150, 380, 5000], np.int32)
    want = np.asarray(jcfm.compute_duration(jnp.asarray(text_lens), jnp.asarray(prompt),
                                            jnp.asarray(req), 4096))
    got = _np(tcfm.compute_duration(_t(text_lens), _t(prompt), _t(req), 4096))
    np.testing.assert_array_equal(got, want)


def test_cfm_sample_needs_noise(model):
    _, tarch, _, tp = model
    z = torch.zeros(1, 128, 100)
    with pytest.raises(ValueError):
        tcfm.cfm_sample(tp, tdit.DiTStatics(tarch), z, torch.zeros(1, 8, dtype=torch.int32),
                        torch.tensor([10]), torch.tensor([100]), make_time_grid(2))
