"""Port Vocos, iSTFT and mel front end against the JAX package on the CPU (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import MelConfig as JMelConfig
from f5tts_tpu.ops import mel as jmel
from f5tts_tpu.ops import stft as jstft
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.convert import vocos_params_from_jax
from f5tts_tpu_torch.ops import mel as tmel
from f5tts_tpu_torch.ops import stft as tstft
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_VOCOS = dict(dim=64, intermediate_dim=128, num_layers=2)


def test_mel_filterbank_and_window_match_jax():
    np.testing.assert_array_equal(tmel.mel_filterbank(24000, 1024, 100),
                                  jmel.mel_filterbank(24000, 1024, 100, mel_scale="htk"))
    np.testing.assert_array_equal(_np(tstft.hann_window(1024)), np.asarray(jstft.hann_window(1024)))
    assert MelConfig() == MelConfig(**{k: getattr(JMelConfig(), k) for k in (
        "target_sample_rate", "n_mel_channels", "hop_length", "win_length", "n_fft",
        "mel_spec_type")})


def test_mel_frontend_matches_jax():
    wav = (np.random.default_rng(0).standard_normal((2, 24000)) * 0.1).astype(np.float32)
    want = np.asarray(jmel.MelFrontend(JMelConfig())(jnp.asarray(wav)))
    got = _np(tmel.MelFrontend(MelConfig(), device="cpu")(_t(wav)))
    assert got.shape == want.shape == (2, 100, 24000 // 256 + 1)
    # log-mel of an f32 FFT (two FFT libraries): 1e-3 absolute on values ~ -11..2
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_istft_matches_jax():
    rng = np.random.default_rng(1)
    real = rng.standard_normal((2, 513, 40)).astype(np.float32)
    imag = rng.standard_normal((2, 513, 40)).astype(np.float32)
    want = np.asarray(jstft.istft_center(jnp.asarray(real), jnp.asarray(imag),
                                         jstft.hann_window(1024), use_matmul_dft=False))
    got = _np(tstft.istft_center(_t(real), _t(imag), tstft.hann_window(1024)))
    assert got.shape == want.shape == (2, 39 * 256)
    np.testing.assert_allclose(got, want, atol=1e-5)
    frames = rng.standard_normal((2, 6, 1024)).astype(np.float32)
    np.testing.assert_allclose(_np(tstft.overlap_add(_t(frames), 256)),
                               np.asarray(jstft.overlap_add(jnp.asarray(frames), 256)), atol=1e-5)


@pytest.mark.parametrize("t_frames", [33, 96])
def test_vocos_decode_matches_jax(t_frames):
    jcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    tree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jcfg), 3)
    mel = (np.random.default_rng(2).standard_normal((2, 100, t_frames)) - 3.0).astype(np.float32)
    want = np.asarray(jvocos.vocos_decode(jx(tree), jnp.asarray(mel), jcfg))
    voc = tvocos.Vocos(vocos_params_from_jax(tree), tvocos.VocosConfig(**SMALL_VOCOS), device="cpu")
    got = _np(voc(_t(mel)))
    assert got.shape == want.shape == (2, (t_frames - 1) * 256)
    assert np.abs(want).max() > 1e-3
    # f32 ConvNeXt stack + exp(mag) head + iSTFT: relative 1e-4 of the peak
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_vocos_init_shapes_match_jax():
    jcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    jt = jax.eval_shape(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jcfg))
    conv = vocos_params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jt))
    tp = tvocos.init_vocos(torch.Generator().manual_seed(0), tvocos.VocosConfig(**SMALL_VOCOS))
    shape = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shape(tp) == shape(conv)
