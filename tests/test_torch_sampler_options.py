"""The sampler's options in the port (f5tts_tpu_torch.models.cfm) against the
JAX sampler on the CPU: the midpoint ODE, `edit_mask`, `no_ref_audio` and
the `duplicate_test_start` restart, for the DiT, UNetT and MMDiT at depth 2.

The same numpy-seeded weights (every AdaLN leaf random), prompt, text and
noise on both sides, f32, the JAX side on its XLA path. Live rows are
compared, as `test_torch_sampler.py` compares the Euler sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import unett as junett
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import mmdit as tmmdit
from f5tts_tpu_torch.models import unett as tunett
from f5tts_tpu_torch.utils import make_time_grid
from tests.test_torch_dit import _live, _np, _t, jx, small_dit, one_torch_thread  # noqa: F401
from tests.test_torch_mmdit import small_mmdit
from tests.test_torch_unett import small_unett

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# backbone -> (small model, JAX statics, port statics, frames n)
BACKBONES = {
    "DiT": (small_dit, jdit.DiTStatics, tdit.DiTStatics, 128),
    "UNetT": (small_unett, junett.UNetTStatics, tunett.UNetTStatics, 127),  # + the time token
    "MMDiT": (small_mmdit, jmmdit.MMDiTStatics, tmmdit.MMDiTStatics, 128),
}


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbone(request):
    name = request.param
    make, jstat, tstat, n = BACKBONES[name]
    jarch, tarch, tree, tp = make(seed=3)
    return name, jx(tree), jstat(jarch), tp, tstat(tarch), n


def _inputs(n: int, seed: int = 21):
    rng = np.random.default_rng(seed)
    b = 2
    lens = np.array([50, 70], np.int32)
    dur = np.array([n, n - 20], np.int32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, 48)).astype(np.int32)
    text[1, 40:] = -1
    y0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    y0[1, n - 20:] = 0
    return lens, dur, cond, text, y0


def _both(backbone, cond, text, lens, dur, grid_j, grid_t, y0, **kw):
    name, jp, jstat, tp, tstat, _ = backbone
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(jcfm.cfm_sample(
        jp, jstat, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lens), jnp.asarray(dur),
        grid_j, y0=jnp.asarray(y0), cfg_strength=2.0, dtype=jnp.float32, backend="xla",
        backbone=jcfm.BACKBONES[name], **jkw))
    got = _np(tcfm.cfm_sample(tp, tstat, _t(cond), _t(text), _t(lens), _t(dur), grid_t,
                              y0=_t(y0), cfg_strength=2.0, dtype=torch.float32,
                              backbone=tcfm.BACKBONES[name], **tkw))
    return got, want


def _edit_mask(b: int, n: int) -> np.ndarray:
    """Two regenerated spans, one inside each row's prompt: no prefix mask."""
    mask = np.ones((b, n), bool)
    mask[0, 10:25] = False
    mask[0, 35:40] = False
    mask[1, 20:30] = False
    mask[1, 55:68] = False
    return mask


@pytest.mark.parametrize("option", ["midpoint", "edit_mask", "no_ref_audio", "restart"])
def test_sampler_option_matches_jax(backbone, option):
    n = backbone[5]
    lens, dur, cond, text, y0 = _inputs(n)
    b = cond.shape[0]
    grid_j = j_make_time_grid(3, sway_sampling_coef=-1.0)
    grid_t = make_time_grid(3, sway_sampling_coef=-1.0)
    kw = {}
    if option == "midpoint":
        kw["method"] = "midpoint"
    elif option == "edit_mask":
        kw["edit_mask"] = _edit_mask(b, n)
    elif option == "no_ref_audio":
        kw["no_ref_audio"] = True
    else:  # restart from a ground-truth mel at t_inter 0.3 (5 steps -> 3 remain:
        # the Euler grid's length, so the JAX side reuses edit_mask's compile)
        gt = np.random.default_rng(5).standard_normal((b, n, 100)).astype(np.float32)
        noise = np.asarray(jcfm.make_noise(jax.random.PRNGKey(7), b, n, 100, jnp.asarray(dur)))
        y0_j, grid_j, rem_j = jcfm.duplicate_test_start(
            jax.random.PRNGKey(7), jnp.asarray(gt), n, 50, jnp.asarray(dur), 5, t_inter=0.3,
            sway_sampling_coef=-1.0)
        y0_t, grid_t, rem_t = tcfm.duplicate_test_start(
            _t(gt), n, 50, _t(dur), 5, t_inter=0.3, sway_sampling_coef=-1.0, noise=_t(noise))
        assert rem_t == rem_j == 3
        np.testing.assert_array_equal(_np(grid_t), np.asarray(grid_j))
        np.testing.assert_allclose(_np(y0_t), np.asarray(y0_j), atol=1e-6)
        y0 = np.asarray(y0_j)
    got, want = _both(backbone, cond, text, lens, dur, grid_j, grid_t, y0, **kw)

    prompt = np.arange(n)[None, :] < lens[:, None]
    keep = prompt & kw["edit_mask"] if option == "edit_mask" else prompt
    if option == "edit_mask":  # holes inside the prompt: no prefix mask
        assert (prompt & ~keep).any()
    want_kept = np.zeros_like(cond) if option == "no_ref_audio" else cond
    # the kept cond frames (zeros without the reference audio) are re-imposed
    np.testing.assert_array_equal(np.where(keep[:, :, None], got, 0.0),
                                  np.where(keep[:, :, None], want_kept, 0.0))
    # f32 through 3 steps (6 passes at midpoint) of a 2-block backbone
    np.testing.assert_allclose(_live(got, dur), _live(want, dur), atol=2e-3, rtol=1e-3)
    regenerated = (np.arange(n)[None, :] < dur[:, None]) & ~keep
    assert np.abs(got - y0)[regenerated].max() > 0.1  # the flow moved them


@pytest.mark.parametrize("nfe,sway", [(3, -1.0), (16, None), (32, -1.0), (7, 0.5)])
def test_midpoint_t_values_bit_equal(nfe, sway):
    """The t of every backbone pass, in the JAX scan's f32 order: the grid,
    then grid[:steps] + 0.5 * dts (JAX cfm.py:226-234); the port's
    precomputed modulations read them."""
    grid_j = j_make_time_grid(nfe, sway_sampling_coef=sway)
    want = np.asarray(jax.jit(lambda g: jnp.concatenate(
        [g[:nfe], g[:nfe] + 0.5 * (g[1:] - g[:-1])]))(grid_j))
    seen = []

    class Seen(Exception):
        pass

    def spy(params, t_values, batch, dtype):  # the values, then stop the sampler
        seen.append(_np(t_values))
        raise Seen

    _, tarch, _, tp = small_dit(seed=1)
    lens, dur, cond, text, y0 = _inputs(128)
    with pytest.raises(Seen):
        tcfm.cfm_sample(tp, tdit.DiTStatics(tarch), _t(cond), _t(text), _t(lens), _t(dur),
                        make_time_grid(nfe, sway_sampling_coef=sway), y0=_t(y0),
                        dtype=torch.float32, method="midpoint",
                        backbone=tcfm.DIT._replace(precompute_mods=spy))
    np.testing.assert_array_equal(seen[0], want)


def test_duplicate_test_start_matches_jax():
    """y0 from the JAX noise to 1e-6; the grid and the remaining steps equal,
    at t_inter 0.1 (JAX's default: 28 of 32 steps, linspace(0.1, 1, 29)),
    with and without sway, the ground truth longer and shorter than the room
    past the prompt."""
    rng = np.random.default_rng(9)
    dur = np.array([300, 250], np.int32)
    for steps, t_inter, sway, n_gt in ((32, 0.1, None, 400), (32, 0.1, -1.0, 120),
                                       (16, 0.25, -1.0, 300), (1, 0.5, None, 50)):
        gt = rng.standard_normal((2, n_gt, 100)).astype(np.float32)
        key = jax.random.PRNGKey(steps)
        y0_j, grid_j, rem_j = jcfm.duplicate_test_start(key, jnp.asarray(gt), 384, 90,
                                                        jnp.asarray(dur), steps, t_inter, sway)
        noise = jcfm.make_noise(key, 2, 384, 100, jnp.asarray(dur))
        y0_t, grid_t, rem_t = tcfm.duplicate_test_start(_t(gt), 384, 90, _t(dur), steps,
                                                        t_inter, sway, noise=_t(noise))
        assert rem_t == rem_j
        np.testing.assert_array_equal(_np(grid_t), np.asarray(grid_j))
        np.testing.assert_allclose(_np(y0_t), np.asarray(y0_j), atol=1e-6)
    # the seed's noise when none is passed: rows past the duration and the
    # ground truth (90 + 50 frames) are zero
    y0, grid, rem = tcfm.duplicate_test_start(_t(gt), 384, 90, _t(dur), 8,
                                              generator=torch.Generator().manual_seed(0))
    assert y0.shape == (2, 384, 100) and rem == 7 and grid.shape == (8,)
    assert torch.isfinite(y0).all() and not y0[1, 250:].any() and y0[1, :250].std() > 0.5


def test_bad_method_raises(backbone):
    name, _, _, tp, tstat, n = backbone
    lens, dur, cond, text, y0 = _inputs(n)
    with pytest.raises(ValueError, match="unknown ODE method"):
        tcfm.cfm_sample(tp, tstat, _t(cond), _t(text), _t(lens), _t(dur), make_time_grid(2),
                        y0=_t(y0), dtype=torch.float32, method="rk4",
                        backbone=tcfm.BACKBONES[name])


def test_linspace_from_t_start_bit_equal():
    """`linspace_f32` against jnp.linspace from random starts in (0, 1):
    every num up to 65 (the grids of up to 64 steps, which cover every
    preset: duplicate_test_start's linspace(t_inter, 1, remaining + 1) and
    make_time_grid's from t_start > 0), and a few up to the 513 points the
    port guarantees. It copies XLA's CPU code generation, so a change there
    shows here."""
    from f5tts_tpu_torch.utils import linspace_f32

    rng = np.random.default_rng(13)
    for k, start in enumerate(rng.uniform(0.0, 1.0, 6)):
        nums = (*range(2, 66), 129, 257, 513) if k < 3 else (2, 3, 4, 29, 34, 35, 36, 64, 129,
                                                                257, 513)
        for num in nums:
            np.testing.assert_array_equal(
                _np(linspace_f32(start, 1.0, num)),
                np.asarray(jnp.linspace(start, 1.0, num, dtype=jnp.float32)),
                err_msg=f"start {start}, num {num}")
