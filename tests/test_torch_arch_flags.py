"""The arch flags (long skip, average upsampling, activation checkpointing)
and the training options (unfused QKV, bf16 state) against the JAX package,
on the CPU.

Small DiT (tests/test_torch_dit.py:SMALL), numpy-seeded weights on both
sides, f32; the JAX side on its XLA path.
- `long_skip_connection` and `text_embedding_average_upsampling`: the
  packed-CFG forward within test_torch_dit.py's tolerances, `cfm_sample` at
  4 NFE within test_torch_sampler.py's; `average_upsample_text` bit-equal on
  its edge cases (an empty text row, audio shorter than the text, a
  remainder, a dead token mid-row).
- Activation checkpointing under each `remat_policy`: the loss and every
  gradient leaf equal (torch.equal) to the port without checkpointing, the
  attention and AdaLN forwards run as often as the card's launch table says,
  and both within test_torch_train.py's tolerances of `jax.value_and_grad`
  under the same policy (the DiT under all four, the UNetT and MMDiT under
  "nothing").
- `fuse_qkv=False` with bf16 optimizer state: one update against the JAX
  `make_train_step(fuse_qkv=False, hp=)` from `init_train_state(moment_dtype=
  bf16, ema_dtype=bf16)`; `Trainer(bf16_state=True)`'s dtypes and a resume
  that restores the state bit for bit.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import CFMConfig as JCFMConfig
from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.train import step as jstep
from f5tts_tpu.utils import make_time_grid as j_make_time_grid
from f5tts_tpu_torch.config import CFMConfig, ModelArch as TArch, TrainConfig
from f5tts_tpu_torch.convert import PARAMS_FROM_JAX, dit_params_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.train import step as tstep
from f5tts_tpu_torch.train.trainer import Trainer
from f5tts_tpu_torch.utils import make_time_grid
from tests.test_torch_dit import ATOL, SMALL, _live, _np, _t, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.test_torch_train import VOCAB, _tiny_dataset
from tests.test_torch_train_backbones import ARCHS, J_MODULES, _jax_draws

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FLAGS = {"long_skip": dict(long_skip_connection=True),
         "upsample": dict(text_embedding_average_upsampling=True),
         "both": dict(long_skip_connection=True, text_embedding_average_upsampling=True)}
POLICIES = ("nothing", "attn_out", "attn", "dots")


@functools.lru_cache(maxsize=None)
def flag_dit(flags: str, seed: int = 2):
    """(JAX arch, port arch, numpy JAX tree, port params with fused QKV)."""
    kw = dict(SMALL, **FLAGS[flags])
    jarch = JArch(**kw)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), seed)
    return jarch, TArch(**kw), tree, tm.fuse_backbone_qkv(dit_params_from_jax(tree))


def test_average_upsample_text_is_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    b, n, d = 5, 48, 8
    emb = rng.standard_normal((b, n, d)).astype(np.float32)
    mask = np.zeros((b, n), bool)
    mask[0, :20] = True           # audio (7 frames) shorter than the text
    mask[1, :7] = True            # 40 frames over 7 tokens: a remainder of 5
    # row 2: no live token at all, a padded row in the middle of the batch
    mask[3, :12] = True
    mask[3, 5] = False            # a dead token in the middle of the row
    mask[4, :] = True             # every token live, the audio to the end
    target = np.array([7, 40, 30, 33, n], np.int32)
    want = np.asarray(jax.jit(jdit.average_upsample_text)(jnp.asarray(emb), jnp.asarray(mask),
                                                          jnp.asarray(target)))
    got = _np(tdit.average_upsample_text(_t(emb), _t(mask), _t(target)))
    np.testing.assert_array_equal(got, want)
    assert not got[2].any() and not got[0, 7:].any() and got[1, 39].any()


@pytest.mark.parametrize("flags", ["long_skip", "upsample"])
def test_dit_forward_with_flags_matches_jax(flags):
    jarch, tarch, tree, tp = flag_dit(flags)
    assert ("long_skip" in tp) == tarch.long_skip_connection
    rng = np.random.default_rng(8)
    b, n = 2, 192
    x, cond = (rng.standard_normal((b, n, 100)).astype(np.float32) for _ in range(2))
    cond[:, 60:] = 0
    text = rng.integers(0, 32, (b, 64)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 151], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    fwd = jax.jit(functools.partial(jdit.dit_forward, statics=jdit.DiTStatics(jarch),
                                    cfg_infer=True, backend="xla"))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens)))
    got = _np(tdit.dit_forward(tp, tdit.DiTStatics(tarch), _t(x), _t(cond), _t(text), _t(time),
                               lengths=_t(lens), cfg_infer=True))
    lens2 = np.concatenate([lens, lens])
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=ATOL, rtol=1e-4)
    assert np.abs(_live(want, lens2)).max() > 0.1


def test_cfm_sample_with_both_flags_matches_jax():
    jarch, tarch, tree, tp = flag_dit("both", seed=5)
    rng = np.random.default_rng(11)
    b, n, nfe = 2, 256, 4
    lens, dur = np.array([60, 90], np.int32), np.array([256, 201], np.int32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 32, (b, 80)).astype(np.int32)
    text[1, 70:] = -1
    y0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    y0[1, 201:] = 0
    want = np.asarray(jcfm.cfm_sample(
        jx(tree), jdit.DiTStatics(jarch), jnp.asarray(cond), jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(dur), j_make_time_grid(nfe, sway_sampling_coef=-1.0),
        y0=jnp.asarray(y0), cfg_strength=2.0, dtype=jnp.float32, backend="xla"))
    got = _np(tcfm.cfm_sample(tp, tdit.DiTStatics(tarch), _t(cond), _t(text), _t(lens), _t(dur),
                              make_time_grid(nfe, sway_sampling_coef=-1.0), y0=_t(y0),
                              cfg_strength=2.0, dtype=torch.float32))
    np.testing.assert_allclose(_live(got, dur), _live(want, dur), atol=2e-3, rtol=1e-3)
    assert np.abs(_live(got, dur) - _live(y0, dur)).max() > 0.1


# -- activation checkpointing ------------------------------------------------

REMAT_ARCHS = {"DiT": dict(SMALL, conv_layers=0), **ARCHS}


@functools.lru_cache(maxsize=None)
def remat_model(backbone: str):
    """(JAX arch, port arch, numpy JAX tree, port params (unfused), batch)."""
    init = jdit.init_dit if backbone == "DiT" else J_MODULES[backbone]
    jarch = JArch(**REMAT_ARCHS[backbone])
    tree = np_params(lambda: init(jax.random.PRNGKey(0), jarch), 13)
    rng = np.random.default_rng(4)
    b, n = 2, 128
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    lens = np.array([n, 97], np.int32)
    mel[1, 97:] = 0.0
    text = rng.integers(0, 32, (b, 40)).astype(np.int32)
    text[1, 30:] = -1
    return jarch, TArch(**REMAT_ARCHS[backbone]), tree, PARAMS_FROM_JAX[backbone](tree), \
        (mel, text, lens)


@functools.lru_cache(maxsize=None)
def jax_remat_grads(backbone: str) -> dict:
    """{policy: (loss, port-layout grads)} of jax.value_and_grad under
    checkpoint_activations, one jit for every policy the test covers."""
    jarch, _, tree, _, (mel, text, lens) = remat_model(backbone)
    bdef = jcfm.BACKBONES[backbone]
    policies = POLICIES if backbone == "DiT" else ("nothing",)

    def jloss(p, policy):
        arch = dataclasses.replace(jarch, checkpoint_activations=True, remat_policy=policy)
        p = jm.fuse_backbone_qkv(p, dtype=jnp.float32)
        return jcfm.cfm_loss(p, bdef.statics_cls(arch), jax.random.PRNGKey(2), jnp.asarray(mel),
                             jnp.asarray(text), jnp.asarray(lens), cfg=JCFMConfig(),
                             dtype=jnp.float32, backend="xla", backbone=bdef)[0]

    outs = jax.jit(lambda p: [jax.value_and_grad(functools.partial(jloss, policy=pol))(p)
                              for pol in policies])(jx(tree))
    return {pol: (float(loss), PARAMS_FROM_JAX[backbone](jax.tree.map(np.asarray, grads)))
            for pol, (loss, grads) in zip(policies, outs)}


def _port_grads(backbone: str, **arch_kw):
    """(loss, grads, {forward: calls}) of one port grad step."""
    _, tarch, _, tp, (mel, text, lens) = remat_model(backbone)
    bdef = tcfm.BACKBONES[backbone]
    arch = dataclasses.replace(tarch, **arch_kw)
    step = tstep.make_train_step(bdef.statics_cls(arch), tstep.make_optimizer(1e-4, 10, 100),
                                 dtype=torch.float32, backbone=bdef)
    calls = collections.Counter()
    patches = [(tatt, "fused_qkv_rope_attention_fwd"), (tatt, "fused_qkv_rope_attention_bias_fwd"),
               (tm, "adaln_norm"), (tm, "rms_norm_kernel")]
    saved = [getattr(mod, name) for mod, name in patches]
    for (mod, name), real in zip(patches, saved):
        setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.update([_n]) or _r(*a, **k))
    try:
        loss, grads = step.grad_step(tp, *(torch.from_numpy(a) for a in (mel, text, lens)),
                                     draws=_jax_draws(jax.random.PRNGKey(2), *mel.shape))
    finally:
        for (mod, name), real in zip(patches, saved):
            setattr(mod, name, real)
    return loss, grads, dict(calls)


@pytest.mark.parametrize("backbone,policy", [("DiT", p) for p in POLICIES]
                         + [("UNetT", "nothing"), ("MMDiT", "nothing")])
def test_checkpointing_equals_the_plain_step_and_matches_jax(backbone, policy):
    loss0, grads0, calls0 = _port_grads(backbone)
    loss, grads, calls = _port_grads(backbone, checkpoint_activations=True, remat_policy=policy)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(tm.tree_leaves(grads), tm.tree_leaves(grads0)):
        assert torch.equal(g, g0)
    if backbone == "DiT":  # the card's launch table at depth 2: K3-lse and K1 an update
        replay = policy in ("nothing", "dots")
        assert calls0 == {"fused_qkv_rope_attention_fwd": 2, "adaln_norm": 5}
        assert calls == {"fused_qkv_rope_attention_fwd": 4 if replay else 2, "adaln_norm": 9}
    want_loss, want_grads = jax_remat_grads(backbone)[policy]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    want = tm.tree_leaves(want_grads)
    got = tm.tree_leaves(grads)
    assert len(got) == len(want)
    worst = max(float((g - w).norm() / w.norm()) for g, w in zip(got, want)
                if float(w.abs().max()) > 0)
    assert worst <= 1e-4, worst


def test_checkpointing_under_no_grad_is_the_plain_forward():
    jarch, tarch, tree, tp = flag_dit("both")
    rng = np.random.default_rng(1)
    x, cond = (_t(rng.standard_normal((1, 128, 100)).astype(np.float32)) for _ in range(2))
    text = _t(rng.integers(0, 32, (1, 30)).astype(np.int32))
    args = (x, cond, text, torch.tensor([0.4]))
    with torch.no_grad():
        want = tdit.dit_forward(tp, tdit.DiTStatics(tarch), *args)
        got = tdit.dit_forward(tp, tdit.DiTStatics(dataclasses.replace(
            tarch, checkpoint_activations=True, remat_policy="attn")), *args)
    assert torch.equal(got, want)


# -- fuse_qkv=False and bf16 state ------------------------------------------

def test_unfused_step_with_bf16_state_matches_jax():
    jarch, tarch, tree, tp, (mel, text, lens) = remat_model("DiT")
    hp = jstep.OptHParams(learning_rate=1e-3, warmup_updates=2, total_updates=10)
    tx = jstep.make_optimizer(1e-3, 2, 10)
    kw = dict(ema_decay=0.9, ema_update_every=1, ema_update_after_step=0)
    jfn = jax.jit(jstep.make_train_step(jdit.DiTStatics(jarch), tx, dtype=jnp.float32,
                                        backend="xla", fuse_qkv=False, hp=hp, **kw))
    jstate = jstep.init_train_state(jx(tree), tx, moment_dtype=jnp.bfloat16,
                                    ema_dtype=jnp.bfloat16)
    jstate, jm_ = jfn(jstate, jax.random.PRNGKey(2), jnp.asarray(mel), jnp.asarray(text),
                      jnp.asarray(lens))
    state = tstep.init_train_state(tp, moment_dtype=torch.bfloat16, ema_dtype=torch.bfloat16)
    step = tstep.make_train_step(tdit.DiTStatics(tarch), tstep.make_optimizer(1e-3, 2, 10),
                                 dtype=torch.float32, fuse_qkv=False, **kw)
    calls = []
    real = tatt.flash_attention_bwd_ref
    tatt.flash_attention_bwd_ref = lambda *a: calls.append(1) or real(*a)
    try:  # unfused projections: the head layout, K7's lse mode and K9's plain versions
        state, mt = step(state, *(torch.from_numpy(a) for a in (mel, text, lens)),
                         draws=_jax_draws(jax.random.PRNGKey(2), *mel.shape))
    finally:
        tatt.flash_attention_bwd_ref = real
    assert len(calls) == tarch.depth
    np.testing.assert_allclose(float(mt["loss"]), float(jm_["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-5)
    adam = jstate.opt_state[1][0]
    want = {"params": jstate.params, "mu": adam.mu, "nu": adam.nu, "ema": jstate.ema_params}
    for name, tree_j in want.items():
        got = tm.tree_leaves(getattr(state, name))
        ref = tm.tree_leaves(dit_params_from_jax(jax.tree.map(np.asarray, tree_j)))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            if name == "params":  # f32, as test_torch_train.py's updates
                assert a.dtype == torch.float32
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-8)
            else:  # bf16: the grads' f32 sum-order drift (rel-L2 1e-4), then one rounding
                assert a.dtype == torch.bfloat16
                assert float((a.float() - b).norm()) <= 4e-3 * float(b.norm()), name


def test_trainer_bf16_state_dtypes_and_resume(tmp_path):
    _, tarch, _, tp, _ = remat_model("DiT")
    data = _tiny_dataset()

    def trainer(save_dir):
        cfg = TrainConfig(batch_size_per_device=400, num_warmup_updates=2, save_dir=str(save_dir),
                          save_per_updates=1000, last_per_updates=1000, logger=None,
                          ema_update_every=1, ema_update_after_step=0)
        return Trainer(tp, tdit.DiTStatics(tarch), cfg, vocab_char_map=VOCAB, device="cpu",
                       dtype=torch.float32, bf16_state=True)

    first = trainer(tmp_path)
    first.train(data, max_updates=2)
    for name in ("mu", "nu", "ema"):
        assert {t.dtype for t in tm.tree_leaves(getattr(first.state, name))} == {torch.bfloat16}
    assert {t.dtype for t in tm.tree_leaves(first.state.params)} == {torch.float32}
    resumed = trainer(tmp_path)
    assert resumed.maybe_resume() == 2
    for name in ("params", "mu", "nu", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(resumed.state, name)),
                        tm.tree_leaves(getattr(first.state, name))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    resumed.train(data, max_updates=3)
    assert resumed.state.step == 3 and resumed.state.mu["proj_out"]["b"].dtype == torch.bfloat16
