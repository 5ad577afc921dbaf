"""UNetT (E2-TTS) and MMDiT training in the port against the JAX package, on the CPU.

Numpy-seeded weights on both sides (`tests.test_torch_dit.np_params`), f32;
the JAX side on its XLA path (`backend="xla"`), the port on its plain
versions. Small shapes: dim 128, heads 2 x 64; UNetT depth 4 (two blocks a
half, so the skips pair up in reverse), MMDiT depth 3 (two blocks and the
context_pre_only last block).
- `cfm_loss` and every gradient leaf against `jax.value_and_grad` of the JAX
  train step's loss (`fuse_backbone_qkv` per step, `backbone=`), the JAX
  draws passed in as `CFMDraws`: the UNetT on the flat gate (K3 / K4 plain)
  and on the head-layout gate (the port's FLAT_ATTN_MAX_N lowered: K7's lse
  mode / K9 plain), the MMDiT (K5 / K8 plain). Tolerances as the DiT's
  (tests/test_torch_train.py): loss rtol 1e-5, leaf rel-L2 <= 1e-4.
- `train_state_from_jax` for both trees, and one more update on each side
  from the converted state: rtol 1e-5 (the same f32 formula).
- a `Trainer` run of 3 updates for each backbone, resumed from its
  heartbeat after 2; torch-format checkpoints of both trees restore bit for
  bit; the reference-key safetensors export refuses them (DiT only, as in
  the JAX package).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import CFMConfig as JCFMConfig
from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.train import step as jstep
from f5tts_tpu_torch.config import CFMConfig, ModelArch as TArch, TrainConfig
from f5tts_tpu_torch.convert import PARAMS_FROM_JAX, train_state_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops import attention as tatt
from f5tts_tpu_torch.train import checkpoint as tckpt
from f5tts_tpu_torch.train import step as tstep
from f5tts_tpu_torch.train.trainer import Trainer
from tests.test_torch_dit import jx, np_params
from tests.test_torch_train import VOCAB, _tiny_dataset
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = {
    "UNetT": dict(dim=128, depth=4, heads=2, dim_head=64, ff_mult=2, text_dim=None,
                  conv_layers=0, text_num_embeds=32, text_mask_padding=False),
    "MMDiT": dict(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2, text_dim=None,
                  conv_layers=0, text_num_embeds=32, text_mask_padding=True),
}
J_MODULES = {"UNetT": junett.init_unett, "MMDiT": jmmdit.init_mmdit}
# raised drop probabilities: with this key the 4 rows drop the audio, both
# conds, nothing and both (per-sample dropout, [b] bool on both sides)
DROPS = dict(audio_drop_prob=0.5, cond_drop_prob=0.3)


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _model(backbone: str):
    """(JAX arch, port arch, numpy JAX params (unfused), port params (unfused))."""
    jarch = JArch(**ARCHS[backbone])
    tree = np_params(lambda: J_MODULES[backbone](jax.random.PRNGKey(0), jarch), 13)
    return jarch, TArch(**ARCHS[backbone]), tree, PARAMS_FROM_JAX[backbone](tree)


def _batch(b=4, n=200, nt=60):
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    lens = np.array([n, 150, 77, 120], np.int32)
    mel[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    text = rng.integers(0, 32, (b, nt)).astype(np.int32)
    text[2, 30:] = -1
    text[1, 45:] = -1
    return mel, text, lens


def _jax_draws(key, b, n, d):
    """The JAX cfm_loss's draws, recomputed from its key split (cfm.py:125-150)."""
    k_frac, k_start, k_x0, k_t, k_da, k_db = jax.random.split(key, 6)
    u = functools.partial(jax.random.uniform, shape=(b,))
    return tcfm.CFMDraws(*(torch.from_numpy(np.array(a)) for a in (
        u(k_frac, minval=0.7, maxval=1.0), u(k_start),
        jax.random.normal(k_x0, (b, n, d), jnp.float32), u(k_t), u(k_da), u(k_db))))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(backbone: str):
    jarch, _, tree, _ = _model(backbone)
    mel, text, lens = _batch()
    statics = (junett.UNetTStatics if backbone == "UNetT" else jmmdit.MMDiTStatics)(jarch)

    def jloss(p):
        p = jm.fuse_backbone_qkv(p, dtype=jnp.float32)
        return jcfm.cfm_loss(p, statics, jax.random.PRNGKey(2), jnp.asarray(mel),
                             jnp.asarray(text), jnp.asarray(lens), cfg=JCFMConfig(**DROPS),
                             dtype=jnp.float32, backend="xla",
                             backbone=jcfm.BACKBONES[backbone])[0]

    loss, grads = jax.jit(jax.value_and_grad(jloss))(jx(tree))
    return float(loss), PARAMS_FROM_JAX[backbone](jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("backbone,gate", [("UNetT", "flat"), ("UNetT", "heads"),
                                           ("MMDiT", "joint")])
def test_cfm_loss_and_grads_match_jax(backbone, gate, monkeypatch):
    _, tarch, _, tp = _model(backbone)
    calls = []
    for name in ("fused_qkv_rope_attention_bwd_from_lse_ref",
                 "fused_qkv_rope_attention_bias_bwd_from_lse_ref", "flash_attention_bwd_ref"):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    if gate == "heads":  # the 4096-row gate, lowered to reach it at 256 rows
        monkeypatch.setattr(tm, "FLAT_ATTN_MAX_N", 128)
    mel, text, lens = _batch()
    bdef = tcfm.BACKBONES[backbone]
    draws = _jax_draws(jax.random.PRNGKey(2), *mel.shape)
    assert ((draws.drop_audio < 0.5) | (draws.drop_both < 0.3)).tolist() == [True, True, False, True]
    assert (draws.drop_both < 0.3).tolist() == [False, True, False, True]
    step = tstep.make_train_step(bdef.statics_cls(tarch), tstep.make_optimizer(1e-4, 10, 100),
                                 CFMConfig(**DROPS), dtype=torch.float32, backbone=bdef)
    loss, grads = step.grad_step(tp, torch.from_numpy(mel), torch.from_numpy(text),
                                 torch.from_numpy(lens), draws=draws)
    # the backward each gate runs, once an attention layer
    expect = {"flat": "fused_qkv_rope_attention_bwd_from_lse_ref",
              "heads": "flash_attention_bwd_ref",
              "joint": "fused_qkv_rope_attention_bias_bwd_from_lse_ref"}[gate]
    assert calls == [expect] * tarch.depth
    want_loss, want_grads = _jax_loss_and_grads(backbone)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    want, got = tm.tree_leaves(want_grads), tm.tree_leaves(grads)
    assert len(got) == len(want)
    rels = [_rel(_np(g), _np(w)) for g, w in zip(got, want) if float(w.abs().max()) > 0]
    assert len(rels) > 0.9 * len(want) and max(rels) <= 1e-4, max(rels)


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
def test_train_state_from_jax_and_one_more_update(backbone):
    """A JAX state one optax update in converts leaf for leaf; then both
    sides take the same update from it."""
    _, _, tree, _ = _model(backbone)
    tx = jstep.make_optimizer(1e-3, 3, 10)
    kw = dict(ema_decay=0.9, ema_update_every=1, ema_update_after_step=0)
    apply = jax.jit(jstep.make_train_step(None, tx, **kw).apply_step)
    rng = np.random.default_rng(6)
    grads = [jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), tree)
             for _ in range(2)]
    state, _ = apply(jstep.init_train_state(jx(tree), tx), jnp.float32(0), jx(grads[0]))
    port = train_state_from_jax(jax.tree.map(np.asarray, state), backbone=backbone)
    convert = PARAMS_FROM_JAX[backbone]
    assert (port.step, port.count) == (1, 1)
    for a, b in zip(tm.tree_leaves(port.mu), tm.tree_leaves(convert(
            jax.tree.map(np.asarray, state.opt_state[1][0].mu)))):
        assert torch.equal(a, b)
    state, _ = apply(state, jnp.float32(0), jx(grads[1]))
    port, _ = tstep.make_train_step(None, tstep.make_optimizer(1e-3, 3, 10), **kw).apply_step(
        port, torch.tensor(0.0), convert(grads[1]))
    want = train_state_from_jax(jax.tree.map(np.asarray, state), backbone=backbone)
    assert (want.step, want.count) == (port.step, port.count) == (2, 2)
    for name in ("params", "mu", "nu", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(port, name)), tm.tree_leaves(getattr(want, name))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-8, err_msg=name)


def _trainer(backbone, save_dir):
    _, tarch, _, tp = _model(backbone)
    bdef = tcfm.BACKBONES[backbone]
    cfg = TrainConfig(batch_size_per_device=400, num_warmup_updates=2, save_dir=str(save_dir),
                      save_per_updates=1000, last_per_updates=1000, logger=None,
                      ema_update_every=2, ema_update_after_step=1)
    return Trainer(tp, bdef.statics_cls(tarch), cfg, backbone=bdef, vocab_char_map=VOCAB,
                   tokenizer="char", device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
def test_trainer_three_updates_resume_and_checkpoints(backbone, tmp_path):
    data = _tiny_dataset()
    straight = _trainer(backbone, tmp_path / "a")
    seen = []
    straight.train(data, max_updates=3, log_every=1,
                   on_update=lambda u, m: seen.append((u, float(m["loss"]), float(m["grad_norm"]))))
    assert [u for u, _, _ in seen] == [1, 2, 3]
    assert all(np.isfinite(x) for _, loss, gn in seen for x in (loss, gn))
    first = _trainer(backbone, tmp_path / "b")
    first.train(data, max_updates=2)
    resumed = _trainer(backbone, tmp_path / "b")
    resumed.train(data, max_updates=3)
    assert resumed.state.step == 3
    for name in ("params", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(resumed.state, name)),
                        tm.tree_leaves(getattr(straight.state, name))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)
    # the heartbeat holds the whole tree, bit for bit
    back = tckpt.CheckpointManager(str(tmp_path / "a")).restore()
    assert back.step == 3 and tm.tree_map(lambda a: a.shape, back.params) == \
        tm.tree_map(lambda a: a.shape, straight.state.params)
    for name in ("params", "mu", "nu", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(back, name)),
                        tm.tree_leaves(getattr(straight.state, name))):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="DiT only"):
        tckpt.save_safetensors_ema(back.ema, str(tmp_path / "x.safetensors"))
