"""Port style-LoRA (f5tts_tpu_torch.train.lora) against the JAX package, on the CPU.

Small DiT (tests/test_torch_dit.py:SMALL, depth 2), numpy-seeded base
weights and adapters on both sides, f32. Tolerances:
- merged weights (w + (alpha/r) A@B): rtol 1e-6; fused serving leaves the
  same; int8 codes equal (at most 1 code in 10^4 a step off, where the
  merged f32 weight rounds differently), scales rtol 1e-6;
- the LoRA loss: 1e-5 relative; each adapter gradient rel-L2 <= 1e-4
  (through the JAX draws);
- 3 clip + AdamW updates on the same gradients against optax's chain:
  rtol 1e-5, atol 1e-8; pickles: bit for bit.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import unett as junett
from f5tts_tpu.train import lora as jlora
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import dit_params_from_jax, unett_params_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.train import lora as tlora
from tests.test_torch_dit import SMALL, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RANK = 4
CFG_J = jlora.LoRAConfig(rank=RANK, alpha=8.0)
CFG_T = tlora.LoRAConfig(rank=RANK, alpha=8.0)


@pytest.fixture(scope="module")
def model():
    jarch = JArch(**SMALL)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 21)
    return jarch, TArch(**SMALL), tree, dit_params_from_jax(tree)


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_lora(tree, seed=3, b_scale=0.05):
    """Adapters in the JAX layout for `tree`: a ~ N(0, 1/r), b random (a
    zero b would pass no gradient to a)."""
    rng = np.random.default_rng(seed)
    out = {}
    for group in ("attn", "ff"):
        for name, sub in tree["blocks"][group].items():
            if name in jlora.DEFAULT_TARGETS and isinstance(sub, dict) and "w" in sub:
                depth, d_in, d_out = np.asarray(sub["w"]).shape
                out.setdefault(group, {})[name] = {
                    "a": (rng.standard_normal((depth, d_in, RANK)) / np.sqrt(RANK)).astype(
                        np.float32),
                    "b": (rng.standard_normal((depth, RANK, d_out)) * b_scale).astype(np.float32)}
    return out


def _t_lora(np_lora):
    return tm.tree_map(lambda a: torch.from_numpy(np.array(a)), np_lora)


def test_init_lora_shapes_zero_delta_and_base_identity(model):
    _, _, tree, tp = model
    lora = tlora.init_lora(torch.Generator().manual_seed(1), tp, CFG_T)
    jl = jlora.init_lora(jax.random.PRNGKey(1), jx(tree), CFG_J)
    assert set(lora) == set(jl) == {"attn", "ff"}
    for group in lora:
        assert set(lora[group]) == set(jl[group])
        for name, ab in lora[group].items():
            for k in ("a", "b"):
                assert tuple(ab[k].shape) == jl[group][name][k].shape
                assert ab[k].dtype == torch.float32
            assert not ab["b"].any()
            # a ~ N(0, 1/r): its std near 1/sqrt(r)
            assert abs(float(ab["a"].std()) - RANK ** -0.5) < 0.1
    assert tuple(lora["attn"]["to_q"]["a"].shape) == (2, 128, RANK)
    assert tuple(lora["ff"]["in"]["b"].shape) == (2, RANK, 256)
    assert tlora.count_lora_params(lora) == sum(a.size for a in jax.tree.leaves(jl))
    merged = tlora.apply_lora(tp, lora, CFG_T)
    for blk, base in zip(merged["blocks"], tp["blocks"]):
        for group in ("attn", "ff"):
            for name in lora[group]:
                assert torch.equal(blk[group][name]["w"], base[group][name]["w"])
    assert merged["proj_out"] is tp["proj_out"]  # untouched leaves shared
    assert merged["blocks"][0]["attn_norm"] is tp["blocks"][0]["attn_norm"]


def test_apply_and_merge_for_serving_match_jax(model):
    _, _, tree, tp = model
    nl = _np_lora(tree)
    want = jax.tree.map(np.asarray, jlora.apply_lora(jx(tree), jx(nl), CFG_J))
    got = tlora.apply_lora(tp, _t_lora(nl), CFG_T)
    for group, subs in nl.items():
        for name in subs:
            for i, blk in enumerate(got["blocks"]):
                np.testing.assert_allclose(_np(blk[group][name]["w"]),
                                           want["blocks"][group][name]["w"][i], rtol=1e-6,
                                           atol=1e-7)
                np.testing.assert_array_equal(_np(blk[group][name]["b"]),
                                              want["blocks"][group][name]["b"][i])
    # serving: the fused f32 tree, then int8
    jserve = jax.tree.map(np.asarray, jlora.merge_for_serving(jx(tree), jx(nl), CFG_J))
    tserve = tlora.merge_for_serving(tp, _t_lora(nl), CFG_T)
    for i, blk in enumerate(tserve["blocks"]):
        assert "to_q" not in blk["attn"] and "to_qkv" in blk["attn"]
        for group, name in (("attn", "to_qkv"), ("attn", "to_out"), ("ff", "in"), ("ff", "out")):
            for k in ("w", "b"):
                np.testing.assert_allclose(_np(blk[group][name][k]),
                                           jserve["blocks"][group][name][k][i], rtol=1e-6,
                                           atol=1e-7)
    jq = jax.tree.map(np.asarray, jlora.merge_for_serving(jx(tree), jx(nl), CFG_J, "int8"))
    tq = tlora.merge_for_serving(tp, _t_lora(nl), CFG_T, quantization="int8")
    seen = 0
    for i, blk in enumerate(tq["blocks"]):
        for group, name in (("attn", "to_qkv"), ("attn", "to_out"), ("ff", "in"), ("ff", "out")):
            leaf, jleaf = blk[group][name], {k: v[i] for k, v in jq["blocks"][group][name].items()}
            assert set(leaf) == set(jleaf) == {"w_i8", "w_scale", "b"}
            codes, want_codes = _np(leaf["w_i8"].t()).astype(int), jleaf["w_i8"].astype(int)
            off = np.abs(codes - want_codes)
            assert off.max() <= 1 and (off > 0).mean() <= 1e-4
            np.testing.assert_allclose(_np(leaf["w_scale"]), jleaf["w_scale"], rtol=1e-6)
            seen += 1
    assert seen == 8
    with pytest.raises(ValueError, match="unknown quantization"):
        tlora.merge_for_serving(tp, _t_lora(nl), CFG_T, quantization="fp8")


def _batch(seed=4, b=3, n=96, d=100):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, d)).astype(np.float32)
    lens = np.array([n, 70, 81], np.int32)
    mel[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    text = rng.integers(0, 32, (b, 40)).astype(np.int32)
    text[1, 25:] = -1
    return mel, text, lens


def _jax_draws(key, b, n, d):
    """The draws the JAX cfm_loss takes from `key` (cfm.py:125-150)."""
    k_frac, k_start, k_x0, k_t, k_da, k_db = jax.random.split(key, 6)
    u = functools.partial(jax.random.uniform, shape=(b,))
    return tcfm.CFMDraws(*(torch.from_numpy(np.array(a)) for a in (
        u(k_frac, minval=0.7, maxval=1.0), u(k_start),
        jax.random.normal(k_x0, (b, n, d), jnp.float32), u(k_t), u(k_da), u(k_db))))


def test_lora_loss_and_adapter_grads_match_jax(model):
    jarch, tarch, tree, tp = model
    nl = _np_lora(tree)
    mel, text, lens = _batch()
    key = jax.random.PRNGKey(7)
    jstatics = jdit.DiTStatics(jarch)

    def jloss(lora):
        merged = jlora.apply_lora(jx(tree), lora, CFG_J)
        return jcfm.cfm_loss(merged, jstatics, key, jnp.asarray(mel), jnp.asarray(text),
                             jnp.asarray(lens), dtype=jnp.float32, backend="xla")[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jx(nl))
    step = tlora.make_lora_train_step(tp, tdit.DiTStatics(tarch), tlora.AdamWHParams(1e-3),
                                      CFG_T, dtype=torch.float32)
    loss, grads = step.loss_and_grads(_t_lora(nl), torch.from_numpy(mel), torch.from_numpy(text),
                                      torch.from_numpy(lens), draws=_jax_draws(key, 3, 96, 100))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    flat_t = {(g, n, k): v for g, s in grads.items() for n, ab in s.items() for k, v in ab.items()}
    flat_j = {(g, n, k): np.asarray(v) for g, s in want_grads.items() for n, ab in s.items()
              for k, v in ab.items()}
    assert set(flat_t) == set(flat_j) and len(flat_t) == 12
    worst = max(_rel(_np(flat_t[k]), flat_j[k]) for k in flat_t)
    assert worst <= 1e-4, worst
    assert all(float(np.abs(v).max()) > 0 for v in flat_j.values())


def test_three_updates_match_optax_chain_and_base_untouched(model):
    """The same gradients into the port's clip + AdamW and optax's
    chain(clip_by_global_norm(1), adamw(lr)) at its defaults (weight decay
    1e-4): clipped at updates 1 and 3 only."""
    jarch, tarch, tree, tp = model
    nl = _np_lora(tree, seed=5)
    rng = np.random.default_rng(6)

    def grads(scale):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), nl)
        norm = np.sqrt(sum(float(np.sum(x * x)) for x in jax.tree.leaves(g)))
        return jax.tree.map(lambda a: (a * (scale / norm)).astype(np.float32), g)

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3))
    jparams, jstate = jx(nl), tx.init(jx(nl))
    base_before = [t.clone() for t in tm.tree_leaves(tp)]
    step = tlora.make_lora_train_step(tp, tdit.DiTStatics(tarch), tlora.AdamWHParams(3e-3),
                                      CFG_T, dtype=torch.float32)
    lora = _t_lora(nl)
    opt = tlora.init_lora_opt_state(lora)
    for scale in (3.0, 0.4, 2.0):
        g = grads(scale)
        updates, jstate = tx.update(jx(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gnorm = step.apply(lora, opt, _t_lora(g))
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(jx(g))), rtol=1e-6)
    assert opt.count == 3
    want = jax.tree.map(np.asarray, jparams)
    for group, subs in want.items():
        for name, ab in subs.items():
            for k in ("a", "b"):
                np.testing.assert_allclose(_np(lora[group][name][k]), ab[k], rtol=1e-5, atol=1e-8)
    mu_want = jax.tree.map(np.asarray, jstate[1][0].mu)
    np.testing.assert_allclose(_np(opt.mu["ff"]["out"]["b"]), mu_want["ff"]["out"]["b"],
                               rtol=1e-5, atol=1e-9)
    # a full step through the loss: only the adapters move, the base stays
    mel, text, lens = _batch()
    lora2, opt2, metrics = step(lora, opt, torch.from_numpy(mel), torch.from_numpy(text),
                                torch.from_numpy(lens), generator=torch.Generator().manual_seed(0))
    assert lora2 is lora and opt2.count == 4 and np.isfinite(float(metrics["loss"]))
    for t, t0 in zip(tm.tree_leaves(step.base), base_before):
        assert torch.equal(t, t0) and not t.requires_grad
    assert all(torch.equal(t, t0) for t, t0 in zip(tm.tree_leaves(tp), base_before))


def test_pickles_cross_between_packages(model, tmp_path):
    _, _, tree, tp = model
    nl = _np_lora(tree, seed=8)
    port = _t_lora(nl)
    tlora.save_lora(port, str(tmp_path / "port.pkl"))
    from_port = jlora.load_lora(str(tmp_path / "port.pkl"))
    assert jax.tree.structure(from_port) == jax.tree.structure(nl)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(nl)):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # a JAX pickle (finetune_cli.py:166-171: device_get of the adapter tree)
    with open(tmp_path / "jax.pkl", "wb") as f:
        pickle.dump(jax.tree.map(jax.device_get, jx(nl)), f)
    back = tlora.load_lora(str(tmp_path / "jax.pkl"), device="cpu")
    for a, b in zip(tm.tree_leaves(back), tm.tree_leaves(port)):
        assert torch.equal(a, b)
    # the merges agree across the crossing
    want = jax.tree.map(np.asarray, jlora.merge_lora(jx(tree), from_port, CFG_J))
    got = tlora.merge_lora(tp, back, CFG_T)
    for i, blk in enumerate(got["blocks"]):
        np.testing.assert_allclose(_np(blk["attn"]["to_v"]["w"]),
                                   want["blocks"]["attn"]["to_v"]["w"][i], rtol=1e-6, atol=1e-7)



def test_load_lora_defaults_to_the_card(tmp_path, monkeypatch):
    tlora.save_lora({"attn": {"to_q": {"a": torch.ones(1, 2, 1), "b": torch.zeros(1, 1, 2)}}},
                    str(tmp_path / "a.pkl"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlora.load_lora(str(tmp_path / "a.pkl"))


def test_unett_raises():
    arch = dict(SMALL, text_dim=None, conv_layers=0)
    jtree = np_params(lambda: junett.init_unett(jax.random.PRNGKey(0), JArch(**arch)), 1)
    tp = unett_params_from_jax(jtree)
    with pytest.raises(ValueError, match="first_half / second_half"):
        tlora.init_lora(torch.Generator(), tp)
    with pytest.raises(ValueError, match="first_half / second_half"):
        tlora.apply_lora(tp, {})
    with pytest.raises(KeyError):  # the JAX module reads params["blocks"]
        jlora.init_lora(jax.random.PRNGKey(0), jx(jtree))
