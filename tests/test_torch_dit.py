"""Port DiT (f5tts_tpu_torch.models) against the JAX DiT on the CPU.

Same numpy-seeded weights on both sides (drawn from numpy in the JAX init's
tree layout, the zero-initialised AdaLN / norm_out / proj_out / GRN leaves
random too, so the DiT is no identity), converted into the port by
`convert.dit_params_from_jax` and QKV-fused as the pipeline fuses them. The JAX side runs its XLA path in f32
(`backend="xla"`); the port runs its plain versions (CPU tensors) in f32.
Small shapes: dim 128, depth 2, heads 2 x 64, text_dim 64, conv_layers 1.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.ops.rope import rope_flat_tables as j_rope_flat_tables
from f5tts_tpu_torch.config import ModelArch as TArch
from f5tts_tpu_torch.convert import dit_params_from_jax
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops.rope import rope_flat_tables

SMALL = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64,
             conv_layers=1, text_num_embeds=32)
# f32 on both sides; outputs are O(1): the differences are sum orders
ATOL = 2e-4


STACKS = ("blocks", "first_half", "second_half")  # depth-stacked block dicts


def np_params(init_fn, seed: int):
    """Numpy-seeded weights in the tree layout `init_fn()` builds (traced
    for its shapes only). Matrices N(0, 1/fan_in), embeddings N(0, 1), norm
    weights 1, RMSNorm weights 1 + 0.1 * N(0, 1), every other vector
    0.05 * N(0, 1): the AdaLN / norm_out / proj_out / GRN leaves that init
    to zero are random too, so the backbone is no identity. Stacked blocks
    (a STACKS key followed by a dict key, not a list index) draw per block."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        stacked = any(k in STACKS and not isinstance(nxt, int) for k, nxt in zip(keys, keys[1:]))
        core = leaf.shape[1:] if stacked else leaf.shape
        if keys[-1] in ("norm_w", "in_norm_w", "final_norm_w"):
            return np.ones(leaf.shape, np.float32)
        if keys[-1] == "w" and len(core) == 1:  # RMSNorm weight
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if keys[-1] == "gamma" and "grn" not in keys:  # Vocos layer scale
            return (0.125 + 0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if len(core) >= 2:
            std = 1.0 if "embed" in keys[-2:] else 1.0 / np.sqrt(np.prod(core[:-1]))
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init_fn))


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread while a module runs: its shapes are small, and the
    suite runs six workers on one machine, where more threads only spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def small_dit(seed: int = 0):
    """(JAX arch, port arch, numpy JAX params, port params with fused QKV)."""
    jarch = JArch(**SMALL)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(seed), jarch), seed)
    return jarch, TArch(**SMALL), tree, tm.fuse_backbone_qkv(dit_params_from_jax(tree))


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _live(a, lengths):
    return np.concatenate([a[i, :l] for i, l in enumerate(lengths)], axis=0)


@pytest.fixture(scope="module")
def model():
    return small_dit()


def test_converter_unstacks_and_keeps_layouts(model):
    jarch, _, tree, _ = model
    tp = dit_params_from_jax(tree)
    assert len(tp["blocks"]) == jarch.depth
    for i in range(jarch.depth):
        for mod, name in (("attn", "to_q"), ("attn", "to_out"), ("ff", "in")):
            np.testing.assert_array_equal(_np(tp["blocks"][i][mod][name]["w"]),
                                          tree["blocks"][mod][name]["w"][i])
    # Linear (in, out); Conv1d (k, in/groups, out)
    assert tuple(tp["blocks"][0]["attn"]["to_q"]["w"].shape) == (128, 128)
    assert tuple(tp["input_embed"]["proj"]["w"].shape) == (100 * 2 + 64, 128)
    assert tuple(tp["input_embed"]["conv_pos"]["conv1"]["w"].shape) == (31, 128 // 16, 128)
    assert tuple(tp["text_embed"]["blocks"][0]["dwconv"]["w"].shape) == (7, 1, 64)
    # fused and unfused QKV trees convert to the same fused port params
    fused_j = dit_params_from_jax(jax.tree.map(np.asarray, jm.fuse_backbone_qkv(tree)))
    fused_t = tm.fuse_backbone_qkv(tp)
    for i in range(jarch.depth):
        for k in ("w", "b"):
            np.testing.assert_array_equal(_np(fused_j["blocks"][i]["attn"]["to_qkv"][k]),
                                          _np(fused_t["blocks"][i]["attn"]["to_qkv"][k]))
    assert "to_q" not in fused_t["blocks"][0]["attn"]
    # unfused params take the head layout (RoPE from the angles, K7's plain
    # version) and agree with the fused flat path: f32 sum orders only
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 128)).astype(np.float32))
    lens = torch.tensor([50], dtype=torch.int32)
    statics = tdit.DiTStatics(jarch)
    tabs = rope_flat_tables(statics.rope_angles, 64, 2, dtype=torch.float32)
    unfused = tm.self_attention(tp["blocks"][0]["attn"], x, 2, tabs, lens, statics.rope_angles)
    fused = tm.self_attention(fused_t["blocks"][0]["attn"], x, 2, tabs, lens)
    np.testing.assert_allclose(_np(unfused), _np(fused), atol=1e-5)


def test_modules_match_jax(model):
    _, _, tree, tp = model
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 1, (3,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tm.timestep_embedding(tp["time_embed"], _t(t))),
        np.asarray(jm.timestep_embedding(jx(tree["time_embed"]), jnp.asarray(t))), atol=ATOL)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    blk_j, blk_t = jx(tree["text_embed"]["blocks"][0]), tp["text_embed"]["blocks"][0]
    x2 = rng.standard_normal((2, 40, 128)).astype(np.float32)
    np.testing.assert_allclose(_np(tm.grn(blk_t["grn"], _t(x2))),
                               np.asarray(jm.grn(blk_j["grn"], jnp.asarray(x2))), atol=ATOL)
    np.testing.assert_allclose(
        _np(tm.depthwise_conv1d(blk_t["dwconv"], _t(x), padding=3)),
        np.asarray(jm.depthwise_conv1d(blk_j["dwconv"], jnp.asarray(x), padding=3)), atol=ATOL)
    np.testing.assert_allclose(_np(tm.convnext_v2_block(blk_t, _t(x))),
                               np.asarray(jm.convnext_v2_block(blk_j, jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(
        _np(tm.layer_norm(_t(x), blk_t["norm_w"], blk_t["norm_b"])),
        np.asarray(jm.layer_norm(jnp.asarray(x), blk_j["norm_w"], blk_j["norm_b"])), atol=ATOL)
    h = rng.standard_normal((2, 40, 128)).astype(np.float32)
    ff_j = jax.tree.map(lambda a: a[0], jx(tree["blocks"]["ff"]))
    np.testing.assert_allclose(_np(tm.feed_forward(tp["blocks"][0]["ff"], _t(h))),
                               np.asarray(jm.feed_forward(ff_j, jnp.asarray(h))), atol=ATOL)


@pytest.mark.parametrize("jax_fused", [False, True])
def test_dit_block_matches_jax(model, jax_fused):
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(6)
    n = 128
    h = rng.standard_normal((2, n, 128)).astype(np.float32)
    lens = np.array([n, 77], np.int32)
    emb = rng.standard_normal((2, 128)).astype(np.float32)
    blk_j = jax.tree.map(lambda a: a[1], jx(tree["blocks"]))
    blk_t = tp["blocks"][1]
    if jax_fused:  # the JAX package's other attention path (flat tables, fused QKV)
        blk_j = dict(blk_j, attn=jm.fuse_attention_qkv(blk_j["attn"]))
    statics = jdit.DiTStatics(jarch)
    block = jax.jit(functools.partial(jm.dit_block, heads=2, backend="xla"))
    want = np.asarray(block(blk_j, jnp.asarray(h), jnp.asarray(emb),
                            rope_angles=statics.rope_angles[:n], lengths=jnp.asarray(lens)))
    mods = tm.linear(blk_t["attn_norm"]["linear"], torch.nn.functional.silu(_t(emb)))
    tabs = rope_flat_tables(tdit.DiTStatics(tarch).rope_angles, n, 2, dtype=torch.float32)
    got = _np(tm.dit_block(blk_t, _t(h), mods, 2, tabs, _t(lens)))
    np.testing.assert_allclose(_live(got, lens), _live(want, lens), atol=ATOL, rtol=1e-4)
    # the flat cos/sin tables are the JAX package's
    cj, _ = j_rope_flat_tables(statics.rope_angles, n, 2, dtype=jnp.float32)
    np.testing.assert_allclose(_np(tabs[0]), np.asarray(cj), atol=1e-6)


@pytest.mark.parametrize("drop_text", [False, True])
def test_text_embedding_matches_jax(model, drop_text):
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(7)
    text = rng.integers(0, 32, (2, 90)).astype(np.int32)
    text[1, 60:] = -1
    lens = np.array([160, 100], np.int32)
    emb = jax.jit(functools.partial(jdit.text_embedding, statics=jdit.DiTStatics(jarch),
                                    seq_len=160, drop_text=drop_text))
    want = np.asarray(emb(jx(tree["text_embed"]), text=jnp.asarray(text),
                          lengths=jnp.asarray(lens)))
    got = _np(tdit.text_embedding(tp["text_embed"], tdit.DiTStatics(tarch), _t(text), 160,
                                  lengths=_t(lens), drop_text=drop_text))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_precompute_t_mods_matches_jax(model):
    _, _, tree, tp = model
    t = np.array([0.0, 0.1, 0.55, 0.9], np.float32)
    bj, fj = jdit.precompute_t_mods(jx(tree), jnp.asarray(t), 2, dtype=jnp.float32)
    bt, ft = tdit.precompute_t_mods(tp, _t(t), 2, dtype=torch.float32)
    assert tuple(bt.shape) == tuple(bj.shape) and tuple(ft.shape) == tuple(fj.shape)
    np.testing.assert_allclose(_np(bt), np.asarray(bj), atol=ATOL)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=ATOL)


@pytest.mark.parametrize("hoisted,cfg_infer", [(False, True), (True, True), (False, False)])
def test_dit_forward_matches_jax(model, hoisted, cfg_infer):
    jarch, tarch, tree, tp = model
    rng = np.random.default_rng(8)
    b, n = 2, 256
    x = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond = rng.standard_normal((b, n, 100)).astype(np.float32)
    cond[:, 80:] = 0
    text = rng.integers(0, 32, (b, 64)).astype(np.int32)
    text[0, 50:] = -1
    lens = np.array([n, 201], np.int32)
    time = np.array([0.3, 0.7], np.float32)
    kw_j, kw_t = {}, {}
    if hoisted:
        bj, fj = jdit.precompute_t_mods(jx(tree), jnp.asarray(time[:1]), 2 * b, dtype=jnp.float32)
        kw_j["t_mods"] = (bj[:, 0], fj[0])
        bt, ft = tdit.precompute_t_mods(tp, _t(time[:1]), 2 * b, dtype=torch.float32)
        kw_t["t_mods"] = (bt[:, 0], ft[0])
        time = np.full((b,), time[0], np.float32)
    # without CFG packing: drop the audio cond and the text, as a training
    # step's dropout does
    drop = {} if cfg_infer else {"drop_audio_cond": True, "drop_text": True}
    fwd = jax.jit(functools.partial(jdit.dit_forward, statics=jdit.DiTStatics(jarch),
                                    cfg_infer=cfg_infer, backend="xla", **drop))
    want = np.asarray(fwd(jx(tree), x=jnp.asarray(x), cond=jnp.asarray(cond),
                          text=jnp.asarray(text), time=jnp.asarray(time),
                          lengths=jnp.asarray(lens), **kw_j))
    got = _np(tdit.dit_forward(tp, tdit.DiTStatics(tarch), _t(x), _t(cond), _t(text), _t(time),
                               lengths=_t(lens), cfg_infer=cfg_infer, **drop, **kw_t))
    assert got.shape == want.shape == ((2 if cfg_infer else 1) * b, n, 100)
    lens2 = np.concatenate([lens, lens]) if cfg_infer else lens
    np.testing.assert_allclose(_live(got, lens2), _live(want, lens2), atol=ATOL, rtol=1e-4)
    assert np.abs(_live(want, lens2)).max() > 0.1  # the DiT is not an identity here


def test_init_dit_shapes_match_jax():
    jarch = JArch(**dict(SMALL, depth=3))
    jt = jax.eval_shape(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch))
    tp = tdit.init_dit(torch.Generator().manual_seed(0), TArch(**dict(SMALL, depth=3)))
    conv = dit_params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jt))
    shapes = tm.tree_map(lambda a: tuple(a.shape), tp)
    assert shapes == tm.tree_map(lambda a: tuple(a.shape), conv)
    # AdaLN-zero: zero modulation, norm_out and proj_out until randomised
    assert not tp["blocks"][0]["attn_norm"]["linear"]["w"].any()
    act = tdit.activate_zero_init(tp, torch.Generator().manual_seed(1))
    assert act["proj_out"]["w"].any() and act["blocks"][2]["attn_norm"]["linear"]["b"].any()
    assert dataclasses.asdict(TArch()) == {k: v for k, v in dataclasses.asdict(JArch()).items()
                                           if k in dataclasses.asdict(TArch())}
