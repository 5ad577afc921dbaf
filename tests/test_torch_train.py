"""Port training (f5tts_tpu_torch.train, cfm_loss) against the JAX package, on the CPU.

Small DiT (dim 128, depth 2, 2 x 64 heads), numpy-seeded weights on both
sides (tests/test_torch_dit.py:np_params), f32. Tolerances:
- cfm_loss: 1e-5 relative; each gradient leaf: rel-L2 <= 1e-4 (f32 on both
  sides, the differences are sum orders through two blocks and a backward);
- three optimizer + EMA updates: rtol 1e-5, atol 1e-8 on params, moments
  and EMA (the same f32 formula; XLA and torch round a few products
  differently);
- sampler, collate, span masks, safetensors bytes: exact.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import CFMConfig as JCFMConfig
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.train import checkpoint as jckpt
from f5tts_tpu.train import dataset as jds
from f5tts_tpu.train import step as jstep
from f5tts_tpu.utils import mask_from_frac_lengths as j_mask_from_frac_lengths
from f5tts_tpu_torch import utils as tutils
from f5tts_tpu_torch.config import CFMConfig, TrainConfig
from f5tts_tpu_torch.convert import dit_params_from_jax, train_state_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.train import checkpoint as tckpt
from f5tts_tpu_torch.train import dataset as tds
from f5tts_tpu_torch.train import step as tstep
from f5tts_tpu_torch.train.trainer import Trainer
from tests.test_torch_dit import SMALL, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,'!?")}  # 32 ids


@pytest.fixture(scope="module")
def model():
    """(JAX arch, port arch, numpy JAX params (unfused), port params (unfused))."""
    from f5tts_tpu.config import ModelArch as JArch
    from f5tts_tpu_torch.config import ModelArch as TArch

    jarch = JArch(**SMALL)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 11)
    return jarch, TArch(**SMALL), tree, dit_params_from_jax(tree)


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_span_masks_match_jax():
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 300, 64).astype(np.int32)
    frac = rng.uniform(0.7, 1.0, 64).astype(np.float32)
    start = rng.uniform(0, 1, 64).astype(np.float32)
    want = np.asarray(j_mask_from_frac_lengths(jnp.asarray(lens), jnp.asarray(frac),
                                               jnp.asarray(start), 320))
    got = tutils.mask_from_frac_lengths(torch.from_numpy(lens), torch.from_numpy(frac),
                                        torch.from_numpy(start), 320)
    np.testing.assert_array_equal(_np(got), want)


def test_configs_match_jax():
    from f5tts_tpu.config import TrainConfig as JTrainConfig

    assert dataclasses.asdict(CFMConfig()) == dataclasses.asdict(JCFMConfig())
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


def test_hoist_t_mods_matches_jax(model):
    _, _, tree, tp = model
    emb = np.random.default_rng(1).standard_normal((3, 128)).astype(np.float32)
    bj, fj = jdit.hoist_t_mods(jx(tree), jnp.asarray(emb))
    bt, ft = tdit.hoist_t_mods(tp, torch.from_numpy(emb))
    np.testing.assert_allclose(_np(bt), np.asarray(bj), atol=2e-5)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=2e-5)


def test_cfm_loss_and_grads_match_jax(model):
    jarch, tarch, tree, tp = model
    b, n, d = 4, 128, 100
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((b, n, d)).astype(np.float32)
    lens = np.array([n, 100, 77, 120], np.int32)
    mel[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    text = rng.integers(0, 32, (b, 50)).astype(np.int32)
    text[2, 30:] = -1
    # drop probabilities raised so this key drops the audio of some rows and
    # both conds of others (per-sample dropout, [b] bool on both sides)
    jcfg = JCFMConfig(audio_drop_prob=0.5, cond_drop_prob=0.3)
    key = jax.random.PRNGKey(2)  # rows: audio dropped, both, none, both

    # the JAX draws, recomputed from its key split (cfm.py:125-150)
    k_frac, k_start, k_x0, k_t, k_da, k_db = jax.random.split(key, 6)
    u = functools.partial(jax.random.uniform, shape=(b,))
    draws = tcfm.CFMDraws(*(torch.from_numpy(np.array(a)) for a in (
        u(k_frac, minval=0.7, maxval=1.0), u(k_start),
        jax.random.normal(k_x0, (b, n, d), jnp.float32), u(k_t), u(k_da), u(k_db))))
    drop_audio = (draws.drop_audio < 0.5) | (draws.drop_both < 0.3)
    assert drop_audio.tolist() == [True, True, False, True]
    assert (draws.drop_both < 0.3).tolist() == [False, True, False, True]

    def jloss(p):
        p = jm.fuse_backbone_qkv(p, dtype=jnp.float32)
        return jcfm.cfm_loss(p, jdit.DiTStatics(jarch), key, jnp.asarray(mel), jnp.asarray(text),
                             jnp.asarray(lens), cfg=jcfg, dtype=jnp.float32, backend="xla")[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jx(tree))
    step = tstep.make_train_step(tdit.DiTStatics(tarch), tstep.make_optimizer(1e-4, 10, 100),
                                 CFMConfig(audio_drop_prob=0.5, cond_drop_prob=0.3),
                                 dtype=torch.float32)
    loss, grads = step.grad_step(tp, torch.from_numpy(mel), torch.from_numpy(text),
                                 torch.from_numpy(lens), draws=draws)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = tm.tree_leaves(dit_params_from_jax(jax.tree.map(np.asarray, want_grads)))
    got = tm.tree_leaves(grads)
    assert len(got) == len(want)
    worst = max(_rel(_np(g), _np(w)) for g, w in zip(got, want) if float(w.abs().max()) > 0)
    assert worst <= 1e-4, worst


def _j_tree_map_np(fn, *trees):
    return jax.tree.map(lambda *a: fn(*(np.asarray(x) for x in a)), *trees)


def test_apply_steps_match_optax_and_fused_update(model):
    jarch, _, tree, _ = model
    hp = jstep.OptHParams(learning_rate=1e-3, warmup_updates=3, total_updates=10)
    tx = jstep.make_optimizer(1e-3, 3, 10)
    kw = dict(ema_decay=0.9, ema_update_every=2, ema_update_after_step=2)
    statics = jdit.DiTStatics(jarch)
    optax_apply = jax.jit(jstep.make_train_step(statics, tx, **kw).apply_step)
    fused_apply = jax.jit(jstep.make_train_step(statics, tx, hp=hp, **kw).apply_step)
    rng = np.random.default_rng(5)

    def grads(scale):  # global norm ~ scale (clipped when > 1)
        g = _j_tree_map_np(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        norm = np.sqrt(sum(float(np.sum(x * x)) for x in jax.tree.leaves(g)))
        return _j_tree_map_np(lambda a: (a * (scale / norm)).astype(np.float32), g)

    # a state one update in (step 1, non-zero moments), then 3 updates: the
    # EMA copies (step 2), skips (3) and decays (4); the lr crosses the warmup
    # boundary at count 3; the grads are clipped at updates 1 and 3 only
    state0 = jstep.init_train_state(jx(tree), tx)
    state0, _ = optax_apply(state0, jnp.float32(0), jx(grads(0.5)))
    gs = [grads(s) for s in (3.0, 0.4, 2.0)]
    j_optax, j_fused = state0, state0
    port = train_state_from_jax(jax.tree.map(np.asarray, state0))
    assert (port.step, port.count) == (1, 1)
    step = tstep.make_train_step(None, tstep.make_optimizer(1e-3, 3, 10), **kw)
    for g in gs:
        j_optax, _ = optax_apply(j_optax, jnp.float32(0), jx(g))
        j_fused, mj = fused_apply(j_fused, jnp.float32(0), jx(g))
        port, mt = step.apply_step(port, torch.tensor(0.0), dit_params_from_jax(g))
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-6)
    assert (port.step, port.count) == (4, 4)
    for want_state in (j_optax, j_fused):
        want = train_state_from_jax(jax.tree.map(np.asarray, want_state))
        assert (want.step, want.count) == (port.step, port.count)
        for name in ("params", "mu", "nu", "ema"):
            for a, b in zip(tm.tree_leaves(getattr(port, name)), tm.tree_leaves(getattr(want, name))):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-8, err_msg=name)


def test_schedule_and_ema_alpha_match_jax():
    hp = jstep.OptHParams(learning_rate=7.5e-5, warmup_updates=20, total_updates=200)
    sched = jstep._make_schedule(hp)
    thp = tstep.make_optimizer(7.5e-5, 20, 200)
    for count in (0, 1, 19, 20, 21, 150, 199, 200, 500):
        assert tstep.learning_rate_at(thp, count) == np.float32(sched(count))
    assert [float(tstep.ema_alpha(s, 0.999, 10, 100)) for s in (5, 10, 100, 110)] == \
        [1.0, 0.0, 0.0, float(np.float32(0.999))]


def test_sampler_collate_and_mel_match_jax():
    rng = np.random.default_rng(6)
    frame_lens = [float(x) for x in rng.integers(20, 400, 57)] + [5000.0]  # one oversized
    for kw in (dict(frames_threshold=1000, max_samples=0, random_seed=3),
               dict(frames_threshold=1600, max_samples=4, random_seed=None, drop_residual=True)):
        js, ts = jds.DynamicBatchSampler(frame_lens, **kw), tds.DynamicBatchSampler(frame_lens, **kw)
        assert ts.batches == js.batches
        for epoch in (0, 1):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js)
    samples = [(rng.standard_normal((t, 100)).astype(np.float32), "ab" * t) for t in (70, 130, 5)]
    for kw in ({}, {"max_frames": 128}, {"pad_to": 256}):
        jb = jds.collate([jds.Sample(m, t) for m, t in samples], **kw)
        tb = tds.collate([tds.Sample(m, t) for m, t in samples], **kw)
        assert jb.keys() == tb.keys() and tb["text"] == jb["text"]
        for k in ("mel", "mel_lengths", "text_lengths"):
            np.testing.assert_array_equal(tb[k], jb[k])
    wav = (0.1 * rng.standard_normal(24000)).astype(np.float32)
    np.testing.assert_allclose(tds.NumpyMel()(wav), jds.NumpyMel(jds.MelConfig())(wav), atol=1e-5)


@pytest.mark.parametrize("qk_norm,long_skip", [(None, False), ("rms_norm", False),
                                                ("rms_norm", True)])
def test_checkpoints_and_safetensors(model, tmp_path, qk_norm, long_skip):
    _, _, tree, tp = model
    if qk_norm or long_skip:  # the export carries qk-norm's weights and the long skip's
        from f5tts_tpu.config import ModelArch as JArch

        jarch = JArch(**SMALL, qk_norm=qk_norm, long_skip_connection=long_skip)
        tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 11)
        tp = dit_params_from_jax(tree)
    state = tstep.init_train_state(tp)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), keep_last_n=1)
    for step in (2, 4):
        state.step = state.count = step
        state.ema["proj_out"]["b"] += 1.0
        mgr.save(state)
    state.step = 5
    mgr.save(state, heartbeat=True)
    state.step = 6
    mgr.save(state, heartbeat=True)
    # the heartbeat keeps one file and never evicts the kept milestone
    assert mgr.milestones() == [4] and sorted(os.listdir(mgr.last_dir)) == ["model_6.pt"]
    assert mgr.latest_step() == 6
    back = mgr.restore()
    assert (back.step, back.count) == (6, 4)
    for name in ("params", "mu", "nu", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(back, name)), tm.tree_leaves(getattr(state, name))):
            assert torch.equal(a, b)
    assert mgr.restore(4).step == 4
    ema = tckpt.load_params(str(tmp_path / "ck"))
    assert torch.equal(ema["proj_out"]["b"], state.ema["proj_out"]["b"])
    # safetensors: the JAX package's keys, header and tensors, byte for byte.
    # Its own save_safetensors_ema hands the transposed (non-contiguous) Linear
    # and Conv1d views to safetensors' numpy save_file, which writes their
    # buffers in memory order and so scrambles them; the port writes each
    # tensor in C order, which is what save_file writes for contiguous copies.
    from safetensors.numpy import load_file, save_file

    tckpt.save_safetensors_ema(tp, str(tmp_path / "port.safetensors"))
    ref = jckpt._to_reference_keys(tree, prefix="ema_model.")
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in ref.items()},
              str(tmp_path / "jax.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "jax.safetensors").read_bytes()
    back = load_file(str(tmp_path / "port.safetensors"))
    w = "ema_model.transformer.transformer_blocks.1.attn.to_q.weight"
    np.testing.assert_array_equal(back[w], tree["blocks"]["attn"]["to_q"]["w"][1].T)
    jckpt.save_safetensors_ema(tree, str(tmp_path / "jax_export.safetensors"))
    assert load_file(str(tmp_path / "jax_export.safetensors")).keys() == back.keys()
    assert ("ema_model.transformer.transformer_blocks.0.attn.q_norm.weight" in back) == bool(qk_norm)
    assert ("ema_model.transformer.long_skip_connection.weight" in back) == long_skip


def _tiny_dataset(seed=0, count=12):
    rng = np.random.default_rng(seed)
    mels = [rng.standard_normal((int(t), 100)).astype(np.float32)
            for t in rng.integers(60, 200, count)]
    return tds.InMemoryDataset(mels, ["hello world, " * (i % 3 + 1) for i in range(count)])


def _trainer(model, save_dir, **cfg_kw):
    _, tarch, _, tp = model
    cfg = TrainConfig(batch_size_per_device=400, num_warmup_updates=2, save_dir=str(save_dir),
                      save_per_updates=1000, last_per_updates=1000, logger=None,
                      ema_update_every=2, ema_update_after_step=1, **cfg_kw)
    return Trainer(tp, tdit.DiTStatics(tarch), cfg, vocab_char_map=VOCAB, tokenizer="char",
                   device="cpu", dtype=torch.float32)


def test_trainer_three_updates_and_resume(model, tmp_path):
    data = _tiny_dataset()
    straight = _trainer(model, tmp_path / "a")
    seen = []
    straight.train(data, max_updates=3, log_every=1,
                   on_update=lambda u, m: seen.append((u, float(m["loss"]), float(m["grad_norm"]))))
    assert [u for u, _, _ in seen] == [1, 2, 3]
    assert all(np.isfinite(x) for _, loss, gn in seen for x in (loss, gn))
    assert straight.state.step == straight.state.count == 3
    # two updates, then a new trainer resumes from the heartbeat and takes the third
    first = _trainer(model, tmp_path / "b")
    first.train(data, max_updates=2)
    resumed = _trainer(model, tmp_path / "b")
    resumed.train(data, max_updates=3)
    assert resumed.state.step == 3
    # the same batches and draws; the CPU GEMMs may split their sums otherwise
    # between the two runs (threads under load), hence a tolerance
    for name in ("params", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(resumed.state, name)),
                        tm.tree_leaves(getattr(straight.state, name))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)
    # the EMA decayed at update 2 (every 2, after 1) and skipped update 3
    p0 = tm.tree_leaves(model[3])[0]
    ema_leaf, param_leaf = (tm.tree_leaves(t)[0] for t in (straight.state.ema, straight.state.params))
    assert not torch.equal(ema_leaf, p0) and not torch.equal(ema_leaf, param_leaf)


def test_trainer_grad_accumulation_and_tokenizers(model, tmp_path):
    from f5tts_tpu.text.vocab import list_str_to_idx, list_str_to_tensor

    trainer = _trainer(model, tmp_path, grad_accumulation_steps=2)
    updates = []
    trainer.train(_tiny_dataset(1), max_updates=2, on_update=lambda u, m: updates.append(u))
    assert updates == [1, 2] and trainer.state.step == 2
    texts = ["hello there.", "ça va?"]
    np.testing.assert_array_equal(trainer.tokenize(texts), list_str_to_idx(texts, VOCAB))
    trainer.tokenizer = "byte"
    np.testing.assert_array_equal(trainer.tokenize(texts), list_str_to_tensor(texts))
    # the pinyin tokenizer against the JAX trainer's `tokenize` (its method
    # run on the same vocab and texts): strings are converted first, token
    # lists (what prepared datasets store) are looked up as they are
    from types import SimpleNamespace

    from f5tts_tpu.text.vocab import load_vocab
    from f5tts_tpu.train.trainer import Trainer as JTrainer
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB

    vocab = load_vocab(EMILIA_VOCAB)
    pinyin = Trainer(model[3], tdit.DiTStatics(model[1]), TrainConfig(), vocab_char_map=vocab,
                     tokenizer="pinyin", device="cpu")
    jax_side = SimpleNamespace(tokenizer="pinyin", vocab_char_map=vocab)
    for batch in (["你好，世界。Hello there!", "一起去银行"], [["ni2", " ", "hao3"], ["a", "b"]],
                  [("zhong1", "guo2")]):
        np.testing.assert_array_equal(pinyin.tokenize(batch), JTrainer.tokenize(jax_side, batch))
    with pytest.raises(ValueError, match="needs a vocab_char_map"):
        Trainer(model[3], tdit.DiTStatics(model[1]), TrainConfig(), tokenizer="pinyin", device="cpu")


def test_trainer_default_tokenizer_is_pinyin_as_jax(model):
    """Trainer() with no tokenizer= tokenizes as the JAX Trainer() does."""
    from f5tts_tpu.config import TrainConfig as JTrainConfig
    from f5tts_tpu.text.vocab import load_vocab
    from f5tts_tpu.train.trainer import Trainer as JTrainer
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB

    jarch, tarch, tree, tp = model
    vocab = load_vocab(EMILIA_VOCAB)
    port = Trainer(tp, tdit.DiTStatics(tarch), TrainConfig(logger=None), vocab_char_map=vocab,
                   device="cpu")
    jax_side = JTrainer(jx(tree), jdit.DiTStatics(jarch), JTrainConfig(logger=None),
                        vocab_char_map=vocab, dtype=jnp.float32, backend="xla")
    assert port.tokenizer == jax_side.tokenizer == "pinyin"
    for texts in (["今天天气很好，我们去公园。"], ["Hello there, general Kenobi!"],
                  ["你好 world", "银行"]):
        np.testing.assert_array_equal(port.tokenize(texts), jax_side.tokenize(texts))
        np.testing.assert_array_equal(port.tokenize(texts, pad_to=40),
                                      jax_side.tokenize(texts, pad_to=40))
    assert port.tokenize(["银行"], pad_to=12).shape == (1, 12)


def _scalar_steps(log_dir) -> dict:
    """{tag: [steps]} of the scalars in a tensorboard log directory."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [e.step for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_trainer_tensorboard_scalars_match_jax(model, tmp_path):
    """logger="tensorboard": the port's Trainer writes the scalars the JAX
    Trainer writes for the same run (tags and steps); logger=None writes
    nothing; log_samples without a vocoder writes no sample."""
    from f5tts_tpu.config import TrainConfig as JTrainConfig
    from f5tts_tpu.train.trainer import Trainer as JTrainer

    jarch, tarch, tree, tp = model
    data = _tiny_dataset()
    kw = dict(batch_size_per_device=400, num_warmup_updates=2, save_per_updates=1000,
              last_per_updates=1000, ema_update_every=2, ema_update_after_step=1)

    class JaxData:  # the same rows as the port's dataset
        def __len__(self):
            return len(data)

        def get_frame_len(self, i):
            return data.get_frame_len(i)

        def __getitem__(self, i):
            s = data[i]
            return jds.Sample(mel=s.mel, text=s.text)

    jtr = JTrainer(jax.tree.map(jnp.asarray, tree), jdit.DiTStatics(jarch),
                   JTrainConfig(save_dir=str(tmp_path / "jck"), **kw), vocab_char_map=VOCAB,
                   tokenizer="char", dtype=jnp.float32, backend="xla", logger="tensorboard",
                   log_dir=str(tmp_path / "jtb"))
    jtr.train(JaxData(), max_updates=2, log_every=1)
    jtr.writer.flush()
    port = Trainer(tp, tdit.DiTStatics(tarch), TrainConfig(save_dir=str(tmp_path / "tck"), **kw),
                   vocab_char_map=VOCAB, tokenizer="char", device="cpu", dtype=torch.float32,
                   log_dir=str(tmp_path / "ttb"))  # train_cfg.logger defaults to tensorboard
    port.train(data, max_updates=2, log_every=1)
    want = _scalar_steps(tmp_path / "jtb")
    assert want == {"loss": [1, 2], "grad_norm": [1, 2], "updates_per_s": [1, 2]}
    assert _scalar_steps(tmp_path / "ttb") == want

    quiet = _trainer(model, tmp_path / "q")  # TrainConfig(logger=None)
    assert quiet.writer is None
    quiet.train(data, max_updates=1, log_every=1)
    assert not list(tmp_path.glob("q/**/events.out.tfevents*"))
    # log_samples without a vocoder writes no sample, as the JAX trainer
    silent = _trainer(model, tmp_path / "s", log_samples=True)
    silent.train(data, max_updates=1)
    assert silent._last_sample is not None and silent._log_sample(1) is None
    assert not (tmp_path / "s" / "samples").exists()
