"""Data parallelism, ZeRO-1 and tensor parallelism of the port's training
step (`parallel.mesh`, `train.step`, `train.lora`, the Trainer) on the CPU.

One spawn of two gloo processes (`tests/torch_dist_jobs.py`, a FileStore
under tmp_path) runs two updates of a small DiT (dim 128, 4 x 32 heads,
f32) at 2 x 1 with a replicated state, at 2 x 1 under ZeRO-1 and at 1 x 2
(TP), on a batch of four rows with unequal lengths (the loss divides by the
global span count); the qk-norm DiT and MMDiT at 1 x 2; ZeRO-1 again with two micro-batches an update and with
bf16 moments / EMA; LoRA under ZeRO-1 with accumulation and a checkpoint
between the updates, and under TP; the Trainer at 2 x 1 with ZeRO-1. Each
is held to the one-process port step on the whole batch with the same
draws (loss, params, mu / nu, EMA within 2e-5, as the JAX package's
`test_zero1_step_matches_replicated`; bf16-stored moments within a bf16
ulp), and the one-process step to JAX's `make_train_step`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import CFMConfig as JCFMConfig
from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.train import step as jstep
from f5tts_tpu_torch.config import CFMConfig, ModelArch, TrainConfig
from f5tts_tpu_torch.convert import PARAMS_FROM_JAX, dit_params_from_jax
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.train import lora as tl
from f5tts_tpu_torch.train.checkpoint import CheckpointManager
from f5tts_tpu_torch.train.dataset import InMemoryDataset
from f5tts_tpu_torch.train.step import init_train_state
from f5tts_tpu_torch.train.trainer import Trainer
from tests.test_torch_dit import jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.torch_dist_jobs import _run_steps, make_step, spawn

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = dict(dim=128, depth=2, heads=4, dim_head=32, ff_mult=2, text_dim=64, conv_layers=1,
            text_num_embeds=32, mel_dim=16)
# qk-norm backbones for the TP step (the per-head RMSNorm weights whole on
# every rank)
QK_ARCHS = {
    "dit": ("DiT", dict(ARCH, qk_norm="rms_norm")),
    "mmdit": ("MMDiT", dict(dim=128, depth=2, heads=4, dim_head=32, ff_mult=2, text_dim=None,
                            conv_layers=0, text_num_embeds=32, mel_dim=16, qk_norm="rms_norm")),
}
STEP_KW = {"opt": (1e-3, 3, 10), "cfm": {},
           "ema": dict(ema_decay=0.9, ema_update_every=1, ema_update_after_step=0)}
TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,'!?")}
TRAINER_CFG = dict(batch_size_per_device=200, max_samples=4, num_warmup_updates=2,
                   save_per_updates=2, last_per_updates=1000, ema_update_every=1,
                   ema_update_after_step=0, learning_rate=1e-3)


def _batch(seed: int, lens, b: int = 4, n: int = 64):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, ARCH["mel_dim"])).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    mel[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    text = rng.integers(0, 32, (b, 12)).astype(np.int32)
    text[1, 7:] = -1
    return torch.from_numpy(mel), torch.from_numpy(text), torch.from_numpy(lens)


def _trainer_data():
    rng = np.random.default_rng(7)
    mels = [rng.standard_normal((int(t), ARCH["mel_dim"])).astype(np.float32)
            for t in (40, 45, 50, 55, 41, 47, 52, 58)]
    texts = ["hello there", "a quiet voice", "good morning", "see you soon"] * 2
    return mels, texts


@pytest.fixture(scope="module")
def setup():
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), JArch(**ARCH)), 19)
    params = dit_params_from_jax(tree)
    lora = tl.init_lora(torch.Generator().manual_seed(3), params, tl.LoRAConfig(rank=4))
    lora = tm.tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=torch.Generator()
                                                        .manual_seed(t.numel())), lora)
    return {"tree": tree, "params": params, "batch": _batch(0, [64, 30, 50, 20]),
            "micro": [_batch(s, lens) for s, lens in (
                (1, [64, 64, 10, 33]), (2, [5, 60, 41, 64]), (3, [64, 22, 64, 48]),
                (4, [17, 64, 30, 64]))],
            "seeds": [10, 11], "micro_seeds": [20, 21, 22, 23], "lora": lora,
            "lora_cfm": CFMConfig(audio_drop_prob=0.0, cond_drop_prob=0.0),
            "qk_norm": {name: {"backbone": bb, "arch": arch, "params": PARAMS_FROM_JAX[bb](
                np_params(lambda: init(jax.random.PRNGKey(0), JArch(**arch)), 23))}
                for (name, (bb, arch)), init in zip(QK_ARCHS.items(),
                                                     (jdit.init_dit, jmmdit.init_mmdit))}}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """The two processes' results (one spawn for the whole file)."""
    tmp = tmp_path_factory.mktemp("zero1")
    payload = {k: setup[k] for k in ("params", "batch", "micro", "seeds", "micro_seeds", "lora",
                                     "lora_cfm", "qk_norm")}
    payload.update(arch=ARCH, step_kw=STEP_KW, vocab=VOCAB, trainer_cfg=TRAINER_CFG,
                   trainer_data=_trainer_data())
    return spawn("steps", 2, tmp, payload), tmp


def _one_rank(setup, batches, seeds, accum=1, sdt=None):
    step = make_step(tdit.DiTStatics(ModelArch(**ARCH)), STEP_KW)
    state = init_train_state(setup["params"], moment_dtype=sdt, ema_dtype=sdt)
    return _run_steps(step, state, batches, seeds, accum)


def _close_states(got, want, names=("params", "mu", "nu", "ema"), **tol):
    tol = tol or TOL
    assert (got.step, got.count) == (want.step, want.count)
    for name in names:
        a, b = tm.tree_leaves(getattr(got, name)), tm.tree_leaves(getattr(want, name))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype, name
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), err_msg=name, **tol)


def test_one_rank_step_matches_jax_make_train_step(setup):
    """Two updates of the port's step (the JAX key's draws passed in) against
    the JAX fused step, f32."""
    jarch = JArch(**ARCH)
    lr, warmup, total = STEP_KW["opt"]
    hp = jstep.OptHParams(lr, warmup, total)
    jfn = jax.jit(jstep.make_train_step(jdit.DiTStatics(jarch), jstep.make_optimizer(lr, warmup,
                                                                                     total),
                                        JCFMConfig(), dtype=jnp.float32, backend="xla", hp=hp,
                                        **STEP_KW["ema"]))
    jstate = jstep.init_train_state(jx(setup["tree"]), jstep.make_optimizer(lr, warmup, total))
    step = make_step(tdit.DiTStatics(ModelArch(**ARCH)), STEP_KW)
    state = init_train_state(setup["params"])
    mel, text, lens = setup["batch"]
    b, n, d = mel.shape
    for u in range(2):
        key = jax.random.PRNGKey(100 + u)
        k_frac, k_start, k_x0, k_t, k_da, k_db = jax.random.split(key, 6)
        uni = functools.partial(jax.random.uniform, shape=(b,))
        draws = tcfm.CFMDraws(*(torch.from_numpy(np.array(a)) for a in (
            uni(k_frac, minval=0.7, maxval=1.0), uni(k_start),
            jax.random.normal(k_x0, (b, n, d), jnp.float32), uni(k_t), uni(k_da), uni(k_db))))
        jstate, jm = jfn(jstate, key, jnp.asarray(mel.numpy()), jnp.asarray(text.numpy()),
                         jnp.asarray(lens.numpy()))
        state, metrics = step(state, mel, text, lens, draws=draws)
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=2e-5)
    want = dit_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for a, b_ in zip(tm.tree_leaves(state.params), tm.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)
    want = dit_params_from_jax(jax.tree.map(np.asarray, jstate.ema_params))
    for a, b_ in zip(tm.tree_leaves(state.ema), tm.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)


@pytest.mark.parametrize("name", ["dp", "z1", "tp"])
def test_two_rank_steps_match_one_rank(setup, ranks, name):
    """2 x 1 replicated, 2 x 1 ZeRO-1 and 1 x 2 TP: two updates on rows
    with unequal lengths equal the one-process step on the whole batch."""
    ref, losses, norms = _one_rank(setup, [setup["batch"]] * 2, setup["seeds"])
    for out in ranks[0]:
        got = out[name]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        np.testing.assert_allclose(got["norms"], norms, **TOL)
        _close_states(got["state"], ref)


@pytest.mark.parametrize("name", ["dit", "mmdit"])
def test_tp_qk_norm_steps_match_one_rank(setup, ranks, name):
    """1 x 2 TP of the qk-norm DiT and MMDiT: the per-head RMSNorm weights
    are whole on each rank and see its heads only, so their gradient is
    summed over the model group. Two updates equal the one-process step, and
    both ranks hold the same norm weights after them."""
    case = setup["qk_norm"][name]
    backbone = tcfm.BACKBONES[case["backbone"]]
    step = make_step(backbone.statics_cls(ModelArch(**case["arch"])), STEP_KW,
                     backbone=case["backbone"])
    ref, losses, norms = _run_steps(step, init_train_state(case["params"]),
                                    [setup["batch"]] * 2, setup["seeds"])
    for out in ranks[0]:
        got = out["qk_" + name]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        np.testing.assert_allclose(got["norms"], norms, **TOL)
        _close_states(got["state"], ref)
    norms_of = [[t for path, t in _named_leaves(out["qk_" + name]["local_params"])
                 if path[-2] in ("q_norm", "k_norm", "c_q_norm", "c_k_norm")]
                for out in ranks[0]]
    assert norms_of[0] and all(torch.equal(a, b) for a, b in zip(*norms_of))


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, path)
    else:
        yield path, tree


def test_zero1_rank_holds_only_its_shard(setup, ranks):
    total = sum(t.numel() for t in tm.tree_leaves(setup["params"]))
    for out in ranks[0]:
        for name, dtype in (("z1", torch.float32), ("z1_bf16", torch.bfloat16)):
            mu, nu, ema, mdt = out[name + "_shard"]
            assert mu == nu == ema == -(-total // 2) and mdt == dtype


def test_zero1_grad_accumulation(setup, ranks):
    """Two micro-batches an update, reduced once an update."""
    ref, losses, _ = _one_rank(setup, setup["micro"], setup["micro_seeds"], accum=2)
    for out in ranks[0]:
        np.testing.assert_allclose(out["z1_accum"]["losses"], losses, **TOL)
        _close_states(out["z1_accum"]["state"], ref)


def test_zero1_bf16_state(setup, ranks):
    """bf16 moments and EMA as flat ZeRO-1 shards: params within 2e-5, the
    stored bf16 trees within a bf16 ulp of the one-process run's."""
    ref, losses, _ = _one_rank(setup, [setup["batch"]] * 2, setup["seeds"], sdt=torch.bfloat16)
    for out in ranks[0]:
        np.testing.assert_allclose(out["z1_bf16"]["losses"], losses, **TOL)
        _close_states(out["z1_bf16"]["state"], ref, names=("params",))
        _close_states(out["z1_bf16"]["state"], ref, names=("mu", "nu", "ema"), atol=1e-6,
                      rtol=8e-3)


def _lora_one_rank(setup):
    step = tl.make_lora_train_step(setup["params"], tdit.DiTStatics(ModelArch(**ARCH)),
                                   tl.AdamWHParams(5e-3), tl.LoRAConfig(rank=4), setup["lora_cfm"],
                                   dtype=torch.float32)
    lora = tm.tree_map(torch.clone, setup["lora"])
    opt = tl.init_lora_opt_state(lora)
    for u in range(2):
        g_sum = None
        for k in range(2):
            mel, text, lens = setup["micro"][2 * u + k]
            gen = torch.Generator().manual_seed(setup["micro_seeds"][2 * u + k])
            _, grads = step.loss_and_grads(lora, mel, text, lens, generator=gen)
            if g_sum is None:
                g_sum = grads
            else:
                torch._foreach_add_(tm.tree_leaves(g_sum), tm.tree_leaves(grads))
        torch._foreach_div_(tm.tree_leaves(g_sum), 2.0)
        step.apply(lora, opt, g_sum)
    return lora, opt


@pytest.mark.parametrize("name", ["lora_z1", "lora_tp"])
def test_lora_zero1_accumulation_checkpoint_and_tp(setup, ranks, name):
    """LoRA (adapters TP-sharded as `lora_param_specs`, the whole factor
    through copy_to_tp): under ZeRO-1 with two micro-batches an update and
    a gathered checkpoint re-sharded between the updates, and at 1 x 2."""
    lora, opt = _lora_one_rank(setup)
    for out in ranks[0]:
        got = out[name]
        for key, want in (("lora", lora), ("mu", opt.mu), ("nu", opt.nu)):
            for a, b in zip(tm.tree_leaves(got[key]), tm.tree_leaves(want)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5,
                                           err_msg=key)
    if name == "lora_z1":
        assert all(out["lora_z1_ckpt_step"] == 1 for out in ranks[0])


def test_lora_param_specs_match_jax(setup):
    from f5tts_tpu.parallel.mesh import dit_param_specs as j_specs
    from f5tts_tpu.train import lora as jlora
    from f5tts_tpu_torch.parallel.mesh import dit_param_specs

    jtree = jx(setup["tree"])
    jl = jlora.init_lora(jax.random.PRNGKey(1), jtree, jlora.LoRAConfig(rank=4))
    want = jlora.lora_param_specs(jl, j_specs(jtree))
    got = tl.lora_param_specs(setup["lora"], dit_param_specs(setup["params"]))
    assert sorted(got) == sorted(want)
    for group, subs in got.items():
        assert sorted(subs) == sorted(want[group])
        for name, ab in subs.items():
            for leaf in ("a", "b"):
                assert ab[leaf].axes == tuple(want[group][name][leaf]), (group, name, leaf)


def test_trainer_saves_at_two_ranks_resumes_at_one(setup, ranks, tmp_path):
    """Trainer(mesh 2 x 1, zero1) writes the single-device file, equal to a
    one-process Trainer's at twice the frame budget and warm-up; a
    one-process Trainer resumes from it and trains on."""
    results, tmp = ranks
    assert [out["trainer_step"] for out in results] == [2, 2]
    mesh_ckpt = CheckpointManager(str(tmp / "trainer"))
    assert mesh_ckpt.milestones() == [2]
    cfg = dict(TRAINER_CFG, batch_size_per_device=400, num_warmup_updates=4)

    def trainer(save_dir):
        return Trainer(setup["params"], tdit.DiTStatics(ModelArch(**ARCH)),
                       TrainConfig(**cfg, save_dir=str(save_dir)), tokenizer="char",
                       vocab_char_map=VOCAB, dtype=torch.float32, device="cpu", logger=None,
                       total_updates=20)

    one = trainer(tmp_path / "one")
    metrics = one.train(InMemoryDataset(*_trainer_data()), max_updates=2, log_every=1)
    np.testing.assert_allclose(results[0]["trainer_metrics"]["loss"], metrics["loss"], **TOL)
    saved = mesh_ckpt.restore(device="cpu")
    _close_states(saved, one.state)
    assert saved.shard is None and saved.mu["proj_out"]["w"].shape == (128, 16)

    resumed = trainer(tmp / "trainer")
    assert resumed.maybe_resume() == 2
    _close_states(resumed.state, saved, atol=0, rtol=0)
    more = resumed.train(InMemoryDataset(*_trainer_data()), max_updates=3, log_every=1)
    assert resumed.state.step == 3 and np.isfinite(more["loss"])
