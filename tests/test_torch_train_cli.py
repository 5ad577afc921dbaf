"""Port training entry points (train_cli, finetune_cli, the trainer's
milestone samples) against the JAX package, on the CPU.

A tiny corpus (seeded wavs) is prepared by the port's prepare_csv_wavs
(pinyin, the bundled Emilia vocab) and trained on by a small DiT (dim 128,
depth 2, 2 x 64 heads), f32. The JAX CLIs run with their Trainer replaced
by a spy, so the configs, vocab, arch and weights they build are compared
with the port's exactly. Tolerances: the milestone sample's mel against
JAX `cfm_sample` fed the port's noise as `y0`, rel-L2 <= 1e-4 over the
generated frames (32 Euler steps through two blocks in f32); its wavs
against the JAX Vocos on the same mel, max-abs <= 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu import config as jconfig
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch import config as tconfig
from f5tts_tpu_torch.convert import dit_params_from_jax, vocos_params_from_jax
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as tdit
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.train import finetune_cli, train_cli
from f5tts_tpu_torch.train.trainer import Trainer
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import SMALL, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.test_torch_vocos_mel import SMALL_VOCOS

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64, conv_layers=1,
                 text_mask_padding=True, pe_attn_head=None)
EMILIA_SIZE = 2545


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """data/tiny_pinyin made by the port's prepare_csv_wavs: 8 clips of
    0.6-1.3 s, Chinese and English text."""
    from f5tts_tpu_torch.train.datasets.prepare_csv_wavs import prepare

    src = tmp_path_factory.mktemp("csv")
    (src / "wavs").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    texts = ["hello there", "你好世界", "a quiet voice", "一起去银行", "good morning",
             "今天天气很好", "see you soon", "谢谢你"]
    for i, text in enumerate(texts):
        n = int((0.6 + 0.1 * i) * 24000)
        wav = 0.1 * np.sin(np.arange(n) * (0.02 + 0.003 * i)) + 0.01 * rng.standard_normal(n)
        audio_io.write_wav(str(src / "wavs" / f"u{i}.wav"), wav.astype(np.float32), 24000)
        lines.append(f"wavs/u{i}.wav|{text}")
    (src / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    root = tmp_path_factory.mktemp("data")
    prepare(str(src), str(root / "tiny_pinyin"), use_pretrained_vocab=True, workers=2)
    return root


def _yaml(path, save_dir, **ckpts):
    import yaml

    cfg = {"datasets": {"name": "tiny", "batch_size_per_gpu": 300, "max_samples": 4},
           "optim": {"epochs": 20, "learning_rate": 1e-4, "num_warmup_updates": 2},
           "model": {"name": "tiny", "tokenizer": "pinyin", "backbone": "DiT",
                     "arch": dict(TINY_ARCH, depth=2), "mel_spec": {"mel_spec_type": "vocos"}},
           "ckpts": dict({"logger": None, "log_samples": True, "save_per_updates": 1000,
                          "last_per_updates": 1000, "save_dir": str(save_dir)}, **ckpts)}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class _Spy:
    """Stands in for the JAX Trainer: records what the CLI built."""

    seen: list = []

    def __init__(self, params, statics, tcfg, **kw):
        _Spy.seen.append(dict(params=jax.tree.map(np.asarray, params), arch=statics.arch,
                              tcfg=tcfg, **kw))

    def train(self, *a, **kw):
        return {}


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _common_fields(a, b) -> tuple[dict, dict]:
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    keys = set(da) & set(db)
    return {k: da[k] for k in keys}, {k: db[k] for k in keys}


def test_apply_overrides_matches_jax():
    from f5tts_tpu.train.train_cli import apply_overrides as japply

    base = {"optim": {"epochs": 11}, "datasets": {"name": "x"}}
    ovs = ["optim.epochs=3", "++datasets.name=LJSpeech", "+model.arch.depth=4",
           "ckpts.logger=null", "optim.learning_rate=0.0001", "new.flag=true", "lst=[1, 2]"]
    want = japply({k: dict(v) for k, v in base.items()}, ovs)
    got = train_cli.apply_overrides({k: dict(v) for k, v in base.items()}, ovs)
    assert got == want
    assert got["optim"] == {"epochs": 3, "learning_rate": 1e-4}
    assert got["model"]["arch"]["depth"] == 4 and got["lst"] == [1, 2]


def test_train_cli_main_end_to_end_and_matches_jax(data_root, tmp_path, monkeypatch):
    cfg = _yaml(tmp_path / "tiny.yaml", tmp_path / "ckpt")
    argv = ["--config", cfg, "--data_root", str(data_root), "--max_updates", "2", "--bf16_state",
            "optim.max_grad_norm=0.5"]
    import f5tts_tpu.train.trainer as jtrainer

    monkeypatch.setattr(jtrainer, "Trainer", _Spy)
    _Spy.seen.clear()
    from f5tts_tpu.train.train_cli import main as jmain

    jmain(argv)
    (jseen,) = _Spy.seen
    args = train_cli.parse_args(argv + ["--device", "cpu"])
    raw, dataset = train_cli.load(args)
    mcfg, tcfg, vocab, vocab_size, arch, backbone = train_cli.build(raw, str(data_root))
    assert vocab == jseen["vocab_char_map"] and vocab_size == EMILIA_SIZE
    assert jseen["tokenizer"] == mcfg.tokenizer == "pinyin" and jseen["bf16_state"]
    got, want = _common_fields(tcfg, jseen["tcfg"])
    assert got == want and tcfg.max_grad_norm == 0.5 and tcfg.log_samples
    got, want = _common_fields(arch, jseen["arch"])
    assert got == want and arch.text_num_embeds == EMILIA_SIZE
    assert backbone.name == jseen["backbone"].name == "DiT"
    assert len(dataset) == 8 and isinstance(dataset.get_text(1), list)

    metrics = train_cli.main(argv + ["--device", "cpu"])
    assert np.isfinite(metrics.get("loss", 0.0))
    from f5tts_tpu_torch.train.checkpoint import CheckpointManager

    state = CheckpointManager(str(tmp_path / "ckpt")).restore(device="cpu")
    assert state.step == 2 and state.mu["proj_out"]["b"].dtype == torch.bfloat16
    # the seed-0 init of the port's backbone, its text table the vocab's
    assert state.params["text_embed"]["embed"]["w"].shape[0] == EMILIA_SIZE + 1


def test_cli_flags_for_more_than_one_device_raise(tmp_path):
    """The mesh flags parse and build the mesh (a one-process group here);
    a mesh larger than the processes raises; Trainer(mesh, zero1=True)
    constructs on it, and zero1 without a mesh raises."""
    import torch.distributed as dist

    cfg = _yaml(tmp_path / "tiny.yaml", tmp_path / "ckpt")
    args = train_cli.parse_args(["--config", cfg, "--zero1", "--mesh_data", "1", "--mesh_model",
                                 "1", "--device", "cpu"])
    assert (args.zero1, args.mesh_data, args.mesh_model) == (True, 1, 1)
    assert train_cli.setup_mesh(train_cli.parse_args(["--config", cfg]), "cpu") is None
    tp = dit_params_from_jax(np_params(lambda: jdit.init_dit(
        jax.random.PRNGKey(0), jconfig.ModelArch(**SMALL)), 1))
    statics = tdit.DiTStatics(tconfig.ModelArch(**SMALL))
    with pytest.raises(ValueError, match="pass mesh"):
        Trainer(tp, statics, tconfig.TrainConfig(), vocab_char_map={" ": 0}, device="cpu",
                zero1=True)
    assert not dist.is_initialized()
    try:
        mesh = train_cli.setup_mesh(args, "cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.tp is None
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        tr = Trainer(tp, statics, tconfig.TrainConfig(save_dir=str(tmp_path / "z")),
                     vocab_char_map={" ": 0}, device="cpu", mesh=mesh, zero1=True)
        total = sum(t.numel() for t in tm.tree_leaves(tp))
        assert tr.state.shard.zero1 and tr.state.mu.shape == (total,)
        for extra in (["--mesh_data", "2"], ["--mesh_model", "2"]):
            with pytest.raises(ValueError, match="processes"):
                train_cli.setup_mesh(train_cli.parse_args(["--config", cfg] + extra), "cpu")
    finally:
        dist.destroy_process_group()


def test_entry_points_need_the_card_unless_told(data_root, tmp_path, monkeypatch):
    """Without a card, train_cli and finetune_cli raise unless --device cpu."""
    import yaml

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _yaml(tmp_path / "tiny.yaml", tmp_path / "ckpt")
    raw = yaml.safe_load(open(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.train(raw, None, data_root=str(data_root))
    args = finetune_cli.parse_args(["--dataset_name", "tiny", "--data_root", str(data_root)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_cli.finetune(args, {}, None, {" ": 0})


@pytest.fixture
def tiny_presets(monkeypatch):
    """F5TTS_v1_Base cut to TINY_ARCH in both packages' PRESETS."""
    jp = jconfig.PRESETS["F5TTS_v1_Base"]
    monkeypatch.setitem(jconfig.PRESETS, "F5TTS_v1_Base",
                        dataclasses.replace(jp, arch=jconfig.ModelArch(**TINY_ARCH)))
    tp = tconfig.PRESETS["F5TTS_v1_Base"]
    monkeypatch.setitem(tconfig.PRESETS, "F5TTS_v1_Base",
                        dataclasses.replace(tp, arch=tconfig.ModelArch(**TINY_ARCH)))


def _reference_checkpoint(path, vocab_rows):
    """A reference-key safetensors of a TINY_ARCH DiT with `vocab_rows`
    text-embedding rows (the pretrained vocab + filler)."""
    from f5tts_tpu_torch.train.checkpoint import to_reference_keys, write_safetensors_f32

    arch = jconfig.ModelArch(**dict(TINY_ARCH, text_num_embeds=vocab_rows - 1))
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), arch), 31)
    # bare keys: the JAX loader strips no "ema_model." from a safetensors file
    write_safetensors_f32(to_reference_keys(dit_params_from_jax(tree)), str(path))
    return tree


def test_finetune_cli_full_and_lora_end_to_end(data_root, tmp_path, tiny_presets, monkeypatch):
    ckpt = tmp_path / "pre.safetensors"
    tree = _reference_checkpoint(ckpt, vocab_rows=2000)  # the dataset's vocab is larger
    argv = ["--exp_name", "F5TTS_v1_Base", "--pretrain", str(ckpt), "--dataset_name", "tiny",
            "--data_root", str(data_root), "--batch_size_per_gpu", "300", "--max_samples", "4",
            "--max_updates", "2", "--num_warmup_updates", "2", "--logger", "none",
            "--save_dir", str(tmp_path / "full")]
    import f5tts_tpu.train.trainer as jtrainer

    monkeypatch.setattr(jtrainer, "Trainer", _Spy)
    _Spy.seen.clear()
    from f5tts_tpu.train.finetune_cli import main as jmain

    jmain(argv)
    (jseen,) = _Spy.seen
    args = finetune_cli.parse_args(argv + ["--device", "cpu"])
    vocab, vocab_size, mcfg, arch, backbone, params = finetune_cli.setup(args)
    assert vocab == jseen["vocab_char_map"] and vocab_size == EMILIA_SIZE
    got, want = _common_fields(arch, jseen["arch"])
    assert got == want
    got, want = _common_fields(finetune_cli.train_config(args), jseen["tcfg"])
    assert got == want
    # the pretrained branch: converted, the embedding grown with zero rows
    got_flat, want_flat = _flat(params), _flat(dit_params_from_jax(jseen["params"]))
    assert got_flat.keys() == want_flat.keys()
    assert all(torch.equal(got_flat[k], want_flat[k]) for k in got_flat)
    emb = params["text_embed"]["embed"]["w"]
    assert emb.shape[0] == EMILIA_SIZE + 1 and not emb[2000:].any()
    np.testing.assert_array_equal(_np(emb[:2000]), tree["text_embed"]["embed"]["w"])

    full = finetune_cli.main(argv + ["--device", "cpu"])
    assert full["trainer"].state.step == 2 and os.path.isdir(tmp_path / "full" / "last")

    lora_argv = argv[:-1] + [str(tmp_path / "lora"), "--lora", "--lora_rank", "4",
                             "--save_per_updates", "1", "--device", "cpu"]
    out = finetune_cli.main(lora_argv)
    assert sorted(os.listdir(tmp_path / "lora")) == ["lora_1.pkl", "lora_2.pkl"]
    from f5tts_tpu.train.lora import load_lora as jload_lora

    saved = jload_lora(str(tmp_path / "lora" / "lora_2.pkl"))
    assert saved["attn"]["to_q"]["a"].shape == (2, 128, 4)
    for group, subs in out["lora"].items():
        for name, ab in subs.items():
            for k in ("a", "b"):
                np.testing.assert_array_equal(saved[group][name][k], _np(ab[k]))
    assert np.abs(saved["ff"]["out"]["b"]).sum() > 0 and out["opt_state"].count == 2
    for a, b in zip(tm.tree_leaves(out["step"].base), tm.tree_leaves(params)):
        assert torch.equal(a, b)


def test_expand_text_embedding_matches_jax():
    from f5tts_tpu.train.finetune_cli import expand_text_embedding as jexpand

    rng = np.random.default_rng(2)
    emb = rng.standard_normal((7, 5)).astype(np.float32)
    for new in (4, 6, 9):
        want = jexpand({"text_embed": {"embed": {"w": jnp.asarray(emb)}}, "x": 1}, new)
        got = finetune_cli.expand_text_embedding(
            {"text_embed": {"embed": {"w": torch.from_numpy(emb)}}, "x": 1}, new)
        np.testing.assert_array_equal(_np(got["text_embed"]["embed"]["w"]),
                                      np.asarray(want["text_embed"]["embed"]["w"]))
        assert got["x"] == 1


@pytest.fixture(scope="module")
def sample_models():
    jarch = jconfig.ModelArch(**dict(SMALL, text_num_embeds=40))
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), 41)
    jvcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), jvcfg), 42)
    return jarch, tree, jvcfg, vtree


class _Recorder:
    """Wraps the port's Vocos and keeps each wav it returns."""

    def __init__(self, vocoder):
        self.vocoder, self.wavs = vocoder, []

    def __call__(self, mel):
        wav = self.vocoder(mel)
        self.wavs.append(_np(wav))
        return wav


def test_log_sample_matches_jax_cfm_sample_and_vocos(sample_models, tmp_path):
    from f5tts_tpu.models import cfm as jcfm
    from f5tts_tpu.train.trainer import Trainer as JTrainer
    from f5tts_tpu.utils import make_time_grid as jgrid
    from types import SimpleNamespace

    jarch, tree, jvcfg, vtree = sample_models
    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,'!?0123456")}
    voc = _Recorder(tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**SMALL_VOCOS),
                                 device="cpu"))
    cfg = tconfig.TrainConfig(save_dir=str(tmp_path), logger=None, log_samples=True)
    trainer = Trainer(dit_params_from_jax(tree), tdit.DiTStatics(tconfig.ModelArch(**dict(
        SMALL, text_num_embeds=40))), cfg, vocab_char_map=vocab, tokenizer="char",
        device="cpu", dtype=torch.bfloat16, vocoder=voc)
    rng = np.random.default_rng(9)
    ref = rng.standard_normal((150, 100)).astype(np.float32)
    jax_side = SimpleNamespace(tokenizer="char", vocab_char_map=vocab)
    for text, update in ((list("hi there"), 3), ("a voice.", 5)):
        trainer._last_sample = (ref, text)
        voc.wavs.clear()
        out = trainer._log_sample(update)
        n, total = 512, 300  # duration_bucket(2 * 150): 256-frame buckets
        assert out["mel"].shape == (1, n, 100) and out["mel"].dtype == torch.float32
        doubled = (list(text) + [" "] + list(text) if isinstance(text, list)
                   else text + " " + text)
        ids = JTrainer.tokenize(jax_side, [doubled])
        np.testing.assert_array_equal(trainer.tokenize([doubled]), ids)
        # the port's noise (a CPU generator seeded by the update) as y0
        y0 = tcfm.make_noise(torch.Generator().manual_seed(update), 1, n, 100,
                             torch.tensor([total], dtype=torch.int32))
        cond = np.zeros((1, n, 100), np.float32)
        cond[0, :150] = ref
        want = np.asarray(jcfm.cfm_sample(
            jx(tree), jdit.DiTStatics(jarch), jnp.asarray(cond), jnp.asarray(ids),
            jnp.asarray([150], jnp.int32), jnp.asarray([total], jnp.int32),
            jgrid(32, sway_sampling_coef=-1.0), y0=jnp.asarray(_np(y0)), cfg_strength=2.0,
            dtype=jnp.float32, backend="xla"))
        got = _np(out["mel"])
        np.testing.assert_array_equal(got[0, :150], ref)
        assert _rel(got[0, 150:total], want[0, 150:total]) <= 1e-4
        # the wavs: the JAX Vocos on the same mels
        jv = jvocos.Vocos(jx(vtree), jvcfg)
        for wav, mel in zip(voc.wavs, (got[:, 150:total], ref[None])):
            want_wav = np.asarray(jv(jnp.asarray(mel.transpose(0, 2, 1))))
            assert wav.shape == want_wav.shape and np.abs(wav - want_wav).max() <= 1e-4
        for kind, wav in zip(("gen", "ref"), voc.wavs):
            path = tmp_path / "samples" / f"update_{update}_{kind}.wav"
            assert out[f"{kind}_wav"] == str(path)
            back, sr = audio_io.read_wav(str(path))
            assert sr == 24000 and np.abs(back - np.clip(wav[0], -1, 1)).max() <= 2 / 32767


def test_milestones_call_sample_fn_with_ema_and_write_samples(sample_models, tmp_path):
    from tests.test_torch_train import _tiny_dataset

    _, tree, _, vtree = sample_models
    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,'!?0123456")}
    calls = []
    cfg = tconfig.TrainConfig(batch_size_per_device=400, num_warmup_updates=2,
                              save_dir=str(tmp_path), save_per_updates=2, last_per_updates=1000,
                              logger=None, ema_update_every=1, ema_update_after_step=0,
                              log_samples=True)

    def sample_fn(ema, update):
        calls.append((update, ema is trainer.state.ema, ema["proj_out"]["b"].clone()))

    voc = tvocos.Vocos(vocos_params_from_jax(vtree), tvocos.VocosConfig(**SMALL_VOCOS),
                       device="cpu")
    trainer = Trainer(dit_params_from_jax(tree), tdit.DiTStatics(tconfig.ModelArch(**dict(
        SMALL, text_num_embeds=40))), cfg, vocab_char_map=vocab, tokenizer="char", device="cpu",
        dtype=torch.float32, vocoder=voc, sample_fn=sample_fn)
    trainer.train(_tiny_dataset(), max_updates=4)
    assert [(u, same) for u, same, _ in calls] == [(2, True), (4, True)]
    assert torch.equal(calls[-1][2], trainer.state.ema["proj_out"]["b"])
    assert not torch.equal(calls[0][2], calls[1][2])  # the EMA moved between milestones
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "update_2_gen.wav", "update_2_ref.wav", "update_4_gen.wav", "update_4_ref.wav"]
    mel, text = trainer._last_sample
    assert mel.shape[1] == 100 and isinstance(text, str)
