"""Reference checkpoints, configs and loaders of the port (f5tts_tpu_torch.compat,
config's YAML loaders, infer.utils_infer) against the JAX package, on the CPU.

State dicts in the reference's key layout are built from numpy-seeded JAX
trees (tests/test_torch_dit.py:np_params): the DiT's through the JAX
`_to_reference_keys`, the UNetT's and Vocos' by the inverse helpers below.
The port's converters must equal `convert.*_params_from_jax` of the JAX
importer's trees bit for bit; the hand-written safetensors reader must equal
`safetensors.numpy.load_file` (cast to f32); the six YAMLs must load to the
JAX package's configs field by field.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from f5tts_tpu import compat as jcompat
from f5tts_tpu import config as jconfig
from f5tts_tpu.compat import torch_import as jimport
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import unett as junett
from f5tts_tpu.train import checkpoint as jckpt
from f5tts_tpu.vocoder import vocos as jvocos
from f5tts_tpu_torch import compat as tcompat
from f5tts_tpu_torch import config as tconfig
from f5tts_tpu_torch.compat import torch_import as timport
from f5tts_tpu_torch.convert import dit_params_from_jax, unett_params_from_jax, vocos_params_from_jax
from f5tts_tpu_torch.infer import utils_infer
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.train import checkpoint as tckpt
from f5tts_tpu_torch.train import step as tstep
from f5tts_tpu_torch.vocoder import vocos as tvocos
from tests.test_torch_dit import SMALL, np_params, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IGNORABLE = {"mel_spec.mel_stft.mel_scale.fb": np.ones((513, 100), np.float32),
             "transformer.rotary_embed.freqs": np.ones((32,), np.float32)}


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lin(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = np.transpose(np.asarray(p["w"]), (2, 1, 0))
    sd[f"{name}.bias"] = np.asarray(p["b"])


def unett_reference_keys(tree, arch) -> dict:
    """A JAX UNetT tree (numpy leaves) in the reference's key layout."""
    sd, t = {}, "transformer"
    _lin(sd, f"{t}.time_embed.time_mlp.0", tree["time_embed"]["mlp1"])
    _lin(sd, f"{t}.time_embed.time_mlp.2", tree["time_embed"]["mlp2"])
    sd[f"{t}.text_embed.text_embed.weight"] = np.asarray(tree["text_embed"]["embed"]["w"])
    _lin(sd, f"{t}.input_embed.proj", tree["input_embed"]["proj"])
    _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.0", tree["input_embed"]["conv_pos"]["conv1"])
    _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.2", tree["input_embed"]["conv_pos"]["conv2"])
    sd[f"{t}.norm_out.weight"] = np.asarray(tree["norm_out"]["w"])
    _lin(sd, f"{t}.proj_out", tree["proj_out"])
    half = arch.depth // 2
    for h, stack in enumerate(("first_half", "second_half")):
        for i in range(half):
            blk = jax.tree.map(lambda a: np.asarray(a)[i], tree[stack])
            b = f"{t}.layers.{h * half + i}"
            sd[f"{b}.1.weight"] = blk["attn_norm"]["w"]
            for name in ("to_q", "to_k", "to_v"):
                _lin(sd, f"{b}.2.{name}", blk["attn"][name])
            _lin(sd, f"{b}.2.to_out.0", blk["attn"]["to_out"])
            if "q_norm" in blk["attn"]:
                sd[f"{b}.2.q_norm.weight"] = blk["attn"]["q_norm"]["w"]
                sd[f"{b}.2.k_norm.weight"] = blk["attn"]["k_norm"]["w"]
            sd[f"{b}.3.weight"] = blk["ff_norm"]["w"]
            _lin(sd, f"{b}.4.ff.0.0", blk["ff"]["in"])
            _lin(sd, f"{b}.4.ff.2", blk["ff"]["out"])
            if "skip_proj" in blk:
                _lin(sd, f"{b}.0", blk["skip_proj"])
    return sd


def vocos_reference_keys(tree, num_layers: int) -> dict:
    """A JAX Vocos tree (numpy leaves) in charactr/vocos-mel-24khz's layout."""
    sd = {}
    _conv(sd, "backbone.embed", tree["embed"])
    sd["backbone.norm.weight"], sd["backbone.norm.bias"] = tree["in_norm_w"], tree["in_norm_b"]
    for i in range(num_layers):
        blk = jax.tree.map(lambda a: np.asarray(a)[i], tree["blocks"])
        p = f"backbone.convnext.{i}"
        _conv(sd, f"{p}.dwconv", blk["dwconv"])
        sd[f"{p}.norm.weight"], sd[f"{p}.norm.bias"] = blk["norm_w"], blk["norm_b"]
        _lin(sd, f"{p}.pwconv1", blk["pw1"])
        _lin(sd, f"{p}.pwconv2", blk["pw2"])
        sd[f"{p}.gamma"] = blk["gamma"]
    sd["backbone.final_layer_norm.weight"] = tree["final_norm_w"]
    sd["backbone.final_layer_norm.bias"] = tree["final_norm_b"]
    _lin(sd, "head.out", tree["head"])
    return sd


DIT_CASES = {"plain": dict(conv_layers=2), "qk_norm": dict(qk_norm="rms_norm", conv_layers=0),
             "long_skip": dict(long_skip_connection=True, conv_layers=2),
             "qk_norm_long_skip": dict(qk_norm="rms_norm", long_skip_connection=True)}


def dit_case(name: str, seed: int = 3):
    """(port arch, JAX arch, numpy JAX tree, its reference-key state dict)."""
    kw = dict(SMALL, **DIT_CASES[name])
    jarch = jconfig.ModelArch(**kw)
    tree = np_params(lambda: jdit.init_dit(jax.random.PRNGKey(0), jarch), seed)
    sd = {k: np.ascontiguousarray(v) for k, v in jckpt._to_reference_keys(tree).items()}
    return tconfig.ModelArch(**kw), jarch, tree, sd


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_dit_importer_matches_jax_and_round_trips(case):
    tarch, jarch, tree, sd = dit_case(case)
    got = tcompat.convert_f5tts_state_dict(sd, tarch)
    want = dit_params_from_jax(_np_tree(jcompat.convert_f5tts_state_dict(sd, jarch)))
    _assert_same_tree(got, want)
    assert ("long_skip" in got) == tarch.long_skip_connection
    assert ("q_norm" in got["blocks"][0]["attn"]) == (tarch.qk_norm == "rms_norm")
    # the export gives every tensor back, qk-norm's and the long skip's too
    back = tckpt.to_reference_keys(got)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.mark.parametrize("skip", ["concat", "add"])
def test_unett_importer_matches_jax(skip):
    kw = dict(SMALL, text_dim=None, conv_layers=0, skip_connect_type=skip,
              qk_norm="rms_norm" if skip == "add" else None)
    jarch = jconfig.ModelArch(**kw)
    tree = np_params(lambda: junett.init_unett(jax.random.PRNGKey(0), jarch), 4)
    sd = unett_reference_keys(tree, jarch)
    got = tcompat.convert_backbone_state_dict(sd, tconfig.ModelArch(**kw), "UNetT")
    want = unett_params_from_jax(_np_tree(jcompat.convert_unett_state_dict(sd, jarch)))
    _assert_same_tree(got, want)
    assert ("skip_proj" in got["second_half"][0]) == (skip == "concat")


def test_vocos_importer_matches_jax():
    cfg = jvocos.VocosConfig(dim=64, intermediate_dim=128, num_layers=2)
    tree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), cfg), 5)
    sd = vocos_reference_keys(tree, 2)
    _assert_same_tree(tcompat.convert_vocos_state_dict(sd, num_layers=2),
                      vocos_params_from_jax(_np_tree(jcompat.convert_vocos_state_dict(sd, 2))))


def test_audit_agrees_with_jax_and_mmdit_raises():
    tarch, jarch, _, sd = dit_case("qk_norm_long_skip")
    sd = dict(sd, **IGNORABLE, initted=np.ones(()), step=np.ones(()))
    sd["transformer.stray.weight"] = np.ones((4, 4), np.float32)
    got, unread = timport.convert_backbone_state_dict_audited(sd, tarch)
    want, j_unread = jimport.convert_backbone_state_dict_audited(sd, jarch)
    assert unread == j_unread == ["transformer.stray.weight"]
    _assert_same_tree(got, dit_params_from_jax(_np_tree(want)))
    for convert in (timport.convert_backbone_state_dict, jimport.convert_backbone_state_dict):
        with pytest.raises(NotImplementedError, match="MMDiT"):
            convert(sd, tarch, "MMDiT")


def test_long_skip_weight_follows_the_arch(tmp_path):
    """The arch decides whether the DiT has a long skip: the weight under an
    arch without the flag is an unread key, and the flag without the weight
    is a missing key, never a model that runs without its skip."""
    tarch, _, _, sd = dit_case("long_skip")
    plain = dataclasses.replace(tarch, long_skip_connection=False)
    got, unread = timport.convert_backbone_state_dict_audited(sd, plain)
    assert unread == ["transformer.long_skip_connection.weight"] and "long_skip" not in got
    path = str(tmp_path / "model.safetensors")
    tckpt.write_safetensors_f32(sd, path)
    with pytest.raises(ValueError, match="long_skip_connection"):
        utils_infer.load_checkpoint(plain, path, device="cpu")
    no_skip = {k: v for k, v in sd.items() if "long_skip" not in k}
    with pytest.raises(KeyError, match="long_skip_connection"):
        timport.convert_f5tts_state_dict(no_skip, tarch)


def test_extract_ema_state_dict_matches_jax():
    a, b = np.arange(3, dtype=np.float32), np.ones((2, 2), np.float32)
    layouts = (
        {"ema_model_state_dict": {"ema_model.x.weight": a, "ema_model.y": b, "initted": a,
                                  "ema_model.step": a}, "step": 3},
        {"model_state_dict": {"x.weight": a, "y": b}, "optimizer_state_dict": {}},
        {"ema_model.x.weight": a, "ema_model.y": b, "initted": a, "step": a})
    for ckpt in layouts:
        got, want = timport.extract_ema_state_dict(ckpt), jimport.extract_ema_state_dict(ckpt)
        assert list(got) == list(want) == ["x.weight", "y"]
        for k in want:
            assert got[k] is want[k]


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_matches_the_package(dtype, tmp_path):
    import ml_dtypes
    from safetensors.numpy import load_file, save_file

    npdt = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16}[dtype]
    rng = np.random.default_rng(6)
    tensors = {"transformer.a.weight": rng.standard_normal((5, 7)), "b": rng.standard_normal((3,)),
               "scalar": np.array(2.5), "empty": np.zeros((0, 4))}
    path = str(tmp_path / "x.safetensors")
    save_file({k: v.astype(npdt) for k, v in tensors.items()}, path, metadata={"format": "pt"})
    want = load_file(path)
    got = timport.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v.astype(np.float32))
    # an EMA export's prefix is stripped, as the reference's load_checkpoint does
    tckpt.write_safetensors_f32({"ema_model.x": tensors["b"]}, str(tmp_path / "ema.safetensors"))
    assert list(timport.load_torch_checkpoint(str(tmp_path / "ema.safetensors"))) == ["x"]


def test_pt_checkpoint_matches_jax_loader(tmp_path):
    rng = np.random.default_rng(7)
    sd = {f"ema_model.w{i}": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
          for i in range(3)}
    sd["ema_model.h"] = sd["ema_model.w0"].to(torch.bfloat16)
    path = str(tmp_path / "model.pt")
    torch.save({"ema_model_state_dict": dict(sd, initted=torch.ones(1), step=torch.ones(1))}, path)
    got, want = timport.load_torch_checkpoint(path), jimport.load_torch_checkpoint(path)
    assert list(got) == list(want) == ["w0", "w1", "w2", "h"]
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k].float())


def _on_port_fields(port, jax_cfg) -> tuple:
    """(port's asdict, JAX's asdict cut to the port's fields, nested too): the
    JAX arch's attn_backend, attn_mask_enabled and context_dim select nothing
    in the port, which drops them on load."""
    def cut(t, j):
        assert set(t) <= set(j), sorted(set(t) - set(j))
        return {k: cut(t[k], j[k]) if isinstance(t[k], dict) else j[k] for k in t}

    t = dataclasses.asdict(port)
    return t, cut(t, dataclasses.asdict(jax_cfg))


def test_yaml_configs_match_jax():
    jdir = os.path.join(REPO, "f5tts_tpu", "configs")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tconfig.CONFIG_DIR)) and len(names) == 6
    import yaml

    for name in names:
        tpath, jpath = os.path.join(tconfig.CONFIG_DIR, name), os.path.join(jdir, name)
        with open(tpath, "rb") as a, open(jpath, "rb") as b:
            assert a.read() == b.read(), name
        got, want = _on_port_fields(tconfig.load_model_config(tpath),
                                    jconfig.load_model_config(jpath))
        assert got == want, name
        with open(tpath, encoding="utf-8") as f:
            raw = yaml.safe_load(f)
        assert dataclasses.asdict(tconfig.train_config_from_dict(raw)) == \
            dataclasses.asdict(jconfig.train_config_from_dict(raw)), name
    extra = {"model": {"name": "x", "backbone": "UNetT", "arch": {
        "dim": 256, "long_skip_connection": True, "text_embedding_average_upsampling": True,
        "checkpoint_activations": True, "remat_policy": "attn_out", "attn_backend": "xla",
        "attn_mask_enabled": True, "context_dim": 64, "unknown_key": 1}}}
    got, want = _on_port_fields(tconfig.model_config_from_dict(extra),
                                jconfig.model_config_from_dict(extra))
    assert got == want
    assert dataclasses.asdict(tconfig.train_config_from_dict({})) == \
        dataclasses.asdict(jconfig.train_config_from_dict({}))
    for name in ("F5TTS_v1_Base", "E2TTS_Small", "MMDiT_Base"):
        got, want = _on_port_fields(tconfig.get_preset(name, tokenizer="char"),
                                    jconfig.get_preset(name, tokenizer="char"))
        assert got == want
    with pytest.raises(ValueError, match="remat_policy"):
        tconfig.ModelArch(remat_policy="everything")


def test_load_model_checkpoint_and_vocoder(tmp_path):
    import yaml

    tarch, _, _, sd = dit_case("qk_norm_long_skip")
    vocab = dict(utils_infer.load_vocab(os.path.join(REPO, "f5tts_tpu_torch", "data",
                                                     "vocab_emilia_pinyin.txt")))
    letters = " abcdefghijklmnopqrstuvwxyz.,'!?"
    assert len(letters) == tarch.text_num_embeds and len(vocab) > len(letters)
    (tmp_path / "vocab.txt").write_text("".join(c + "\n" for c in letters), encoding="utf-8")
    arch_d = {k: v for k, v in dataclasses.asdict(tarch).items() if k != "text_num_embeds"}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(
        {"model": {"name": "tiny", "backbone": "DiT", "tokenizer": "char", "arch": arch_d}}))
    path = str(tmp_path / "model.safetensors")
    tckpt.write_safetensors_f32({"ema_model." + k: v for k, v in dict(sd, **IGNORABLE).items()},
                                path)
    want = tcompat.convert_f5tts_state_dict(sd, tarch)
    _assert_same_tree(utils_infer.load_checkpoint(tarch, path, device="cpu"), want)
    loaded = utils_infer.load_model(str(tmp_path / "tiny.yaml"), ckpt_path=path,
                                    vocab_file=str(tmp_path / "vocab.txt"), device="cpu")
    assert loaded.config.arch == tarch and loaded.dtype == torch.float32
    _assert_same_tree(loaded.params, want)
    # a weight the converter does not read is an error, not a silent drop
    tckpt.write_safetensors_f32(dict(sd, **{"transformer.stray.weight": np.ones(2)}), path)
    with pytest.raises(ValueError, match="stray"):
        utils_infer.load_checkpoint(tarch, path, device="cpu")
    # the port's own checkpoint directory: its EMA params
    state = tstep.init_train_state(want)
    tckpt.CheckpointManager(str(tmp_path / "ck")).save(state)
    _assert_same_tree(utils_infer.load_checkpoint(tarch, str(tmp_path / "ck"), device="cpu"),
                      state.ema)
    # random weights from the generator the loader is given
    fresh = utils_infer.load_model(str(tmp_path / "tiny.yaml"), vocab_file=str(tmp_path / "vocab.txt"),
                                   device="cpu", generator=torch.Generator().manual_seed(4))
    from f5tts_tpu_torch.models import dit as tdit

    _assert_same_tree(fresh.params, tdit.init_dit(torch.Generator().manual_seed(4), tarch))
    # a full-size Vocos from a .bin state dict, and one from the default seed
    cfg = jvocos.VocosConfig()
    vtree = np_params(lambda: jvocos.init_vocos(jax.random.PRNGKey(0), cfg), 8)
    vsd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for k, v in vocos_reference_keys(vtree, cfg.num_layers).items()}
    torch.save(vsd, str(tmp_path / "pytorch_model.bin"))
    voc = utils_infer.load_vocoder("vocos", True, str(tmp_path / "pytorch_model.bin"), device="cpu")
    _assert_same_tree(voc.params, vocos_params_from_jax(_np_tree(jcompat.convert_vocos_state_dict(
        {k: v.numpy() for k, v in vsd.items()}))))
    rand = utils_infer.load_vocoder(device="cpu")
    assert isinstance(rand, tvocos.Vocos)
    _assert_same_tree(rand.params, tvocos.init_vocos(torch.Generator().manual_seed(1),
                                                     tvocos.VocosConfig()))


def test_config_imports_without_yaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from f5tts_tpu_torch import config\n"
            "assert config.get_preset('F5TTS_v1_Base').arch.depth == 22\n"
            "try:\n    config.load_model_config(config.CONFIG_DIR + '/F5TTS_v1_Base.yaml')\n"
            "except ImportError as e:\n    assert 'PyYAML' in str(e); print('raised')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "raised", out.stdout + out.stderr
