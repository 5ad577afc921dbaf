"""The port's scorers (`eval/wavlm.py`, `eval/ecapa_tdnn.py`, `eval/utmos22.py`)
on the CPU against `transformers.WavLMModel` and the JAX package's torch
modules, with numpy-drawn weights (`scripts.common.seeded_state_dict`).

- WavLM at `tests/test_ecapa_load.py`'s tiny config (and an odd positional
  kernel with conv biases): every hidden state within 1e-5 of
  `WavLMModel(output_hidden_states=True)` given the same state dict;
- ECAPA: one UniSpeech-layout checkpoint through both
  `load_reference_checkpoint`s (frac 1.0 each), embeddings within 1e-5,
  `to_reference_state_dict` giving the checkpoint back, an unmapped key
  refused; `run_sim` with the tiny model on both sides;
- UTMOS22 at full size on a 1 s clip at 16 and 24 kHz within 1e-4, and
  both loaders accepting and refusing `tests/test_utmos_offline.py`'s
  checkpoints alike.
"""

import os
import re

import numpy as np
import pytest
import torch

from f5tts_tpu.eval import ecapa_tdnn as jecapa
from f5tts_tpu.eval import utils_eval as jeval
from f5tts_tpu.eval import utmos22 as jutmos
from f5tts_tpu_torch.eval import ecapa_tdnn as tecapa
from f5tts_tpu_torch.eval import utils_eval as teval
from f5tts_tpu_torch.eval import utmos22 as tutmos
from f5tts_tpu_torch.eval.wavlm import WavLM, WavLMConfig
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.scripts.common import seeded_state_dict
from tests.test_ecapa_load import _HEAD_INV, _WAVLM_INV, _inv, _tiny_model
from tests.test_torch_dit import one_torch_thread  # noqa: F401

os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import only costs time here
transformers = pytest.importorskip("transformers")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# test_ecapa_load._tiny_model's WavLM
TINY_WAVLM = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=24, conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2),
                  num_buckets=8, max_bucket_distance=16, num_conv_pos_embeddings=4,
                  num_conv_pos_embedding_groups=2)
TINY_HEAD = dict(feat_dim=16, channels=16, emb_dim=8, num_feature_layers=3)


def _wavs(seed: int, n: int = 1600, b: int = 2) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, n))
                            .astype(np.float32) * 0.3)


@pytest.mark.parametrize("pos_kernel,conv_bias", [(4, False), (5, True)])
def test_wavlm_matches_transformers(pos_kernel, conv_bias):
    cfg = dict(TINY_WAVLM, num_conv_pos_embeddings=pos_kernel, conv_bias=conv_bias)
    hf = transformers.WavLMModel(transformers.WavLMConfig(
        feat_extract_norm="layer", do_stable_layer_norm=True, **cfg)).eval()
    sd = seeded_state_dict(hf, 7)
    hf.load_state_dict(sd)
    port = WavLM(WavLMConfig(**cfg)).eval()
    port.load_state_dict(sd, strict=True)
    wav = _wavs(1)
    with torch.no_grad():
        want = hf(wav, output_hidden_states=True).hidden_states
        got = port(wav)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def _unispeech_checkpoint(seed: int) -> dict:
    """test_ecapa_load's layout from the JAX tiny model's keys, numpy-drawn
    values (positive BN variances), and two pretraining-only tensors."""
    jmodel = _tiny_model()
    sd = {}
    for k, v in seeded_state_dict(jmodel, seed).items():
        if k.startswith("_wavlm."):
            sd["feature_extract.model." + _inv(k[len("_wavlm."):], _WAVLM_INV)] = v
        else:
            sd[_inv(k, _HEAD_INV)] = v
    sd["feature_extract.model.label_embs_concat"] = torch.ones(4, 8)
    sd["feature_extract.model.final_proj.weight"] = torch.ones(8, 16)
    return sd


def _port_tiny():
    return tecapa.ECAPA_TDNN(**TINY_HEAD, wavlm_config=WavLMConfig(**TINY_WAVLM))


def test_ecapa_loads_and_matches_jax(tmp_path):
    sd = _unispeech_checkpoint(8)
    path = tmp_path / "wavlm_finetune.pth"
    torch.save({"model": sd}, path)
    jmodel, port = _tiny_model(), _port_tiny()
    jstats = jecapa.load_reference_checkpoint(jmodel, str(path))
    tstats = tecapa.load_reference_checkpoint(port, str(path))
    assert tstats["frac"] == jstats["frac"] == 1.0
    assert not tstats["unmapped"] and not tstats["unexpected"] and not tstats["missing"]
    assert tstats["dropped"] == jstats["dropped"] and len(tstats["dropped"]) == 2
    back = tecapa.to_reference_state_dict(port)
    kept = {k: v for k, v in sd.items() if k not in tstats["dropped"]}
    assert back.keys() == kept.keys()
    for k, v in kept.items():
        assert torch.equal(back[k], v), k
    jmodel.eval(), port.eval()
    wav = _wavs(2)
    with torch.no_grad():
        want, got = jmodel(wav), port(wav)
    assert got.shape == (2, 8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)

    bad = {(k + ".bogus" if not k.startswith("feature_extract.") else k): v for k, v in sd.items()}
    torch.save({"model": bad}, tmp_path / "bad.pth")
    for mod, model in ((jecapa, _tiny_model()), (tecapa, _port_tiny())):
        with pytest.raises(RuntimeError, match="refusing to score"):
            mod.load_reference_checkpoint(model, str(tmp_path / "bad.pth"))


def test_run_sim_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "sim.pth"
    torch.save({"model": _unispeech_checkpoint(9)}, path)
    monkeypatch.setattr(jecapa, "ECAPA_TDNN_SMALL", lambda **kw: _tiny_model())
    monkeypatch.setattr(tecapa, "ECAPA_TDNN_SMALL", lambda **kw: _port_tiny())
    rng = np.random.default_rng(10)
    pairs = []
    for i, sr in enumerate((24000, 16000)):
        names = [str(tmp_path / f"{k}{i}.wav") for k in ("gen", "ref")]
        for name in names:
            audio_io.write_wav(name, (rng.standard_normal(sr // 5) * 0.2).astype(np.float32), sr)
        pairs.append(tuple(names))
    got = teval.run_sim(pairs, str(path), device="cpu")
    want = jeval.run_sim(pairs, str(path), device="cpu")
    assert [(r["gen"], r["gt"]) for r in got] == [(r["gen"], r["gt"]) for r in want]
    np.testing.assert_allclose([r["sim"] for r in got], [r["sim"] for r in want], atol=1e-5)


@pytest.fixture(scope="module")
def utmos_models():
    """(JAX module, port module): each case loads every parameter anew."""
    return jutmos.UTMOS22Strong().eval(), tutmos.UTMOS22Strong().eval()


@pytest.fixture(scope="module")
def utmos_state(utmos_models):
    return seeded_state_dict(utmos_models[1], 11)


def test_utmos_matches_jax(utmos_state, utmos_models):
    jmodel, port = utmos_models
    port.load_state_dict(utmos_state)
    jmodel.load_state_dict(utmos_state)
    for sr in (16000, 24000):
        t = np.arange(sr) / sr
        wave = torch.from_numpy((0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(
            sr).standard_normal(sr)).astype(np.float32))[None]
        got, want = port(wave, sr), jmodel(wave, sr)
        assert got.shape == (1,) and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _hub_spelling(sd: dict) -> dict:
    hub = {}
    for k, v in sd.items():
        if k in ("domain_emb", "judge_emb"):
            table = torch.zeros(289 if k == "judge_emb" else 2, 128)
            table[288 if k == "judge_emb" else 0] = v
            hub[f"model.{k}.weight"] = table
            continue
        if k.startswith("wav2vec2."):
            k = "ssl_model." + k[len("wav2vec2."):]
            for a, b in ((".encoder.layers.", ".encoder.transformer.layers."),
                         (".attention.", ".self_attn."),
                         (".feed_forward.intermediate_dense.", ".fc1."),
                         (".feed_forward.output_dense.", ".fc2."),
                         (".encoder.feature_projection.projection.", ".post_extract_proj.")):
                k = k.replace(a, b)
            if k.endswith("pos_conv_embed.conv.weight"):
                hub["model." + k + "_g"] = v.norm(dim=(0, 1), keepdim=True)
                hub["model." + k + "_v"] = v.clone()
                continue
        hub["model." + k] = v
    return hub


def _variant(sd: dict, case: str) -> dict:
    sd = dict(sd)
    if case == "drift":
        sd.update({f"unknown_module.layer{i}.weight": torch.zeros(4, 4) for i in range(8)})
    elif case == "partial":
        sd = {k: v for k, v in sd.items() if not k.startswith("blstm")}
    elif case == "weight_norm":
        key = "wav2vec2.encoder.pos_conv_embed.conv.weight"
        w = sd.pop(key)
        sd[key + "_g"], sd[key + "_v"] = w.norm(dim=(0, 1), keepdim=True), w
    elif case == "hub_tables":
        sd["domain_emb.weight"] = sd.pop("domain_emb")[None].repeat(2, 1)
        table = torch.zeros(3000, 128)
        table[288] = sd.pop("judge_emb")
        sd["judge_emb.weight"] = table
    elif case == "hub_spelling":
        sd = _hub_spelling(sd)
    elif case == "short_judge":
        del sd["judge_emb"]
        sd["judge_emb.weight"] = torch.ones(10, 128)
    return sd


@pytest.mark.parametrize("case", ["plain", "drift", "partial", "weight_norm", "hub_tables",
                                  "hub_spelling", "short_judge"])
def test_utmos_loaders_agree(utmos_state, utmos_models, tmp_path, case):
    path = tmp_path / f"{case}.pt"
    torch.save(_variant(utmos_state, case), path)
    outcomes = []
    for mod, model in zip((jutmos, tutmos), utmos_models):
        try:
            outcomes.append((mod.load_checkpoint(model, str(path)), model.state_dict()))
        except RuntimeError as e:
            outcomes.append((re.sub(r"0x[0-9a-f]+", "", str(e)), None))
    path.unlink()
    (jstats, jsd), (tstats, tsd) = outcomes
    assert tstats == jstats
    refused = {"drift": "consumed only", "partial": "unfilled", "short_judge": "mean-listener"}
    if case in refused:
        assert tsd is None and refused[case] in tstats
        return
    assert tstats["consumed"] == tstats["total"]
    for k, v in jsd.items():
        assert torch.equal(tsd[k], v), k
        torch.testing.assert_close(v, utmos_state[k], atol=1e-5, rtol=1e-5)
