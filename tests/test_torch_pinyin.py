"""The port's pinyin tokenizer (f5tts_tpu_torch.text.pinyin, text.vocab)
against the JAX package's (f5tts_tpu.text.pinyin, text.vocab) on the CPU.

Exact equality throughout: token lists, ids, vocab maps and data bytes.
Both sides run their bundled tables (pypinyin pinned absent on both, as
tests/test_pinyin_bundled.py pins it for the JAX module). The segmenter:
both defaults (here jieba on the port's side; the JAX package's native
segmenter cuts as jieba does, tests/test_segmenter.py), and both forced to
one character at a time, the port's fallback where jieba is missing (the
card's machine): the port's by hiding `jieba`, the JAX module's by a
monkeypatched `segment`.
"""

import filecmp
import os
import sys

import jax
import numpy as np
import pytest

from f5tts_tpu.text import pinyin as jp
from f5tts_tpu.text import vocab as jv
from f5tts_tpu_torch.text import pinyin as tp
from f5tts_tpu_torch.text import vocab as tv
from tests.test_torch_dit import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 不 before tone 4 and not; 一 before tones 1-4, in 看一看 and 第一; chains of
# third tones; heteronym and neutral-suffix words; a compound by longest
# match; 鱻 and 龘, missing from the bundled table
G2P_CASES = ["不是", "不要不好", "一天", "一年", "一起", "一个", "看一看", "第一名", "你好",
             "我很好", "展览馆", "我也想买好酒", "在银行上班", "重庆火锅", "听音乐会",
             "孩子长大了", "桌子上有石头", "处理结果", "我们是朋友", "鱻龘", "一不小心"]
TEXTS = ["Hello there, this is plain ASCII; with a semicolon.",
         "今天天气很好我们一起去公园散步",
         "我在银行工作, I work at a bank. 不是吗?",
         "他说：“你好”；她说‘再见’。",
         "第1名是张三, 一共3个人",
         "Ünïcode and 中文 mixed ü"]


@pytest.fixture(autouse=True)
def bundled_tables(monkeypatch):
    """Both sides on the bundled tables, their dictionary state restored
    after the test."""
    for mod in (jp, tp):
        monkeypatch.setattr(mod, "_pypinyin", lambda: None)
        monkeypatch.setattr(mod, "_pinyin_dict", None)
        monkeypatch.setattr(mod, "_pinyin_words", None)
    monkeypatch.delenv("F5TTS_PINYIN_DICT", raising=False)


@pytest.mark.parametrize("segment", G2P_CASES)
def test_g2p_matches_jax(segment):
    assert tp.g2p(segment) == jp.g2p(segment)


def test_convert_char_to_pinyin_default_segmenters_match_jax():
    assert tp.segmenter_name() in ("jieba", "per-char")
    assert tp.convert_char_to_pinyin(TEXTS) == jp.convert_char_to_pinyin(TEXTS)
    assert tp.convert_char_to_pinyin(TEXTS, polyphone=False) == \
        jp.convert_char_to_pinyin(TEXTS, polyphone=False)


def test_convert_char_to_pinyin_per_char_matches_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jieba", None)  # `import jieba` raises ImportError
    tp._segmenter.cache_clear()
    try:
        assert tp.segmenter_name() == "per-char"
        monkeypatch.setattr(jp, "segment", lambda text: list(text))
        assert tp.convert_char_to_pinyin(TEXTS) == jp.convert_char_to_pinyin(TEXTS)
    finally:
        tp._segmenter.cache_clear()


def test_pinyin_dict_overlays_match_jax(tmp_path, monkeypatch):
    user = tmp_path / "user.tsv"
    user.write_text("好\thao4\n鱻\txian1\n\tbad\nshort\n", encoding="utf-8")
    texts = ["你好鱻", "我很好"]
    base = tp.convert_char_to_pinyin(texts)
    for mod in (jp, tp):
        mod.set_pinyin_dict(str(user))
    got = tp.convert_char_to_pinyin(texts)
    assert got == jp.convert_char_to_pinyin(texts) and got != base
    assert "xian1" in got[0]
    # the environment overlay, read when the table is first built
    monkeypatch.setenv("F5TTS_PINYIN_DICT", str(user))
    for mod in (jp, tp):
        monkeypatch.setattr(mod, "_pinyin_dict", None)
    assert tp.convert_char_to_pinyin(texts) == jp.convert_char_to_pinyin(texts) == got


def test_is_chinese_and_passthrough_match_jax(monkeypatch):
    for c in ("a", "中", "㄀", "鿿", "〇", "ｱ", "가", "、"):
        assert tp.is_chinese(c) == jp.is_chinese(c), c
    for mod in (jp, tp):  # no G2P backend: Chinese passes through
        monkeypatch.setattr(mod, "_pinyin_dict", {})
        monkeypatch.setattr(mod, "_pinyin_words", {})
    assert tp.g2p("你好") == jp.g2p("你好") == ["你", "好"]


def test_data_files_and_load_vocab_match_jax():
    pairs = [("f5tts_tpu/data/vocab_emilia_pinyin.txt", "f5tts_tpu_torch/data/vocab_emilia_pinyin.txt")]
    for name in ("pinyin_char_tone3.tsv", "pinyin_words_tone3.tsv"):
        pairs.append((f"f5tts_tpu/text/data/{name}", f"f5tts_tpu_torch/text/data/{name}"))
    for a, b in pairs:
        assert filecmp.cmp(os.path.join(REPO, a), os.path.join(REPO, b), shallow=False), b
    assert os.path.samefile(tv.EMILIA_VOCAB, os.path.join(REPO, pairs[0][1]))
    vocab = tv.load_vocab(tv.EMILIA_VOCAB)
    assert vocab == jv.load_vocab(os.path.join(REPO, pairs[0][0]))
    assert vocab[" "] == 0 and len(vocab) == 2545
    tokens = tp.convert_char_to_pinyin(TEXTS)
    np.testing.assert_array_equal(tv.list_str_to_idx(tokens, vocab),
                                  jv.list_str_to_idx(tokens, vocab))


def test_get_tokenizer_matches_jax(tmp_path):
    root = tmp_path / "data"
    (root / "Emilia_pinyin").mkdir(parents=True)
    (root / "Emilia_pinyin" / "vocab.txt").write_bytes(open(tv.EMILIA_VOCAB, "rb").read())
    for args in (("Emilia", "pinyin", str(root)), (tv.EMILIA_VOCAB, "custom", None),
                 ("x", "byte", None)):
        got, want = tv.get_tokenizer(*args), jv.get_tokenizer(*args)
        assert got[1] == want[1] and got[0] == want[0], args
    with pytest.raises(ValueError, match="unknown tokenizer"):
        tv.get_tokenizer("x", "phoneme")


def test_pipeline_pinyin_tokenize_matches_jax():
    """The pipeline's default tokenizer is pinyin on both sides."""
    import jax.numpy as jnp
    import torch

    from f5tts_tpu.infer import pipeline as jpipe
    from f5tts_tpu.models import dit as jdit
    from f5tts_tpu.vocoder import vocos as jvocos
    from f5tts_tpu_torch.infer import pipeline as tpipe
    from f5tts_tpu_torch.models import dit as tdit
    from f5tts_tpu_torch.vocoder import vocos as tvocos
    from tests.test_torch_dit import jx, small_dit
    from tests.test_torch_vocos_mel import SMALL_VOCOS

    jarch, tarch, tree, params = small_dit()
    vocab = tv.load_vocab(tv.EMILIA_VOCAB)
    port = tpipe.InferencePipeline(
        params, tdit.DiTStatics(tarch),
        tvocos.Vocos(tvocos.init_vocos(torch.Generator(), tvocos.VocosConfig(**SMALL_VOCOS)),
                     tvocos.VocosConfig(**SMALL_VOCOS), device="cpu"),
        vocab, dtype=torch.float32, device="cpu")
    jcfg = jvocos.VocosConfig(**SMALL_VOCOS)
    jax_pipe = jpipe.InferencePipeline(jx(tree), jdit.DiTStatics(jarch),
                                       jvocos.Vocos(jvocos.init_vocos(jax.random.PRNGKey(0), jcfg),
                                                    jcfg), vocab, dtype=jnp.float32, backend="xla")
    assert port.tokenizer == jax_pipe.tokenizer == "pinyin"
    texts = ["参考文本。" + TEXTS[2], TEXTS[3]]
    np.testing.assert_array_equal(port.tokenize(texts), jax_pipe.tokenize(texts))
    with pytest.raises(ValueError, match="unknown tokenizer"):
        tpipe.InferencePipeline(params, port.statics, port.vocoder, device="cpu",
                                tokenizer="phoneme")
