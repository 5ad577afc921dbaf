"""The port's native segmenter (f5tts_tpu_torch/native/segmenter.{py,cc})
against python jieba (jieba.cut, HMM on) and the JAX package's native
segmenter, and its data files against jieba's.

The port's C++ source follows jieba step for step (blocks of CJK and
ASCII, the prefix DAG, the most probable path, finalseg's Viterbi), so its
cut equals jieba's on mixed ASCII / punctuation / out-of-vocabulary text
too; the JAX package's copy keeps ASCII runs whole and cuts "bank." as one
segment, where jieba cuts "bank" and ".": on those texts the port is held
to jieba, and the JAX copy's departure is recorded as it is.
"""

import gzip
import random
from pathlib import Path

import pytest

jieba = pytest.importorskip("jieba")

from chip_smoke import SEGMENTER_CUTS  # noqa: E402
from f5tts_tpu.native import segmenter as jseg  # noqa: E402
from f5tts_tpu.native.segmenter import _export_hmm  # noqa: E402
from f5tts_tpu_torch.native import segmenter as tseg  # noqa: E402

jieba.setLogLevel(60)
JIEBA_DICT = Path(jieba.__file__).parent / "dict.txt"
# tests/test_segmenter.py's texts: the dictionary path and the HMM path
SEGMENTER_TEXTS = ["我来到北京清华大学", "这是一个分词测试", "对万人敬仰的太乙真人",
                   "他来到了网易杭研大厦", "小明硕士毕业于中国科学院计算所", "这是一个伸手不见五指的黑夜"]
MIXED_TEXTS = [
    "I work at a bank. 不是吗?",
    "我买了一件T恤和AT&T的手机，花了3.14元，涨幅50%。",
    "张三丰和李四光去了乌鲁木齐、呼和浩特",
    "C++和c#都是编程语言；卡拉OK也不错！",
    "hello world\r\nabc123 3.14 x_y-z+w#v&u%",
    "Ünïcode and 中文 mixed ü，「引号」《书名》",
    "王小二和欧阳娜娜在ＡＢＣ公司上班",
    "第1名是张三, 一共3个人",
    "  两个空格\t制表符　全角空格",
    "",
]


def jieba_cut(text):
    return list(jieba.cut(text, HMM=True))


@pytest.mark.parametrize("text", SEGMENTER_TEXTS)
def test_cut_equals_jieba_and_the_jax_native_cut(text):
    assert tseg.cut(text) == jieba_cut(text) == jseg.cut(text)


@pytest.mark.parametrize("text", MIXED_TEXTS)
def test_cut_equals_jieba_on_mixed_text(text):
    assert tseg.cut(text) == jieba_cut(text)


def test_the_jax_native_cut_departs_from_jieba_on_ascii_runs():
    """What the port's copy repairs: the JAX copy keeps an ASCII run with
    its trailing '.' and cannot form a dictionary word of ASCII and CJK."""
    assert jseg.cut("a bank.") == ["a", " ", "bank."]
    assert jieba_cut("a bank.") == tseg.cut("a bank.") == ["a", " ", "bank", "."]
    assert "T恤" in tseg.cut("一件T恤") and "T恤" not in jseg.cut("一件T恤")


def test_cut_equals_jieba_on_seeded_random_text():
    """300 texts from dictionary words, CJK characters of every block,
    ASCII, punctuation and whitespace, seed 0."""
    words = [line.split(" ")[0] for line in JIEBA_DICT.read_text("utf-8").splitlines()]
    rng = random.Random(0)
    pieces = list("，。！？、；：“”‘’（）《》 \t\r\n.,;:!?'\"()-+#&_%0123456789abcXYZ") + [
        "\r\n", "3.14", "50%", "AT&T", "T恤", "C++", "bank.", "Ünïcode", "é", "〇", "　", "\xa0"]
    chars = [chr(rng.randint(0x4E00, 0x9FD5)) for _ in range(200)]
    for _ in range(300):
        parts = []
        for _ in range(rng.randint(1, 12)):
            r = rng.random()
            parts.append(rng.choice(words) if r < 0.5 else rng.choice(pieces) if r < 0.75
                         else rng.choice(chars))
        text = "".join(parts)
        assert tseg.cut(text) == jieba_cut(text), text


def test_the_chip_smoke_literals_are_jiebas_cuts():
    """chip_smoke.py phase 24 holds the card's cuts to these literals."""
    assert list(SEGMENTER_CUTS) == SEGMENTER_TEXTS
    for text, cut in SEGMENTER_CUTS.items():
        assert jieba_cut(text) == cut


def test_bundled_dictionary_is_jiebas_byte_for_byte():
    assert Path(tseg.dict_path()).read_bytes() == JIEBA_DICT.read_bytes()
    assert gzip.decompress(tseg.DICT_GZ.read_bytes()) == JIEBA_DICT.read_bytes()


def test_bundled_hmm_table_is_jiebas(tmp_path):
    """The committed table is what jieba.finalseg's tables give, written as
    the JAX package's `_export_hmm` writes them."""
    assert _export_hmm(str(tmp_path / "hmm.tsv"))
    table = (tmp_path / "hmm.tsv").read_bytes()
    assert Path(tseg.hmm_path()).read_bytes() == table
    assert tseg.hmm_table().encode("utf-8") == table


def test_data_files_are_reproducible(tmp_path):
    tseg.write_data_files(tmp_path)
    for name in (tseg.DICT_GZ.name, tseg.HMM_GZ.name):
        assert (tmp_path / name).read_bytes() == (tseg.DATA_DIR / name).read_bytes()


def test_build_goes_under_build_not_beside_the_source():
    so = Path(tseg.build())
    assert so.parent == tseg.BUILD_DIR and so.parent.name == "f5tts_tpu_torch"
    assert so.parent.parent.name == "build"
    assert not list(Path(tseg.SRC).parent.glob("*.so"))
