"""The port's tokenizer.json reader and HFTokenizer against the JAX
package's HFTokenizer (the ``tokenizers`` library) on the same files.

The files are trained here with ``tokenizers`` on seeded Persian text:
WordPiece behind BertNormalizer (cased and lowercased), Unigram behind a
Precompiled + Replace normalizer and Metaspace, and byte-level BPE with
the Llama-3 split. Ids, batches and decoded text must be equal. The
Precompiled charsmaps are built by chip_smoke.py's double-array builder
(`build_charsmap`, the one that writes the card's tokenizer.json), and
the port's normalizer must equal ``tokenizers``' on them.
"""
import json

import numpy as np
import pytest
from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    processors,
    trainers,
)

import chip_smoke
from chip_smoke import build_charsmap
from persian_rag_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer

from persian_rag_tpu_torch.models import tokenizer_json as tj
from persian_rag_tpu_torch.models.tokenizer import HFTokenizer

WORDS = (
    "دارو درمان بیماری پزشک بیمارستان سلامت قلب خون فشار دیابت سرطان "
    "ویروس واکسن کودک مادر تغذیه ورزش خواب درد سر معده کبد کلیه ریه "
    "عفونت آنتی‌بیوتیک قرص شربت آمپول جراحی آزمایش تشخیص علائم نشانه "
    "می‌شود می‌کند نمی‌توان کتابِ كتاب يك یک ۱۲۳ ١٢٣ است و در به از که "
    "the doctor's patients don't know they're café naïve I'll we've"
).split()

# text with every case the readers must agree on
TEXTS = [
    "",
    "دارو برای درمان سردرد چیست",
    "می‌شود و نمی‌توان",                      # ZWNJ
    "کِتابِ پزشکیٌ بَرایِ بیمارْ",              # harakat U+064B-U+0652
    "يك كتاب و یک کتاب",                      # Arabic and Persian yeh / kaf
    "سال ۱۴۰۲ و ١٤٠٢ و 2023",                 # Persian, Arabic-Indic digits
    "خط اول\r\nخط دوم\n\n  سوم\t\tچهارم   ",    # \r\n, whitespace runs
    "درمان \U0001f637 سریع \U0001f468\u200d\U0001f469\u200d\U0001f467 "
    "\U0001f1ee\U0001f1f7",                            # emoji
    "واژه " + "ب" * 130 + " پایان",            # past max_input_chars_per_word
    "I'm sure they'RE here; we'll see, don't we? IT'S OK",
    "café naïve ＡＢＣ１２３ ﬁne 中文字",        # accents, full-width, CJK
    "<s> دارو </s> <mask> بیمار",              # added tokens in text
    "  leading and trailing spaces  ",
    "\u200cآغاز با نیم\u200cفاصله\u200c",
]


def corpus(n=400, seed=0):
    rng = np.random.default_rng(seed)
    words = np.asarray(WORDS)
    return [" ".join(words[rng.integers(0, len(words), rng.integers(4, 16))])
            for _ in range(n)]


CHARSMAP_RULES = {
    **{chr(0xFF10 + i): str(i) for i in range(10)},  # full-width digits
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
    "\ufb01": "fi",                # the ligature fi -> two letters
    "\u064a": "\u06cc",             # Arabic yeh -> Persian
    "\u0643": "\u06a9",             # Arabic kaf -> Persian
    "e\u0301": "\u00e9",            # keys of several characters
    "\u0627\u0653": "\u0622",
    "\u200b": " ",
    "\u0661": "1", "\u0662": "2",
}


def test_precompiled_equals_tokenizers():
    blob = build_charsmap(CHARSMAP_RULES)
    ref = normalizers.Precompiled(blob)
    got = tj.Precompiled(blob)
    cases = TEXTS + [
        "e\u0301 e\u0301\u0301 e\u0301\u0301\u0301",
        "\u0661\u064e \u0661\u064e\u064e \u0600 \u0661",
        "\u0627\u0653\u0628", "x\u200by", "\u064a\u064e\u0643",
        "\ufb01\u0301", "\u0661\u0662\u0663 \u06f1\u06f2\u06f3",
    ]
    # a grapheme under 6 bytes takes the shortest key that prefixes it;
    # a longer one is mapped character by character
    assert got("\ufb01\u0301 \uff11\u0301 \uff11\u0301\u0301") == (
        "fi 1 1\u0301\u0301")
    for text in cases:
        assert got(text) == ref.normalize_str(text), text


def test_chip_smoke_charsmap_equals_tokenizers():
    blob = build_charsmap(chip_smoke.CHARSMAP_RULES)
    ref = normalizers.Precompiled(blob)
    got = tj.Precompiled(blob)
    for text in TEXTS + ["\u064a\u0643 \u0627\u0653 \uff11\uff12"]:
        assert got(text) == ref.normalize_str(text), text
    assert got("\u064a\u0643 \uff11") == "\u06cc\u06a9 1"


def test_graphemes_equal_regex():
    regex = pytest.importorskip("regex")
    for text in TEXTS:
        assert tj.graphemes(text) == regex.findall(r"\X", text), text


# -- tokenizer files ----------------------------------------------------------


def _wordpiece(path, lowercase):
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]",
                                     max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(
        clean_text=True, handle_chinese_chars=True, strip_accents=None,
        lowercase=lowercase)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    tok.train_from_iterator(corpus(), trainers.WordPieceTrainer(
        vocab_size=600, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                        "[MASK]"]))
    cls_id, sep_id = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    if lowercase:
        tok.post_processor = processors.BertProcessing(
            ("[SEP]", sep_id), ("[CLS]", cls_id))
    else:
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]",
            special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)])
    tok.save(str(path))


def _unigram(path, truncate):
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(build_charsmap(CHARSMAP_RULES)),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(corpus(), trainers.UnigramTrainer(
        vocab_size=500, unk_token="<unk>",
        special_tokens=["<s>", "<pad>", "</s>", "<unk>"]))
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, special=True)])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>",
        special_tokens=[("<s>", tok.token_to_id("<s>")),
                        ("</s>", tok.token_to_id("</s>"))])
    if truncate:  # sentence-transformers files carry both
        tok.enable_truncation(max_length=12)
        tok.enable_padding(pad_id=tok.token_to_id("<pad>"), pad_token="<pad>",
                           length=16)
    tok.save(str(path))


def _llama3_bpe(path):
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(tj.LLAMA3_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=800, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>",
                        "<|eot_id|>"]))
    tok.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A",
        special_tokens=[("<|begin_of_text|>",
                         tok.token_to_id("<|begin_of_text|>"))])
    tok.save(str(path))


BUILDERS = {
    "wordpiece_cased": lambda p: _wordpiece(p, False),
    "wordpiece_lower": lambda p: _wordpiece(p, True),
    "unigram": lambda p: _unigram(p, False),
    "unigram_trunc_pad": lambda p: _unigram(p, True),
    "bpe_llama3": _llama3_bpe,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    out = {}
    for name, build in BUILDERS.items():
        path = root / f"{name}.json"
        build(path)
        out[name] = str(path)
    return out


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_reader_ids_equal_tokenizers(files, name):
    ref = Tokenizer.from_file(files[name])
    got = tj.TokenizerJSON.from_file(files[name])
    for text in TEXTS:
        for special in (True, False):
            assert got.encode(text, special) == ref.encode(
                text, add_special_tokens=special).ids, (text, special)
    assert got.encode_batch(TEXTS) == [e.ids for e in ref.encode_batch(TEXTS)]
    for text in TEXTS:
        ids = ref.encode(text).ids
        for skip in (True, False):
            assert got.decode(ids, skip) == ref.decode(
                ids, skip_special_tokens=skip), (text, skip)
    ids = list(range(ref.get_vocab_size() + 3))  # every id, some past the end
    assert got.decode(ids, False) == ref.decode(ids, skip_special_tokens=False)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_hf_tokenizer_equals_jax(files, name):
    ref, got = JaxHFTokenizer(files[name]), HFTokenizer(files[name])
    assert (got.pad_id, got.bos_id, got.eos_id) == (
        ref.pad_id, ref.bos_id, ref.eos_id)
    for max_len in (8, 256):
        ids, mask = got.encode_batch(TEXTS, max_len)
        rids, rmask = ref.encode_batch(TEXTS, max_len)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(mask, rmask)
    for text in TEXTS:
        for bos in (True, False):
            assert got.encode(text, add_bos=bos) == ref.encode(text, add_bos=bos)
        ids = ref.encode(text)
        assert got.decode(ids) == ref.decode(ids)


def test_directory_without_tokenizer_json_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        HFTokenizer(str(tmp_path))


@pytest.mark.parametrize("part, spec", [
    ("normalizer", {"type": "NmtNormalizer"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"},
                       "behavior": "Isolated", "invert": False}),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False,
                       "trim_offsets": True, "use_regex": True}),
    ("decoder", {"type": "CTC"}),
    ("decoder", {"type": "Sequence", "decoders": []}),
    ("normalizer", {"type": "NFKC"}),
    ("normalizer", {"type": "Replace", "pattern": {"Regex": r"\s+"},
                    "content": " "}),
    ("post_processor", {"type": "Unknown"}),
])
def test_unknown_component_raises(files, part, spec):
    with open(files["bpe_llama3"], encoding="utf-8") as f:
        data = json.load(f)
    data[part] = spec
    with pytest.raises(NotImplementedError, match=spec["type"]):
        tj.TokenizerJSON(data)
