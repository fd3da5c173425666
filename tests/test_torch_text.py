"""The port's text layer against the JAX package's.

`normalize_text`, `tokenize_words`, `tokenize_sentences` and
`fold_persian_digits` on hypothesis-drawn Persian, Arabic and Latin
strings with digits, punctuation, diacritics and whitespace; both chunking
modes (records and statistics); `extract_pdf_text` on PDFs written here
(Flate and raw streams, escaped literals, TJ arrays, hex and UTF-16BE
strings); and the chunk CSVs: `save_chunks` writes pandas' bytes on str /
int columns (the JAX `save_chunks` is pandas), and `load_chunks` gives
pandas' records.
"""
import zlib

import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from persian_rag_tpu.text import chunking as jchunking
from persian_rag_tpu.text import pdf as jpdf
from persian_rag_tpu.text import persian as jpersian
from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.text import chunking as tchunking
from persian_rag_tpu_torch.text import pdf as tpdf
from persian_rag_tpu_torch.text import persian as tpersian

ALPHABET = (
    list("ابپتثجچحخدذرزژسشصضطظعغفقکگلمنوهیآ")
    + list("يىكؤةأإ")  # Arabic forms folded to Persian
    + ["ً", "َ", "ِ", "ّ", "ٰ", "ـ"]  # marks
    + list("abcXYZé")
    + list("0123456789۰۱۲۳۴۵۶۷۸۹٠١٢٣")
    + list(".!?؟…⸮,،؛:;()[]«»\"'-/")
    + [" ", "  ", "\n", "\n\n", "\t", "‌", " "]
)
TEXT = st.lists(st.sampled_from(ALPHABET), max_size=80).map("".join)


@settings(max_examples=300, deadline=None)
@given(TEXT)
def test_text_processor_equals_jax(text):
    tp, jp = tpersian.PersianTextProcessor(), jpersian.PersianTextProcessor()
    assert tp.normalize_text(text) == jp.normalize_text(text)
    assert tp.tokenize_words(text) == jp.tokenize_words(text)
    assert tp.tokenize_sentences(text) == jp.tokenize_sentences(text)
    assert tpersian.fold_persian_digits(text) == \
        jpersian.fold_persian_digits(text)


CFG = {"chunking": {"word_chunk_size": 30, "word_overlap": 5,
                    "sentences_per_chunk": 3}}


def _document(seed, n_sentences=120):
    import random

    r = random.Random(seed)
    words = ["دارو", "قلب", "كبد", "ويتامين", "درمان", "بیماری", "۱۲", "mg",
             "روز", "پزشک", "آسپرین", "می‌شود"]
    ends = [".", "!", "؟", "?", "…", ""]
    return "\n".join(
        " ".join(r.choice(words) for _ in range(r.randint(1, 14)))
        + r.choice(ends) for _ in range(n_sentences))


@pytest.mark.parametrize("mode", ["auto", "simple"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunking_equals_jax(mode, seed):
    text = _document(seed)
    tc = tchunking.TextChunker(CFG, sentence_split_mode=mode)
    jc = jchunking.TextChunker(CFG, sentence_split_mode=mode)
    words, sentences = tc.process_pdf_document(text)
    jwords, jsentences = jc.process_pdf_document(text)
    assert words == jwords and sentences == jsentences
    assert len(words) > 3 and len(sentences) > 3
    for got, want in ((words, jwords), (sentences, jsentences)):
        assert tc.get_chunk_statistics(got) == jc.get_chunk_statistics(want)
    # streaming words across segment seams
    assert list(tc._iter_words(text, segment_chars=97)) == list(
        jc._iter_words(text, segment_chars=97))
    assert tc.process_pdf_document("کوتاه") == ([], [])
    assert tc.get_chunk_statistics([]) == {}


def test_config_object_drives_the_chunker():
    cfg = Config()
    cfg.chunking.word_chunk_size = 20
    cfg.chunking.word_overlap = 4
    text = _document(5)
    assert tchunking.TextChunker(cfg).word_based_chunking(text) == \
        jchunking.TextChunker({"chunking": {
            "word_chunk_size": 20, "word_overlap": 4,
            "sentences_per_chunk": 5}}).word_based_chunking(text)


def _pdf(tmp_path, name, streams, compress):
    """A minimal PDF with one page per content stream."""
    objects = [b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n"]
    kids = " ".join(f"{3 + 2 * i} 0 R" for i in range(len(streams)))
    objects.append(f"2 0 obj << /Type /Pages /Kids [{kids}] /Count "
                   f"{len(streams)} >> endobj\n".encode())
    for i, content in enumerate(streams):
        page, body = 3 + 2 * i, 4 + 2 * i
        data = zlib.compress(content) if compress else content
        filt = b"/Filter /FlateDecode " if compress else b""
        objects.append(f"{page} 0 obj << /Type /Page /Parent 2 0 R "
                       f"/Contents {body} 0 R >> endobj\n".encode())
        objects.append(f"{body} 0 obj << ".encode() + filt
                       + f"/Length {len(data)} >> stream\n".encode() + data
                       + b"\nendstream endobj\n")
    path = tmp_path / name
    path.write_bytes(b"%PDF-1.4\n" + b"".join(objects) + b"%%EOF\n")
    return str(path)


def _utf16_hex(text, bom=True):
    data = (b"\xfe\xff" if bom else b"") + text.encode("utf-16-be")
    return b"<" + data.hex().upper().encode() + b">"


STREAMS = [
    b"BT /F1 12 Tf 72 720 Td (Hello drug \\(information\\) world) Tj ET",
    b"BT (line\\nbreak\\ttab \\\\ back) Tj 0 -14 Td (octal \\101\\102\\7) Tj "
    b"[(Kerned) -250 (TJ) 120 (array)] TJ ET",
    # hex strings are read inside TJ arrays (a bare <hex> Tj is not, in
    # either package)
    b"BT [<48656C6C6F20686578> -120 " + _utf16_hex("دارو درمان") + b"] TJ "
    b"[" + _utf16_hex("Ab", bom=False) + b"] TJ <4E6F> Tj ET",
    b"BT (" + "قلب و کبد".encode("utf-8") + b") Tj ' ("
    + "ویتامین".encode("utf-8") + b") Tj ET",
    b"q 1 0 0 1 0 0 cm Q",  # no text
]


@pytest.mark.parametrize("compress", [False, True])
def test_pdf_text_equals_jax(compress, tmp_path):
    path = _pdf(tmp_path, f"doc{compress}.pdf", STREAMS, compress)
    got = tpdf.extract_pdf_text(path)
    assert got == jpdf.extract_pdf_text(path)
    for piece in ("Hello drug (information) world", "back", "octal AB",
                  "Kerned", "array", "Hello hex", "دارو درمان", "Ab",
                  "قلب و کبد", "ویتامین"):
        assert piece in got, piece


def test_pdf_flate_data_ending_in_cr(tmp_path):
    """A chosen divergence: compressed data whose last byte is CR, written
    as usual with LF before endstream. The JAX reader strips the CR with the
    end-of-line and loses the page; the port decodes it."""
    n = 0  # the first page number whose stream ends in CR: 1,299
    while not zlib.compress(b"BT (page %d word) Tj ET" % n).endswith(b"\r"):
        n += 1
    path = _pdf(tmp_path, "cr.pdf", [b"BT (first) Tj ET",
                                     b"BT (page %d word) Tj ET" % n], True)
    assert tpdf.extract_pdf_text(path) == f"first page {n} word"
    assert jpdf.extract_pdf_text(path) == "first"


def test_pdf_without_text_streams(tmp_path):
    path = _pdf(tmp_path, "empty.pdf", [b"q Q"], compress=True)
    assert tpdf.extract_pdf_text(path) == jpdf.extract_pdf_text(path) == ""


def _records():
    text = _document(7)
    chunker = tchunking.TextChunker(CFG)
    words, sentences = chunker.process_pdf_document(text)
    quoted = [{"id": "q0", "text": 'a "quoted", comma\nline', "n": 3,
               "flag": True}, {"id": "q1", "text": "", "n": -1,
                               "flag": False, "late": "x"}]
    return {"words": words, "sentences": sentences, "quoted": quoted,
            "empty": []}


@pytest.mark.parametrize("kind", ["words", "sentences", "quoted", "empty"])
def test_chunk_csv_equals_pandas(kind, tmp_path):
    records = _records()[kind]
    chunker = tchunking.TextChunker(CFG)
    path = chunker.save_chunks(records, "port.csv", str(tmp_path))
    jpath = jchunking.TextChunker(CFG).save_chunks(records, "jax.csv",
                                                   str(tmp_path))
    assert open(path, "rb").read() == open(jpath, "rb").read()
    if not records:
        return
    got = chunker.load_chunks("port.csv", directory=str(tmp_path))
    want = pd.read_csv(jpath, encoding="utf-8").to_dict("records")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if isinstance(w[key], float) and w[key] != w[key]:
                assert g[key] != g[key], key  # NaN where pandas has NaN
            else:
                assert g[key] == w[key], key
