"""The port's native BM25 builder (`persian_rag_tpu_torch/native`,
g++ at first use into the build/ tree) against its Python builder and the
JAX package's native builder, on the CPU.

Held bit for bit: the vocabulary, the idf (both builders take numpy's log
in the Python builder's loop), avgdl, and every bucket's ids, values and
global ids, on Persian / Latin text with an empty document and repeated
words, and on a 2,000-document corpus whose lengths span several buckets;
the JAX native builder gives the same arrays (its idf comes from std::log
and may part from numpy's in the last bit: they are held to 1e-12 and equal
on these corpora). `use_native=None` takes the native builder, True raises
where it does not build, and None then logs the compiler's error and takes
the Python builder; the source compiles into build/, not beside itself.
"""
import importlib
import logging
import os

import numpy as np
import pytest

from persian_rag_tpu import native as jnative

jlex = importlib.import_module("persian_rag_tpu.index.lexical")
tlex = importlib.import_module("persian_rag_tpu_torch.index.lexical")
tnative = importlib.import_module("persian_rag_tpu_torch.native")

CORPUS = [
    "دارو برای درمان بیماری استفاده می شود",
    "این دارو عوارض جانبی کمی دارد",
    "بیماری قلبی نیاز به درمان فوری دارد",
    "the quick brown fox jumps over the lazy dog",
    "mixed زبان corpus with دارو tokens",
    "",
    "dup dup dup words words",
    "tabs\tand\nnew lines  and nbsp",
]


def _random_corpus(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(1500)] + ["دارو", "درمان", "قلب"]
    lengths = np.where(rng.random(n) < 0.7, rng.integers(3, 14, n),
                       rng.integers(14, 400, n))
    return [" ".join(rng.choice(vocab, size=int(m))) for m in lengths]


def _arrays(index):
    if index._buckets is None:
        return [(index.doc_ids, index.doc_vals, np.arange(index.ntotal))]
    return [(b.ids, b.vals, b.gids) for b in index._buckets]


def _bits_equal(a, b):
    assert a.vocab == b.vocab
    assert list(a.idf) == list(b.idf)
    for term, value in a.idf.items():
        assert np.float64(value).tobytes() == np.float64(b.idf[term]).tobytes()
    assert np.float64(a._avgdl).tobytes() == np.float64(b._avgdl).tobytes()
    pa, pb = _arrays(a), _arrays(b)
    assert len(pa) == len(pb)
    for (ia, va, ga), (ib, vb, gb) in zip(pa, pb):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va.view(np.uint32), vb.view(np.uint32))
        np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("corpus", ["small", "bucketed"])
def test_native_equals_python_bit_for_bit(corpus):
    texts = CORPUS if corpus == "small" else _random_corpus()
    py = tlex.BM25Index(device="cpu").build(texts, use_native=False)
    nat = tlex.BM25Index(device="cpu").build(texts, use_native=True)
    _bits_equal(nat, py)
    if corpus == "bucketed":
        assert nat._buckets is not None and len(nat._buckets) > 2
    auto = tlex.BM25Index(device="cpu").build(texts)  # None: native
    _bits_equal(auto, py)
    q = "دارو درمان tok1 tok7 dup"
    np.testing.assert_array_equal(nat.get_scores(q), py.get_scores(q))


@pytest.mark.skipif(not jnative.available(), reason="the JAX package's "
                    "native library does not build here")
@pytest.mark.parametrize("corpus", ["small", "bucketed"])
def test_native_equals_jax_native(corpus):
    texts = CORPUS if corpus == "small" else _random_corpus(seed=1)
    j = jlex.BM25Index().build(texts, use_native=True)
    t = tlex.BM25Index(device="cpu").build(texts, use_native=True)
    assert t.vocab == j.vocab and t._avgdl == j._avgdl
    for term, value in j.idf.items():
        assert abs(t.idf[term] - value) <= 1e-12 * abs(value), term
    for (ia, va, ga), (ib, vb, gb) in zip(_arrays(t), _arrays(j)):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(ga, gb)


def test_builds_into_the_build_tree():
    path = tnative.library_path()
    assert tnative.available() and path.exists()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(path).startswith(os.path.join(root, "build", ""))
    assert not [f for f in os.listdir(tnative.SRC.parent)
                if f.endswith(".so")]


def test_failed_compile_logs_and_falls_back(monkeypatch, tmp_path, caplog):
    """A source that does not compile: None logs g++'s error once and takes
    the Python builder; True raises it."""
    bad = tmp_path / "lexical_native.cpp"
    bad.write_text("this is not C++\n", encoding="utf-8")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    monkeypatch.setattr(tnative, "_warned", False)
    with caplog.at_level(logging.WARNING, logger=tnative.__name__):
        index = tlex.BM25Index(device="cpu").build(CORPUS)
    assert "g++ failed" in caplog.text and "not C++" in caplog.text
    _bits_equal(index,
                tlex.BM25Index(device="cpu").build(CORPUS, use_native=False))
    with pytest.raises(RuntimeError, match="does not build"):
        tlex.BM25Index(device="cpu").build(CORPUS, use_native=True)
