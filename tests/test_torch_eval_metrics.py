"""The port's evaluation metrics against the JAX package's.

Every string metric of `TextMetrics` on seeded Persian strings (Persian
digits, punctuation, the 11 stopwords, empty and whitespace-only strings,
repeated n-grams, predictions shorter than their golds), bit-equal
(tolerance 0); the rank metrics hit@k, MRR@k and recall@k bit-equal; and
the semantic metrics on a tiny encoder whose Flax parameters are carried
into the port (models/convert.py), within 1e-5.
"""
import struct

import jax
import numpy as np
import pytest

from persian_rag_tpu.eval import metrics as jm
from persian_rag_tpu.models.encoder import EncoderConfig as JaxEncConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)

from persian_rag_tpu_torch.eval import metrics as tm
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder

WORDS = ["دارو", "قرص", "سردرد", "مصرف", "عوارض", "کودکان", "روزانه",
         "پزشک", "درمان", "بیماری", "دوز", "آنتی‌بیوتیک", "Aspirin", "MG",
         "ق", "x"]
STOPWORDS = sorted(jm.PERSIAN_STOPWORDS)
DIGITS = ["۱۲", "۵۰۰", "۳", "۰۷", "250", "۴۲mg"]
PUNCT = ["،", "؟", "!", ".", "«", "»", "(", ")", "-", ":", "؛"]
EDGE = ["", " ", "   \t\n ", "؟؟", "و در از", "۱۲۳", "دارو", "دارو دارو دارو"]


def _sentence(rng, n):
    pools = [WORDS] * 6 + [STOPWORDS] * 3 + [DIGITS, PUNCT]
    out = []
    for _ in range(n):
        pool = pools[rng.integers(len(pools))]
        tok = pool[rng.integers(len(pool))]
        if pool is PUNCT and out:
            out[-1] += tok  # punctuation glued to a word
        else:
            out.append(tok)
    return " ".join(out)


def _pairs():
    """Seeded (pred, gold) pairs: edge strings against each other, golds
    and their shortened, repeated, shuffled and unrelated predictions."""
    rng = np.random.default_rng(22)
    pairs = [(a, b) for a in EDGE for b in EDGE[::3]]
    for _ in range(60):
        gold = _sentence(rng, int(rng.integers(1, 25)))
        words = gold.split()
        cut = words[: max(1, int(rng.integers(1, len(words) + 1)))]
        shuffled = list(words)
        rng.shuffle(shuffled)
        pairs += [
            (gold, gold),
            (" ".join(cut), gold),                        # shorter than gold
            (" ".join(cut + cut + cut), gold),            # repeated n-grams
            (" ".join(shuffled).upper(), gold),
            (_sentence(rng, int(rng.integers(0, 12))), gold),
            (gold + " " + gold, " ".join(cut)),
        ]
    return pairs


PAIRS = _pairs()
J, T = jm.TextMetrics(), tm.TextMetrics()


def _same(a, b):
    """Equal, and bit-equal where floats."""
    if isinstance(a, float) or isinstance(b, float):
        return type(a) is type(b) and struct.pack("<d", a) == struct.pack(
            "<d", b)
    return a == b


def test_constants_equal():
    assert tm.PERSIAN_STOPWORDS == jm.PERSIAN_STOPWORDS
    assert len(tm.PERSIAN_STOPWORDS) == 11
    for name in ("_DIGIT_RE", "_PUNCT_RE", "_WS_RE"):
        assert getattr(tm, name).pattern == getattr(jm, name).pattern


@pytest.mark.parametrize("method", ["clean_text", "tokenize"])
def test_text_plumbing_bit_equal(method):
    texts = [t for pair in PAIRS for t in pair]
    for text in texts:
        assert getattr(T, method)(text) == getattr(J, method)(text), text


@pytest.mark.parametrize("n", [1, 2, 3, 4, 9])
def test_ngrams_bit_equal(n):
    for pred, gold in PAIRS:
        toks = J.tokenize(pred + " " + gold)
        assert T.ngrams(toks, n) == J.ngrams(toks, n)


def test_lcs_bit_equal():
    for pred, gold in PAIRS:
        a, b = J.tokenize(pred), J.tokenize(gold)
        assert T.lcs_length(a, b) == J.lcs_length(a, b)


@pytest.mark.parametrize("method,kw", [
    ("exact_match", {}), ("f1_score", {}), ("precision", {}),
    ("recall", {}), ("bleu_score", {}), ("bleu_score", {"n": 2}),
    ("bleu_score", {"n": 1}), ("rouge_1", {}), ("rouge_l", {}),
    ("is_similar_context", {}), ("is_similar_context", {"threshold": 0.35}),
])
def test_string_metric_bit_equal(method, kw):
    nonzero = 0
    for pred, gold in PAIRS:
        got = getattr(T, method)(pred, gold, **kw)
        want = getattr(J, method)(pred, gold, **kw)
        assert _same(got, want), (method, pred, gold, got, want)
        nonzero += bool(want)
    # the pairs reach both outcomes of every metric
    assert 0 < nonzero < len(PAIRS)


def test_bleu_reaches_its_quirks():
    """Orders run to len(pred_tokens) (a one-token prediction scores its
    unigram precision alone), a zero precision at a higher order gives
    log -inf and so 0, and the brevity penalty applies; the cap holds."""
    one = WORDS[0]
    gold = " ".join(WORDS[:6])
    for pred in (one, f"{WORDS[1]} {WORDS[0]} {WORDS[3]}", gold, gold + " x"):
        assert _same(T.bleu_score(pred, gold), J.bleu_score(pred, gold))
    assert T.bleu_score(f"{WORDS[1]} {WORDS[0]}", gold) == 0.0  # -inf mean
    assert 0 < T.bleu_score(one, gold) < 1.0  # brevity
    assert T.bleu_score(gold, gold) == 1.0


@pytest.mark.parametrize("method", ["context_precision", "context_recall"])
def test_context_metrics_bit_equal(method):
    rng = np.random.default_rng(5)
    texts = [g for _, g in PAIRS]
    for _ in range(80):
        retrieved = [texts[i] for i in rng.integers(0, len(texts),
                                                    rng.integers(0, 5))]
        relevant = [texts[i] for i in rng.integers(0, len(texts),
                                                   rng.integers(0, 3))]
        if rng.random() < 0.5 and relevant:
            retrieved.append(relevant[0])
        got = getattr(T, method)(retrieved, relevant)
        want = getattr(J, method)(retrieved, relevant)
        assert _same(float(got), float(want)) and type(got) is type(want)


@pytest.mark.parametrize("name", ["hit_at_k", "mrr_at_k", "recall_at_k"])
def test_rank_metrics_bit_equal(name):
    rng = np.random.default_rng(9)
    ids = [f"chunk_{i}" for i in range(30)]
    for _ in range(200):
        retrieved = list(rng.choice(ids, int(rng.integers(0, 12)),
                                    replace=False))
        relevant = list(rng.choice(ids, int(rng.integers(0, 4)),
                                   replace=False))
        for k in (1, 3, 5, 10, 20):
            got = getattr(tm, name)(retrieved, relevant, k)
            want = getattr(jm, name)(retrieved, relevant, k)
            assert _same(got, want), (name, k)


SMALL = dict(vocab_size=3000, hidden_size=48, num_layers=2, num_heads=4,
             intermediate_size=96, max_position_embeddings=64)


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxSentenceEncoder(JaxEncConfig(**SMALL), max_seq_len=48, seed=4)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        max_seq_len=48, device="cpu",
    )
    return jenc, tenc


def test_semantic_similarity_batch_within_1e5(encoders):
    jenc, tenc = encoders
    preds = [p for p, _ in PAIRS[:120]]
    golds = [g for _, g in PAIRS[:120]]
    got = T.semantic_similarity_batch(preds, golds, tenc)
    want = J.semantic_similarity_batch(preds, golds, jenc)
    assert got.shape == want.shape == (120,)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    blank = [not p.strip() or not g.strip() for p, g in zip(preds, golds)]
    assert any(blank) and (got[blank] == 0).all()
    assert ((got >= 0) & (got <= 1)).all()
    assert T.semantic_similarity_batch([], [], tenc).shape == (0,)


def test_semantic_single_and_relevancy_within_1e5(encoders):
    jenc, tenc = encoders
    for pred, gold in PAIRS[40:60]:
        for fn in ("semantic_similarity", "answer_relevancy"):
            got = getattr(T, fn)(pred, gold, tenc)
            want = getattr(J, fn)(pred, gold, jenc)
            assert isinstance(got, float)
            assert abs(got - want) <= 1e-5, (fn, pred, gold)
