"""DenseIndex storage tiers (bf16, int8 + refine), the quality gate and
search_mode="fast" of the port against the JAX package, on the CPU.

Both indexes are built from the same numpy vectors; the committed state is
compared as numpy arrays, ids must be equal, scores agree within 1e-5
(relative: two f32 evaluations). The JAX index runs its Pallas kernels in
interpret mode (`use_pallas=True`), so both packages compute the int8 tier
with bf16-rounded queries. The slice as a whole (tiny encoder, int8 +
refine, both servers) closes the file.
"""
import json
import logging
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.index.dense import DenseIndex as JaxDenseIndex
from persian_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from persian_rag_tpu.retrieval.system import RetrievalSystem as JaxRetrieval
from persian_rag_tpu.serve.api import RetrievalServer as JaxServer

from persian_rag_tpu_torch.index import dense as tdense
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
from persian_rag_tpu_torch.serve.api import RetrievalServer

N, D = 3000, 32


def _data(seed=0, n=N, d=D, n_q=7, offset=2.0):
    """Rows and queries sharing a mean direction, as embeddings do."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32) + offset
    queries = rng.standard_normal((n_q, d)).astype(np.float32) + offset
    return corpus, queries


def _clone_corpus(seed=3, n=2000, d=48):
    """A tight cone of near-clones: 120 base rows, resampled with small
    noise. bf16 storage loses the near-ties; the quality gate must act."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((120, d)).astype(np.float32) * 0.05 + 3.0
    pick = rng.integers(0, 120, n)
    noise = rng.standard_normal((n, d)).astype(np.float32)
    return (base[pick] + 0.05 * base.std(axis=0) * noise).astype(np.float32)


def _pair(corpus, metric, storage, **kw):
    j = JaxDenseIndex(corpus.shape[1], metric=metric,
                      storage_dtype=jnp.dtype(storage), use_pallas=True, **kw)
    t = DenseIndex(corpus.shape[1], metric=metric, device="cpu",
                   storage_dtype=storage, **kw)
    for index in (j, t):
        index.add(corpus)
        index.commit()
    return j, t


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_same_state(j, t):
    assert str(j.storage_dtype) == str(t.storage_dtype).replace("torch.", "")
    assert j.tier_probe == t.tier_probe
    for name in ("_device_corpus", "_row_scales", "_center", "_sqnorms",
                 "_refine_corpus"):
        want, got = _np(getattr(j, name)), _np(getattr(t, name))
        assert (want is None) == (got is None), name
        if want is not None:
            if name == "_sqnorms":  # two f32 reductions of the stored rows
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    # only the f32 tier builds a stage-1 image
    assert (t._stage1_bf16 is None) == (j._stage1_bf16 is None)


TIERS = [
    ("cosine", "int8", {}),
    ("ip", "int8", {}),
    ("ip", "int8", dict(refine_dtype=None, quality_floor=None)),
    ("cosine", "int8", dict(refine_dtype="bfloat16")),
    ("l2", "bfloat16", {}),
    ("cosine", "bfloat16", {}),
    ("ip", "bfloat16", dict(quality_floor=None)),
]


@pytest.mark.parametrize("refine_k", [None, 0, 40])
@pytest.mark.parametrize("metric,storage,kw", TIERS)
def test_tier_matches_jax(metric, storage, kw, refine_k):
    corpus, queries = _data()
    j, t = _pair(corpus, metric, storage, **kw)
    _assert_same_state(j, t)
    want_s, want_i = j.search(queries, 10, refine_k=refine_k)
    got_s, got_i = t.search(queries, 10, refine_k=refine_k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)
    one_s, one_i = t.search(queries[0], 10, refine_k=refine_k)
    assert one_s.shape == (10,)
    np.testing.assert_array_equal(one_i.numpy(), want_i[0])
    np.testing.assert_allclose(t.vectors(), j.vectors(), rtol=1e-6, atol=1e-6)
    rows = np.array([5, 0, N - 1])
    np.testing.assert_allclose(t.rows(rows), j.rows(rows), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_bf16_tier_is_close_to_f32(metric):
    """bf16 storage: every served score is within 2^-8 ||q|| max ||c|| of
    the f32 score of its id (one bf16 rounding per stored value)."""
    corpus, queries = _data(seed=1)
    t = DenseIndex(D, metric=metric, device="cpu", storage_dtype="bfloat16",
                   quality_floor=None)
    t.add(corpus)
    scores, ids = (x.numpy() for x in t.search(queries, 10))
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    if metric == "cosine":
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    rows = c[ids]
    if metric == "l2":
        exact = ((rows - q[:, None, :]) ** 2).sum(-1)
    else:
        exact = np.einsum("qd,qkd->qk", q, rows)
    bound = 2.0 ** -8 * np.linalg.norm(q, axis=1) * np.linalg.norm(
        c, axis=1).max() * (2.0 if metric == "l2" else 1.0)
    assert (np.abs(scores - exact) <= bound[:, None]).all()


@pytest.mark.parametrize("metric,fallback,storage_after", [
    ("l2", "exact", "float32"),
    ("cosine", "exact", "float32"),
    ("cosine", "int8_refine", "int8"),
    ("l2", "int8_refine", "float32"),  # int8 does not serve l2: exact
    ("l2", "keep", "bfloat16"),
])
def test_quality_gate_demotes_as_jax(metric, fallback, storage_after, caplog):
    corpus = _clone_corpus()
    with caplog.at_level(logging.WARNING,
                         logger="persian_rag_tpu_torch.index.dense"):
        j, t = _pair(corpus, metric, "bfloat16", quality_fallback=fallback)
    assert t.tier_probe["estimated_recall"] < 0.95
    assert t.storage_dtype == getattr(torch, storage_after)
    _assert_same_state(j, t)
    assert any("Recall@10" in r.message for r in caplog.records)
    # near-clones tie within f32 rounding, so the two packages may order
    # them differently: the served scores must agree, and each package's
    # ids must earn them on the rows both serve
    queries = corpus[::300] * 1.001
    want_s, want_i = j.search(queries, 10)
    got_s, got_i = t.search(queries, 10)
    rows = t.vectors().astype(np.float64)
    np.testing.assert_array_equal(t.vectors(), j.vectors())
    q = queries.astype(np.float64)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        atol = 1e-5
    else:
        # an f32 distance ||q||^2 - (2 q.c - ||c||^2) cancels: it errs by
        # up to (d + 3) 2^-24 (||q|| + ||c||)^2, in either package
        atol = 2 * (rows.shape[1] + 3) * 2.0 ** -24 * (
            np.linalg.norm(q, axis=1).max()
            + np.linalg.norm(rows, axis=1).max()) ** 2

    def earned(ids):
        if metric == "l2":
            return ((rows[ids] - q[:, None, :]) ** 2).sum(-1)
        return np.einsum("qd,qkd->qk", q, rows[ids])

    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(earned(got_i.numpy()), earned(want_i),
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got_s.numpy(), earned(got_i.numpy()),
                               rtol=1e-5, atol=atol)


def test_quality_gate_keeps_good_tiers_and_probes_raw_int8():
    corpus, _ = _data(seed=2)
    for metric, storage, kw in (
        ("ip", "bfloat16", {}),
        ("ip", "int8", dict(refine_dtype=None)),
    ):
        j, t = _pair(corpus, metric, storage, **kw)
        assert t.tier_probe["demoted_to"] is None
        assert t.tier_probe["estimated_recall"] >= 0.95
        _assert_same_state(j, t)
    # below 128 rows, or with the floor off, no probe runs
    small = DenseIndex(D, metric="ip", device="cpu", storage_dtype="bfloat16")
    small.add(corpus[:100])
    small.commit()
    assert small.tier_probe is None


def test_gate_reprobes_the_requested_tier_on_recommit():
    """A demotion is not inherited: each commit probes the tier the caller
    asked for against the grown corpus."""
    t = DenseIndex(48, metric="l2", device="cpu", storage_dtype="bfloat16")
    t.add(_clone_corpus())
    t.commit()
    assert t.storage_dtype == torch.float32
    rng = np.random.default_rng(4)
    t.add(rng.standard_normal((20_000, 48)).astype(np.float32) * 3.0)
    t.commit()
    assert t.tier_probe["tier"] == "bfloat16"
    assert t.storage_dtype == torch.bfloat16
    assert t.ntotal == 22_000


@pytest.mark.parametrize("storage,kw", [
    ("int8", {}),
    ("int8", dict(refine_dtype=None, quality_floor=None)),
    ("bfloat16", dict(quality_floor=None)),
])
def test_recommit_rebuilds_from_the_best_copy(storage, kw):
    """Re-commit after add() rebuilds from the refine copy where there is
    one (exactly), else from the dequantized rows, as the JAX package."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((60, 16)).astype(np.float32)
    b = rng.standard_normal((60, 16)).astype(np.float32)
    j = JaxDenseIndex(16, metric="ip", storage_dtype=jnp.dtype(storage), **kw)
    t = DenseIndex(16, metric="ip", device="cpu", storage_dtype=storage, **kw)
    for index in (j, t):
        index.add(a)
        index.commit()
        index.add(b)
        index.commit()
    np.testing.assert_allclose(t.vectors(), j.vectors(), rtol=1e-6, atol=1e-6)
    if not kw:
        np.testing.assert_allclose(t.vectors(), np.concatenate([a, b]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fast_search_mode_matches_jax(metric):
    corpus, queries = _data(seed=6, offset=0.0)
    j = JaxDenseIndex(D, metric=metric, search_mode="fast", use_pallas=True)
    t = DenseIndex(D, metric=metric, device="cpu", search_mode="fast")
    for index in (j, t):
        index.add(corpus)
    want_s, want_i = j.search(queries, 10)
    got_s, got_i = t.search(queries, 10)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=5e-4, atol=5e-4)


def test_int8_candidate_route_above_the_pool_gate(monkeypatch):
    """At ceil(n / 2048) * 7 >= 2 k_scan the int8 tier selects candidates
    without a running merge, then refines: exact scores, and the f32
    ranking's ids."""
    n, d = 60_000, 16
    corpus, queries = _data(seed=7, n=n, d=d, offset=0.5)
    calls = []
    real = tdense.flat_topk_scaled_candidates
    monkeypatch.setattr(
        tdense, "flat_topk_scaled_candidates",
        lambda *a, **kw: calls.append(a[3]) or real(*a, **kw))
    t = DenseIndex(d, metric="cosine", device="cpu", storage_dtype="int8")
    t.add(corpus)
    t.commit()
    assert not t._int8_candidates_ok(True, "dot", 106)  # pool: 210 keys
    assert t._int8_candidates_ok(True, "dot", 100)
    assert not t._int8_candidates_ok(False, "dot", 100)
    scores, ids = (x.numpy() for x in t.search(queries, 10))
    assert calls == [100]
    exact = DenseIndex(d, metric="cosine", device="cpu")
    exact.add(corpus)
    want_s, want_i = (x.numpy() for x in exact.search(queries, 10))
    hits = np.mean([len(set(ids[r]) & set(want_i[r])) / 10.0
                    for r in range(len(queries))])
    assert hits >= 0.99
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    np.testing.assert_allclose(
        scores, np.einsum("qd,qkd->qk", qn, cn[ids]), rtol=1e-5, atol=1e-5)
    # refine_k=0 leaves the candidate route for the raw int8 scores
    t.search(queries, 10, refine_k=0)
    assert calls == [100]


def test_constructor_accepts_the_jax_tests_spellings():
    for storage in ("int8", torch.int8, np.dtype("int8"), jnp.dtype("int8")):
        assert DenseIndex(8, metric="ip", device="cpu",
                          storage_dtype=storage).storage_dtype == torch.int8
    for storage in ("bfloat16", torch.bfloat16, jnp.dtype(jnp.bfloat16)):
        assert DenseIndex(8, device="cpu", storage_dtype=storage
                          ).storage_dtype == torch.bfloat16


# -- the slice as a whole --------------------------------------------------------

SMALL = dict(vocab_size=2000, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=64)
WORDS = ("دارو درمان بیماری پزشک قلب خون فشار دیابت کودک مادر تغذیه ورزش "
         "خواب درد معده کبد کلیه عفونت قرص آزمایش تشخیص پیشگیری پوست چشم "
         "دندان استخوان تب سرفه ویتامین آهن چاقی اضطراب حافظه بارداری").split()


def _texts(rng, n, lo, hi, tag):
    words = np.asarray(WORDS)
    return [
        f"{tag} {i} " + " ".join(words[rng.integers(0, len(words),
                                                    rng.integers(lo, hi))])
        for i in range(n)
    ]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("storage,metric", [("int8", "cosine"),
                                            ("bfloat16", "l2")])
def test_tier_slice_served_matches_jax(storage, metric):
    """Tiny encoder with converted weights -> tier index -> RetrievalSystem
    -> RetrievalServer, in both packages: the same ids, scores within
    1e-5 (relative)."""
    jenc = JaxSentenceEncoder(
        JaxConfig(**SMALL), tokenizer=JaxHashTokenizer(SMALL["vocab_size"]),
        max_seq_len=32, seed=11,
    )
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(SMALL["vocab_size"]), max_seq_len=32,
        device="cpu",
    )
    rng = np.random.default_rng(2051)
    chunks = [{"id": f"c{i}", "text": t, "chunk_type": "paragraph"}
              for i, t in enumerate(_texts(rng, 200, 6, 30, "بخش"))]
    queries = _texts(rng, 6, 3, 8, "پرسش")
    vectors = jenc.encode([c["text"] for c in chunks])
    j = JaxRetrieval(method="dense", encoder=jenc, dense_metric=metric)
    t = RetrievalSystem(method="dense", encoder=tenc, dense_metric=metric)
    assert j.load_chunks_and_index(chunks, embeddings=vectors)
    assert t.load_chunks_and_index(chunks, embeddings=vectors)
    kw = dict(quality_floor=None) if storage == "bfloat16" else {}
    j.dense_index, t.dense_index = _pair(vectors, metric, storage, **kw)
    answers = []
    for system, server_cls in ((j, JaxServer), (t, RetrievalServer)):
        with server_cls(system, max_wait_ms=20.0) as server:
            answers.append([
                _post(server.url + "/search", {"queries": queries[:4],
                                               "top_k": 5}),
                _post(server.url + "/search", {"query": queries[5],
                                               "top_k": 7}),
            ])
    for want, got in zip(*answers):
        assert [[h["id"] for h in r] for r in got["results"]] == [
            [h["id"] for h in r] for r in want["results"]]
        np.testing.assert_allclose(
            [[h["score"] for h in r] for r in got["results"]],
            [[h["score"] for h in r] for r in want["results"]], rtol=1e-5,
            atol=1e-6)


@pytest.mark.parametrize("storage,kw", [
    ("int8", {}),
    ("int8", dict(refine_dtype=None, quality_floor=None)),
    ("bfloat16", dict(quality_floor=None)),
])
def test_hybrid_rerank_gathers_dequantized_rows(storage, kw):
    """The hybrid device chain reranks on the rows `DenseIndex.rows` gives
    (refine copy, or stored values x scale + center), whatever the tier:
    it must agree with the host loop, which reads `rows()`."""
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL), tokenizer=HashTokenizer(SMALL["vocab_size"]),
        max_seq_len=32, device="cpu", seed=5,
    )
    rng = np.random.default_rng(77)
    chunks = [{"id": f"c{i}", "text": t, "chunk_type": "paragraph"}
              for i, t in enumerate(_texts(rng, 150, 6, 30, "بخش"))]
    queries = _texts(rng, 5, 3, 8, "پرسش")
    t = RetrievalSystem(method="hybrid", encoder=tenc, dense_metric="cosine")
    assert t.load_chunks_and_index(chunks)
    tier = DenseIndex(64, metric="cosine", device="cpu",
                      storage_dtype=storage, **kw)
    tier.add(t.dense_index.vectors())
    tier.commit()
    t.dense_index = tier
    device = t.retrieve_hybrid_batch(queries, 5, rerank=True, fused=True)
    host = t.retrieve_hybrid_batch(queries, 5, rerank=True, fused=False)
    assert [[c["id"] for c, _ in r] for r in device] == [
        [c["id"] for c, _ in r] for r in host]
    np.testing.assert_allclose(
        [[s for _, s in r] for r in device], [[s for _, s in r] for r in host],
        rtol=1e-5, atol=1e-6)
