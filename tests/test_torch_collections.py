"""The port's collections against the JAX package's, and the three JAX
faults the port corrects.

add, query, persist and reopen give equal ids, documents, metadatas and
distances in both packages, and a directory written by either package
opens in the other (with shards still to replay, and consolidated). The
embeddings are dyadic (cosine: rows of sixteen +-1/4 entries, norm exactly
1; l2: small integers), so every distance is exact in f32 in both packages
and is compared for equality.

Each corrected fault has a test that passes on the port and pins the JAX
package's differing result:
(a) a failed shard unlink after consolidation, and a save cut between the
    index and the sidecar, do not duplicate rows on reload;
(b) a new shard is numbered past a leftover one and replays after it;
(c) a collection already open as cosine, asked for with l2, raises.
"""
import os

import numpy as np
import pytest

from persian_rag_tpu.index.collections import (
    Collection as JaxCollection,
    CollectionStore as JaxStore,
)
from persian_rag_tpu_torch.index.collections import (
    Collection,
    CollectionStore,
)

D = 32
PACKAGES = {
    "jax": (JaxStore, JaxCollection, {}),
    "torch": (CollectionStore, Collection, {"device": "cpu"}),
}


def _rows(rng, n, metric):
    if metric == "l2":
        return rng.integers(-8, 9, (n, D)).astype(np.float32)
    out = np.zeros((n, D), np.float32)
    for row in out:
        nz = rng.choice(D, 16, replace=False)
        row[nz] = rng.choice([-0.25, 0.25], 16)
    return out


def _batches(metric, seed=0, sizes=(9, 14, 6)):
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for size in sizes:
        ids = [f"doc{start + i}" for i in range(size)]
        out.append(dict(
            ids=ids,
            documents=[f"متن {i}" for i in ids],
            embeddings=_rows(rng, size, metric),
            metadatas=[{"batch": len(out), "n": start + i}
                       for i in range(size)],
        ))
        start += size
    dup = out[0]["embeddings"][:2]
    out[-1]["embeddings"][:2] = dup  # duplicate rows: ties by lower id
    return out, _rows(rng, 5, metric)


def _fill(pkg, path, metric, batches):
    store_cls, _, kw = PACKAGES[pkg]
    store = store_cls(path=path, **kw)
    col = store.get_or_create_collection("docs", metric=metric)
    for b in batches:
        col.add(**b, batch_size=4)
    return store, col


def _open(pkg, path, persist=False):
    _, col_cls, kw = PACKAGES[pkg]
    return col_cls.load(os.path.join(path, "docs"), persist=persist, **kw)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_collections_equal_across_packages(metric, tmp_path):
    batches, queries = _batches(metric)
    paths = {p: str(tmp_path / p) for p in PACKAGES}
    cols = {p: _fill(p, paths[p], metric, batches)[1] for p in PACKAGES}
    want = cols["jax"].query(query_embeddings=queries, n_results=7)
    got = cols["torch"].query(query_embeddings=queries, n_results=7)
    assert got == want
    assert len(got["ids"]) == 5 and all(len(r) == 7 for r in got["ids"])
    assert cols["torch"].count() == cols["jax"].count() == 29
    # shards still to replay: each package opens the other's directory
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        col = _open(reader, paths[writer])
        assert col.query(query_embeddings=queries, n_results=7) == want
    # consolidated by a fresh store over each path, then cross-read again
    for p in PACKAGES:
        store_cls, _, kw = PACKAGES[p]
        store = store_cls(path=paths[p], **kw)
        assert store.list_collections() == ["docs"]
        col = store.get_or_create_collection("docs", metric=metric)
        assert col.query(query_embeddings=queries, n_results=7) == want
        assert not [f for f in os.listdir(os.path.join(paths[p], "docs"))
                    if f.startswith("shard-")]
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        assert _open(reader, paths[writer]).query(
            query_embeddings=queries, n_results=7) == want
    # one more add after consolidation replays in both packages
    extra, _ = _batches(metric, seed=1, sizes=(4,))
    extra[0]["ids"] = [f"late{i}" for i in range(4)]
    for p in PACKAGES:
        store_cls, _, kw = PACKAGES[p]
        store_cls(path=paths[p], **kw).get_or_create_collection(
            "docs", metric=metric).add(**extra[0])
    for reader in PACKAGES:
        for writer in PACKAGES:
            col = _open(reader, paths[writer])
            assert col.count() == 33 and col._ids[-4:] == extra[0]["ids"]


def test_a_failed_unlink_does_not_duplicate_on_reload(tmp_path, monkeypatch):
    batches, queries = _batches("cosine")
    counts = {}
    for p in PACKAGES:
        path = str(tmp_path / p)
        store, col = _fill(p, path, "cosine", batches)

        def refuse(name):
            raise PermissionError(name)

        monkeypatch.setattr(os, "remove", refuse)
        store.persist()  # consolidates; every shard unlink fails
        monkeypatch.undo()
        again = _open(p, path)
        counts[p] = (again.count(), again._index.ntotal)
        if p == "torch":
            assert again._ids == col._ids
            assert again.query(query_embeddings=queries, n_results=5) == \
                col.query(query_embeddings=queries, n_results=5)
    assert counts["torch"] == (29, 29)
    assert counts["jax"] == (58, 58)  # the JAX load replays the shards


def test_a_save_cut_before_its_sidecar_keeps_the_shards(tmp_path,
                                                        monkeypatch):
    """The index is written, then the sidecar write fails: the reload
    replays the shards once."""
    batches, _ = _batches("l2")
    totals = {}
    for p in PACKAGES:
        path = str(tmp_path / p)
        _, col = _fill(p, path, "l2", batches)
        col_cls = PACKAGES[p][1]

        def cut(*args, **kwargs):
            raise OSError("disk full")

        monkeypatch.setattr(col_cls, "_write_sidecar", cut)
        with pytest.raises(OSError, match="disk full"):
            col.save(os.path.join(path, "docs"))
        monkeypatch.undo()
        again = _open(p, path)
        totals[p] = (again.count(), again._index.ntotal)
        if p == "torch":
            assert again._ids == col._ids
    assert totals["torch"] == (29, 29)
    assert totals["jax"] == (29, 58)  # index rows past the sidecar's ids


def test_b_new_shard_numbers_past_a_leftover(tmp_path):
    """A directory whose only shard is shard-000002 (its predecessors
    consolidated and removed): a new add replays after it."""
    batches, _ = _batches("l2", sizes=(5, 3))
    order = {}
    for p in PACKAGES:
        _, col_cls, kw = PACKAGES[p]
        d = str(tmp_path / p / "docs")
        col_cls("docs", metric="l2", persist_dir=d, **kw).add(**batches[0])
        for suffix in (".npz", ".json"):
            os.replace(os.path.join(d, "shard-000000" + suffix),
                       os.path.join(d, "shard-000002" + suffix))
        col_cls("docs", metric="l2", persist_dir=d, **kw).add(**batches[1])
        order[p] = (col_cls.load(d, **kw)._ids,
                    sorted(f for f in os.listdir(d) if f.endswith(".json")))
    first, second = batches[0]["ids"], batches[1]["ids"]
    assert order["torch"] == (first + second, [
        "collection.json", "shard-000002.json", "shard-000003.json"])
    assert order["jax"] == (second + first, [
        "collection.json", "shard-000001.json", "shard-000002.json"])


def test_c_metric_guard_covers_an_open_collection(tmp_path):
    for path in (None, str(tmp_path / "store")):
        store = CollectionStore(path=path, device="cpu")
        cos = store.get_or_create_collection("docs", metric="cosine")
        assert store.get_or_create_collection("docs") is cos
        with pytest.raises(ValueError, match="metric 'cosine'"):
            store.get_or_create_collection("docs", metric="l2")
        jstore = JaxStore(path=None if path is None else path + "_jax")
        jcos = jstore.get_or_create_collection("docs", metric="cosine")
        # the JAX store hands back the cosine collection
        assert jstore.get_or_create_collection("docs", metric="l2") is jcos
    # reopened from disk, both packages raise
    batches, _ = _batches("cosine", sizes=(3,))
    for p in PACKAGES:
        store_cls, _, kw = PACKAGES[p]
        path = str(tmp_path / f"disk_{p}")
        store_cls(path=path, **kw).get_or_create_collection(
            "docs").add(**batches[0])
        with pytest.raises(ValueError, match="requested 'l2'"):
            store_cls(path=path, **kw).get_or_create_collection(
                "docs", metric="l2")


def test_store_delete_and_memory_only(tmp_path):
    batches, queries = _batches("cosine")
    store = CollectionStore(device="cpu")
    col = store.get_or_create_collection("mem")
    jcol = JaxStore().get_or_create_collection("mem")
    for b in batches:
        col.add(**b)
        jcol.add(**b)
    assert col.persist_dir is None
    assert col.query(query_embeddings=queries[0], n_results=3) == \
        jcol.query(query_embeddings=queries[0], n_results=3)
    path = str(tmp_path / "s")
    disk, _ = _fill("torch", path, "cosine", batches)
    disk.delete_collection("docs")
    assert disk.list_collections() == [] and os.listdir(path) == []
    with pytest.raises(ValueError, match="empty collection"):
        disk.get_or_create_collection("docs").query(queries)
