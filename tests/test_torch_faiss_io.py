"""Index files cross between the packages: the port's copy of `faiss_io`
writes the JAX package's bytes and reads its files, `DenseIndex.save` /
`load` and `export_faiss` / `from_faiss` load in the other package, and
`RetrievalSystem.load_chunks_and_index(faiss_index_file=)` serves them."""
import numpy as np
import pytest
import torch

from persian_rag_tpu.index import faiss_io as jio
from persian_rag_tpu.index.dense import DenseIndex as JaxDenseIndex
from persian_rag_tpu_torch.index import faiss_io as tio
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem


def _vectors(seed=0, n=300, d=24):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def test_faiss_io_is_a_copy_of_the_jax_module():
    """Same public functions, and the port's imports nothing of JAX."""
    names = ("probe_faiss", "read_faiss_flat", "write_faiss_flat",
             "read_faiss_ivf", "write_faiss_ivf")
    assert all(callable(getattr(tio, n)) and callable(getattr(jio, n))
               for n in names)
    source = open(tio.__file__, encoding="utf-8").read()
    assert "import jax" not in source and "from persian_rag_tpu " not in source


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_files_are_byte_equal_and_cross_load(tmp_path, metric):
    vectors = _vectors()
    a, b = str(tmp_path / "jax.index"), str(tmp_path / "torch.index")
    jio.write_faiss_flat(a, vectors, metric=metric)
    tio.write_faiss_flat(b, vectors, metric=metric)
    assert open(a, "rb").read() == open(b, "rb").read()
    for reader, path in ((tio, a), (jio, b)):
        got, got_metric = reader.read_faiss_flat(path)
        assert got_metric == metric and reader.probe_faiss(path) == "flat"
        np.testing.assert_array_equal(got, vectors)


def test_ivf_files_are_byte_equal_and_cross_load(tmp_path):
    rng = np.random.default_rng(1)
    vectors = _vectors(1, n=200, d=16)
    centroids = _vectors(2, n=5, d=16)
    assign = rng.integers(0, 5, size=200)
    a, b = str(tmp_path / "jax.ivf"), str(tmp_path / "torch.ivf")
    for mod, path in ((jio, a), (tio, b)):
        mod.write_faiss_ivf(path, vectors, centroids, assign, metric="l2",
                            nprobe=3)
    assert open(a, "rb").read() == open(b, "rb").read()
    want, got = jio.read_faiss_ivf(b), tio.read_faiss_ivf(a)
    assert tio.probe_faiss(a) == "ivf" and sorted(want) == sorted(got)
    for key, value in want.items():
        if isinstance(value, (list, tuple)):
            for x, y in zip(value, got[key]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(np.asarray(value),
                                          np.asarray(got[key]))


@pytest.mark.parametrize("metric,storage", [
    ("l2", "float32"), ("cosine", "float32"), ("ip", "int8"),
    ("l2", "bfloat16"),
])
def test_native_files_cross_load(tmp_path, metric, storage):
    vectors = _vectors(3)
    queries = _vectors(4, n=5)
    j = JaxDenseIndex(24, metric=metric, storage_dtype=storage,
                      quality_floor=None)
    t = DenseIndex(24, metric=metric, device="cpu", storage_dtype=storage,
                   quality_floor=None)
    for index in (j, t):
        index.add(vectors)
        index.commit()
    j.save(str(tmp_path / "from_jax"))
    t.save(str(tmp_path / "from_torch.npz"))
    assert (tmp_path / "from_torch.npz").exists()
    assert (tmp_path / "from_torch.meta.json").read_text() == (
        tmp_path / "from_jax.meta.json").read_text()
    loaded_t = DenseIndex.load(str(tmp_path / "from_jax"), device="cpu")
    loaded_j = JaxDenseIndex.load(str(tmp_path / "from_torch"))
    assert loaded_t.metric == loaded_j.metric == metric
    assert loaded_t.ntotal == loaded_j.ntotal == 300
    np.testing.assert_allclose(loaded_t.vectors(), j.vectors(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(loaded_j.vectors(), t.vectors(), rtol=1e-6,
                               atol=1e-7)
    want_s, want_i = loaded_j.search(queries, 5)
    got_s, got_i = loaded_t.search(queries, 5)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)
    # a tier is a choice of the loader, not of the file
    as_int8 = DenseIndex.load(str(tmp_path / "from_jax"), device="cpu",
                              storage_dtype="int8") if metric != "l2" else None
    assert as_int8 is None or as_int8.storage_dtype == torch.int8


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_faiss_export_import_cross(tmp_path, metric):
    vectors = _vectors(5)
    j = JaxDenseIndex(24, metric=metric)
    t = DenseIndex(24, metric=metric, device="cpu")
    for index in (j, t):
        index.add(vectors)
        index.commit()
    a, b = str(tmp_path / "jax.index"), str(tmp_path / "torch.index")
    j.export_faiss(a)
    t.export_faiss(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    back_t = DenseIndex.from_faiss(a, device="cpu")
    back_j = JaxDenseIndex.from_faiss(b)
    # cosine exports normalized rows under the inner-product fourcc
    assert back_t.metric == back_j.metric == ("l2" if metric == "l2" else "ip")
    np.testing.assert_array_equal(back_t.vectors(), back_j.vectors())
    queries = _vectors(6, n=4)
    want = back_j.search(queries, 6)[1]
    np.testing.assert_array_equal(back_t.search(queries, 6)[1].numpy(), want)


@pytest.mark.parametrize("kind", ["npz", "faiss"])
def test_retrieval_system_serves_an_index_file(tmp_path, kind):
    vectors = _vectors(7, n=50)
    chunks = [{"id": f"c{i}", "text": f"متن {i}"} for i in range(50)]
    src = JaxDenseIndex(24, metric="ip")
    src.add(vectors)
    src.commit()
    if kind == "npz":
        path = str(tmp_path / "dense.npz")
        src.save(path)
    else:
        path = str(tmp_path / "dense.index")
        src.export_faiss(path)
    rs = RetrievalSystem(method="dense", dense_metric="l2", device="cpu")
    assert rs.load_chunks_and_index(chunks, faiss_index_file=path)
    assert rs.dense_metric == "ip"  # the file's metric wins
    assert rs._rows_match_encoder is False  # provenance unknown: foreign
    assert rs.dense_index.ntotal == 50
    want = src.search(vectors[:3], 4)[1]
    got = rs.dense_index.search(vectors[:3], 4)[1].numpy()
    np.testing.assert_array_equal(got, want)
    # `embeddings` takes priority over a file
    assert rs.load_chunks_and_index(chunks, faiss_index_file=path,
                                    embeddings=vectors * 2.0)
    assert rs._rows_match_encoder is True


def test_ivf_file_names_its_roadmap_item(tmp_path):
    """ROADMAP P5 (IVF) is ported: an IVF-flat file serves. Its lists equal
    the JAX package's IVFIndex over the same file."""
    from persian_rag_tpu.index.ivf import IVFIndex as JaxIVFIndex
    from persian_rag_tpu_torch.index.ivf import IVFIndex

    path = str(tmp_path / "ivf.index")
    vectors = _vectors(8, n=40, d=8)
    tio.write_faiss_ivf(path, vectors, _vectors(9, n=2, d=8),
                        np.arange(40) % 2, nprobe=2)
    rs = RetrievalSystem(method="dense", device="cpu")
    chunks = [{"id": f"c{i}", "text": "x"} for i in range(40)]
    assert rs.load_chunks_and_index(chunks, faiss_index_file=path)
    assert isinstance(rs.dense_index, IVFIndex)
    assert rs.dense_index.ntotal == 40 and rs.dense_metric == "l2"
    want = JaxIVFIndex.from_faiss(path).search(vectors[:3], 4)[1]
    got = rs.dense_index.search(vectors[:3], 4)[1].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].tolist() == [0, 1, 2]  # each row finds itself
