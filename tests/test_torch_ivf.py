"""The port's IVFIndex against the JAX package's.

Both packages search the same saved IVF state and must return the same ids
and, within 1e-5 relative, the same scores: l2, ip and cosine; nprobe 1, 4
and every cell; k past the probed rows (-1 pads); a small `cell_cap`, so
that the overflow block is searched; duplicate rows, so that ties occur.
The corpora are dyadic (small integers; for cosine, rows of sixteen
+-1/4 entries, whose norm is exactly 1) so that every score is exact in
f32 in both packages: an id list can then only differ by the search's own
order, ties included. (On Gaussian rows two f32 evaluations of one score
may differ in the last bit and swap a near-tie.)

From the same initial rows (JAX's, drawn with jax.random.choice) the
port's Lloyd loop gives the JAX assignments and centroids within 1e-5;
`_auto_cap`, `calibrate_nprobe` and `rows` agree; `save` / `load` and the
FAISS files cross between the packages, and `export_faiss` of one state is
byte-equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.index import faiss_io as jio
from persian_rag_tpu.index import ivf as jivf
from persian_rag_tpu_torch.index import faiss_io as tio
from persian_rag_tpu_torch.index import ivf as tivf

D = 32
N_CELLS = 20


def _integer_corpus(rng, n_clusters=N_CELLS, per=50, dup=30):
    centers = rng.integers(-20, 21, (n_clusters, D))
    rows = np.concatenate(
        [c + rng.integers(-3, 4, (per, D)) for c in centers])
    return np.concatenate([rows, rows[:dup]]).astype(np.float32)


def _sign_rows(rng, n_clusters, per, flips=2):
    """Rows of sixteen +-1/4 entries (norm exactly 1), clustered around a
    sign pattern with `flips` signs changed."""
    rows = []
    for _ in range(n_clusters):
        base = np.zeros(D)
        nz = rng.choice(D, 16, replace=False)
        base[nz] = rng.choice([-0.25, 0.25], 16)
        for _ in range(per):
            v = base.copy()
            f = rng.choice(nz, flips, replace=False)
            v[f] = -v[f]
            rows.append(v)
    return np.asarray(rows, np.float32)


def _data(metric, seed=0):
    rng = np.random.default_rng(seed)
    if metric == "cosine":
        rows = _sign_rows(rng, N_CELLS, 50)
        corpus = np.concatenate([rows, rows[:30]])
        queries = _sign_rows(rng, 9, 1, flips=4)
    else:
        corpus = _integer_corpus(rng)
        queries = rng.integers(-20, 21, (9, D)).astype(np.float32)
    return corpus, queries


def _built(maker, metric, cap, tmp_path):
    """(the JAX index, the port's index) over one state: built by
    `maker` (the package that builds it), saved, loaded by the other."""
    corpus, queries = _data(metric)
    path = str(tmp_path / "ivf")
    if maker == "jax":
        j = jivf.IVFIndex(D, n_cells=N_CELLS, nprobe=4, metric=metric,
                          cell_cap=cap).build(corpus)
        j.save(path)
        t = tivf.IVFIndex.load(path, device="cpu")
    else:
        t = tivf.IVFIndex(D, n_cells=N_CELLS, nprobe=4, metric=metric,
                          cell_cap=cap, device="cpu").build(corpus)
        t.save(path)
        j = jivf.IVFIndex.load(path)
    return j, t, corpus, queries


@pytest.mark.parametrize("maker", ["jax", "torch"])
@pytest.mark.parametrize("cap", [None, 20])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_search_equals_jax_on_one_state(maker, cap, metric, tmp_path):
    j, t, _, queries = _built(maker, metric, cap, tmp_path)
    if cap is not None:  # a forced small cap spills to the overflow block
        assert j._overflow is not None
    np.testing.assert_array_equal(t._cell_ids.numpy(),
                                  np.asarray(j._cell_ids))
    padded = 0
    for nprobe in (1, 4, N_CELLS):
        for k in (5, 200, 2000):
            js, ji = j.search(queries, k, nprobe=nprobe)
            ts, ti = t.search(queries, k, nprobe=nprobe)
            assert ti.dtype == torch.int32 and ts.shape == ji.shape
            np.testing.assert_array_equal(ti.numpy(), ji)
            np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)
            padded += int((ji == -1).sum())
    assert padded > 0  # k past the probed rows was reached
    # device queries (RetrievalSystem's path) give the same lists
    ts, ti = t.search_device(torch.from_numpy(queries), 7)
    np.testing.assert_array_equal(ti.numpy(), j.search(queries, 7)[1])


def test_tie_order_is_the_gathered_position_not_the_id():
    """Equal scores in two probed cells rank in probe order (the nearer
    cell first), as lax.top_k ranks the gathered list, even where that puts
    the higher id first."""
    corpus = np.array([[0, 0], [20, 0], [1, 0], [100, 0], [99, 0],
                       [101, 0]], np.float32)
    centroids = np.array([[7, 0], [100, 0]], np.float32)
    assign = np.array([0, 0, 0, 1, 1, 1])
    q = np.array([[60, 0]], np.float32)  # |q - row 1| = |q - row 3| = 40
    j = jivf.IVFIndex(2, n_cells=2, nprobe=2)
    j.centroids = jnp.asarray(centroids)
    j._populate(corpus, assign)
    t = tivf.IVFIndex(2, n_cells=2, nprobe=2, device="cpu")
    t.centroids = torch.from_numpy(centroids)
    t._populate(corpus, assign)
    js, ji = j.search(q, 6)
    ts, ti = t.search(q, 6)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)
    pos3, pos1 = list(ji[0]).index(3), list(ji[0]).index(1)
    assert js[0][pos3] == js[0][pos1] and pos3 < pos1


def _gaussian_clusters(seed, n_clusters=20, per=50, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 10
    return np.concatenate(
        [c + rng.standard_normal((per, d)) for c in centers]).astype(
            np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_from_jax_initial_rows(seed):
    data = _gaussian_clusters(seed)
    init = jax.random.choice(jax.random.PRNGKey(seed), data.shape[0],
                             (N_CELLS,), replace=False)
    j_cent, j_assign = jivf._kmeans_assign(jnp.asarray(data), N_CELLS, 10,
                                           seed)
    t_cent, t_assign = tivf._lloyd(
        torch.from_numpy(data), torch.from_numpy(np.array(init)), 10)
    np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(t_cent.numpy(), np.asarray(j_cent),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_reduces_distortion_from_seeded_rows():
    """The port's own draw of initial rows (a seeded torch.Generator, a
    chosen divergence from jax.random.choice) trains as well."""
    data = torch.from_numpy(_gaussian_clusters(3))

    def distortion(c):
        return float(torch.cdist(data, c).min(dim=1).values.pow(2).mean())

    c1 = tivf.kmeans(data, N_CELLS, iters=1, seed=0)
    c10 = tivf.kmeans(data, N_CELLS, iters=10, seed=0)
    assert distortion(c10) <= distortion(c1) + 1e-5
    again = tivf.kmeans(data, N_CELLS, iters=10, seed=0)
    assert torch.equal(c10, again)


def test_auto_cap_equals_jax():
    rng = np.random.default_rng(5)
    for nprobe in (1, 4, 8):
        j = jivf.IVFIndex(D, n_cells=50, nprobe=nprobe)
        t = tivf.IVFIndex(D, n_cells=50, nprobe=nprobe, device="cpu")
        for _ in range(5):
            counts = rng.zipf(1.5, 50).clip(0, 5000) * rng.integers(0, 2, 50)
            assert t._auto_cap(counts) == j._auto_cap(counts)
    assert t._auto_cap(np.zeros(50, np.int64)) == 1


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_calibrate_nprobe_equals_jax(metric, tmp_path):
    j, t, corpus, _ = _built("jax", metric, None, tmp_path)
    want = j.calibrate_nprobe(0.95, corpus, n_sample=64)
    got = t.calibrate_nprobe(0.95, corpus, n_sample=64)
    assert [tuple(p) for p in got["curve"]] == [
        tuple(p) for p in want["curve"]]
    assert got == {**want, "curve": got["curve"]}
    assert t.nprobe == j.nprobe


def test_rows_equal_jax_cells_and_overflow(tmp_path):
    j, t, corpus, _ = _built("jax", "cosine", 20, tmp_path)
    ids = np.array([0, 5, 999, 1000, 1029, 7, 512, 3])
    np.testing.assert_array_equal(t.rows(ids), j.rows(ids))
    overflow = np.asarray(j._overflow_ids)[:5]
    np.testing.assert_array_equal(t.rows(overflow), j.rows(overflow))


@pytest.mark.parametrize("cap", [None, 20])
def test_files_cross_between_packages(cap, tmp_path):
    j, t, corpus, queries = _built("jax", "l2", cap, tmp_path)
    a, b = str(tmp_path / "jax.index"), str(tmp_path / "torch.index")
    j.export_faiss(a)
    t.export_faiss(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tio.probe_faiss(a) == "ivf"
    # each package imports the other's file (no retraining)
    t2 = tivf.IVFIndex.from_faiss(a, device="cpu")
    j2 = jivf.IVFIndex.from_faiss(b)
    for k in (5, 60):
        np.testing.assert_array_equal(
            t2.search(queries, k)[1].numpy(), j2.search(queries, k)[1])
    # port save -> JAX load -> JAX save -> port load: the same state
    t.save(str(tmp_path / "round"))
    j3 = jivf.IVFIndex.load(str(tmp_path / "round"))
    j3.save(str(tmp_path / "back.npz"))
    t3 = tivf.IVFIndex.load(str(tmp_path / "back.npz"), device="cpu")
    for name in ("_cells", "_cell_ids"):
        np.testing.assert_array_equal(getattr(t3, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert t3.ntotal == j.ntotal == corpus.shape[0]
    assert (t3.nprobe, t3.n_cells, t3.metric) == (j.nprobe, j.n_cells, "l2")
    np.testing.assert_array_equal(t3.search(queries, 9)[1].numpy(),
                                  j.search(queries, 9)[1])
    data = jio.read_faiss_ivf(b)
    assert data["nprobe"] == j.nprobe and data["metric"] == "l2"


def test_refusals():
    # a mesh is ported (tests/test_torch_sharded_ivf.py): a non-Mesh raises
    with pytest.raises(TypeError, match="Mesh"):
        tivf.IVFIndex(D, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        tivf.IVFIndex(D, metric="hamming", device="cpu")
    with pytest.raises(ValueError, match="not built"):
        tivf.IVFIndex(D, device="cpu").search(np.zeros((1, D)), 3)
