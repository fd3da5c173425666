"""parallel/sharded_ivf.py and IVFIndex(mesh=) of the port against the
JAX package's sharded IVF, on the CPU.

One IVF state (built by the port, saved) is sharded by both packages: the
JAX `shard_ivf` / `sharded_ivf_topk` on conftest's 8 virtual CPU devices
and the port's `IVFIndex.load(..., mesh=)`. The corpora are dyadic (see
tests/test_torch_ivf.py), so every score is exact and the id lists equal,
ties included (both merges order them by the lower id): l2, ip and
cosine, with and without an overflow block, nprobe 1 / all, k past
the probed rows. A 1-shard mesh returns the single-device lists; at 8
shards every query's recall of the exact ranking is at least the
single-device probe's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.core.mesh import build_mesh as jbuild
from persian_rag_tpu.parallel import sharded_ivf as jsi
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.index import ivf as tivf
from persian_rag_tpu_torch.ops.flat_topk import flat_topk_ref

from test_torch_ivf import D, N_CELLS, _data


def _meshes(shards):
    return (jbuild(shards, 1, devices=jax.devices()[:shards]),
            build_mesh(shards, 1, devices=["cpu"] * shards))


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """{(metric, cap): (saved path, queries)} over one built state each."""
    out = {}
    for metric in ("l2", "ip", "cosine"):
        corpus, queries = _data(metric)
        for cap in (None, 20):
            path = str(tmp_path_factory.mktemp("ivf") / "ivf")
            tivf.IVFIndex(D, n_cells=N_CELLS, nprobe=4, metric=metric,
                          cell_cap=cap, device="cpu").build(corpus).save(path)
            out[metric, cap] = (path, queries)
    return out


@pytest.mark.parametrize("metric,cap,shards", [
    ("l2", None, 8), ("l2", 20, 3), ("ip", 20, 8), ("ip", None, 3),
    ("cosine", 20, 8), ("cosine", None, 3)])
def test_sharded_ivf_equals_jax(states, metric, cap, shards):
    path, queries = states[metric, cap]
    jm, tm = _meshes(shards)
    t = tivf.IVFIndex.load(path, mesh=tm)
    assert t.device == torch.device("cpu") and len(t._sharded) == shards
    single = tivf.IVFIndex.load(path, device="cpu")
    jsh = jsi.shard_ivf(
        single.centroids.numpy(), single._cells.numpy(),
        single._cell_ids.numpy(),
        None if single._overflow is None else single._overflow.numpy(),
        None if single._overflow is None else single._overflow_ids.numpy(),
        jm, D)
    q = queries
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    for nprobe in (1, N_CELLS):
        for k in (5, 2000):
            kk = min(k, t.ntotal)
            js, ji = jsi.sharded_ivf_topk(
                jnp.asarray(q), *jsh, k=kk, nprobe=nprobe,
                metric="l2" if metric == "l2" else "dot", mesh=jm)
            ts, ti = t.search(queries, k, nprobe=nprobe)
            assert ti.dtype == torch.int32
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_one_shard_is_the_single_device_probe():
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((1500, 16)).astype(np.float32)
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    for metric in ("l2", "ip"):
        one = tivf.IVFIndex(16, n_cells=30, nprobe=4, metric=metric,
                            device="cpu").build(corpus)
        _, tm = _meshes(1)
        sharded = tivf.IVFIndex(16, n_cells=30, nprobe=4, metric=metric,
                                mesh=tm).build(corpus)
        for got, want in zip(sharded.search(queries, 10),
                             one.search(queries, 10)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_eight_shards_recall_at_least_single_device():
    rng = np.random.default_rng(4)
    corpus = rng.standard_normal((2000, 16)).astype(np.float32)
    queries = rng.standard_normal((30, 16)).astype(np.float32)
    _, truth = flat_topk_ref(torch.from_numpy(queries),
                             torch.from_numpy(corpus), 10, "l2")
    one = tivf.IVFIndex(16, n_cells=30, nprobe=3, device="cpu").build(corpus)
    _, tm = _meshes(8)
    sharded = tivf.IVFIndex(16, n_cells=30, nprobe=3, mesh=tm).build(corpus)
    np.testing.assert_array_equal(sharded.centroids.numpy(),
                                  one.centroids.numpy())

    def recall(ids):
        return np.array([len(set(ids[i].tolist()) & set(truth[i].tolist()))
                         for i in range(len(queries))])

    r_one = recall(one.search(queries, 10)[1])
    r_sharded = recall(sharded.search(queries, 10)[1])
    assert (r_sharded >= r_one).all()
    assert r_sharded.sum() > r_one.sum()
