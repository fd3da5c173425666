"""core/mesh.py of the port against the JAX package's, on the CPU.

The port's mesh is a (corpus, data) grid of torch devices; the CPU tests
repeat torch.device("cpu") where the JAX tests use conftest's 8 virtual
CPU devices. `build_mesh` takes JAX's argument rules; the sharding
helpers split or copy tensors.
"""
import jax
import numpy as np
import pytest
import torch

from persian_rag_tpu.core import mesh as jmesh
from persian_rag_tpu_torch import core as tcore
from persian_rag_tpu_torch.core import mesh as tmesh

CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("corpus,data", [(-1, 1), (8, 1), (4, 2), (2, 4),
                                         (-1, 2), (1, 1), (3, 2), (2, 0)])
def test_build_mesh_shapes_equal_jax(corpus, data):
    want = jmesh.build_mesh(corpus, data, devices=jax.devices()[:8])
    got = tmesh.build_mesh(corpus, data, devices=CPU8)
    assert dict(got.shape) == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert len(got.devices) == want.devices.shape[0]
    assert len(got.devices[0]) == want.devices.shape[1]


def test_build_mesh_refusals_and_placement():
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        tmesh.build_mesh(6, 2, devices=CPU8)
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        jmesh.build_mesh(6, 2, devices=jax.devices()[:8])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.build_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.single_device_mesh()
    m = tmesh.build_mesh(2, 2, devices=["cpu", "meta", "cpu", "meta"])
    assert m.devices == ((torch.device("cpu"), torch.device("meta")),
                         (torch.device("cpu"), torch.device("meta")))
    assert m.device == torch.device("cpu") and m.size == 4
    assert m.axis_devices(tmesh.CORPUS_AXIS) == [torch.device("cpu")] * 2
    assert m.axis_devices(tmesh.DATA_AXIS) == [torch.device("cpu"),
                                               torch.device("meta")]
    assert m == tmesh.build_mesh(2, 2, devices=["cpu", "meta"] * 2)
    assert tmesh.single_device_mesh("cpu").shape == {"corpus": 1, "data": 1}
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.check_mesh(object())
    assert tmesh.check_mesh(None) is None


def test_sharding_helpers():
    m = tmesh.build_mesh(4, 2, devices=CPU8)
    x = torch.arange(24.0).reshape(8, 3)
    shards = tmesh.corpus_sharding(x, m)
    assert len(shards) == 4 and all(len(r) == 2 for r in shards)
    for i, row in enumerate(shards):
        for t in row:
            assert torch.equal(t, x[2 * i:2 * i + 2])
    # one copy per distinct device: a repeated device holds one tensor
    assert shards[0][0] is shards[0][1]
    data = tmesh.data_sharding(x, m)
    assert [t.shape[0] for t in data] == [4, 4]
    assert torch.equal(torch.cat(data), x)
    rep = tmesh.replicated_sharding(x, m)
    assert len(rep) == 8 and all(t is rep[0] for t in rep)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.corpus_sharding(x[:7], m)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.data_sharding(x[:7], m)
    assert tmesh.pad_rows(x[:5], 8).shape == (8, 3)
    assert torch.equal(tmesh.pad_rows(x[:5], 8, -1)[5:],
                       torch.full((3, 3), -1.0))
    for n, mult in ((0, 4), (5, 4), (8, 4), (9, 1)):
        assert tmesh.pad_to_multiple(n, mult) == jmesh.pad_to_multiple(
            n, mult)
    assert tmesh.MeshSpec(2, 4) == tmesh.MeshSpec(corpus=2, data=4)
    # core re-exports what the JAX package's core does
    from persian_rag_tpu import core as jcore

    assert set(tcore.__all__) == set(jcore.__all__)
    assert np.array_equal(np.asarray(tcore.build_mesh(2, 1, devices=CPU8)
                                     .shape["corpus"]), 2)
