"""The strip x K-chunk grid of #14 and #17 and #15's geometry query in
ops/quant_matmul.py of the port, against the JAX package: the same numpy
inputs go through `persian_rag_tpu.ops.quant_matmul` (its Pallas split-K
kernel in interpret mode) and the port's plain version in the kernels'
chunk order (CPU tensors).

Tolerance: every bf16 x int8 product is exact in f32, so each side lies
within the f32 summation bound of the exact result, (K + 2) 2^-24 sum_k
|x w| scale (K - 1 additions and the scale's product, each rounding once),
and the two within twice that."""
import inspect
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from persian_rag_tpu.ops import quant_matmul as jq
from persian_rag_tpu_torch.ops import quant_matmul as tq

# Llama-3.2-1B's int8 projections (K, N): k / v, q / o, gate / up, down
LLAMA = [(2048, 512), (2048, 2048), (2048, 8192), (8192, 2048)]
# the down projection at other widths, and shapes cut to a small K
OTHER = [(8192, 1024), (8192, 8192), (1024, 2048), (256, 512), (64, 64),
         (8208, 2048)]


def _weights(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    values, scale = jq.quantize_weight(jnp.asarray(w), axis=0)
    return np.asarray(values), np.asarray(scale)


def _bound(xb, values, scale, k):
    xd, wd = xb.double(), torch.tensor(values).double()
    sd = torch.tensor(scale).double()
    return (xd @ wd) * sd, (k + 2) * 2.0 ** -24 * (xd.abs() @ wd.abs()) * sd


def test_w8a16_splitk_geometry_is_a_function_of_k_and_n(monkeypatch):
    """The launch takes its chunks from `w8a16_splitk_geometry(K, N)` and
    from nothing else: the same k_chunk reaches the kernel at every row
    count, and the partials are sized by the chunk count."""
    assert list(inspect.signature(tq.w8a16_splitk_geometry).parameters) == [
        "k", "n"]
    launched, scratch = [], []
    monkeypatch.setattr(tq.w8a16_splitk_cuda, "launches",
                        tq.w8a16_splitk_cuda.launches)
    monkeypatch.setattr(tq, "_check_cuda", lambda *a, **k: None)

    def fake_scratch(dev, floats, tickets):
        scratch.append((floats, tickets))
        return torch.zeros(floats), torch.zeros(tickets)

    monkeypatch.setattr(tq, "_tile2d_scratch", fake_scratch)
    monkeypatch.setattr(tq, "_launch",
                        lambda name, dev, *args: launched.append((name, args)))
    k, n = 8192, 2048
    geo = tq.w8a16_splitk_geometry(k, n)
    values = torch.zeros((k, n), dtype=torch.int8)
    for rows in (1, 3, 8, 9, 64, 72, 256):
        tq.w8a16_splitk_cuda(torch.zeros((rows, k), dtype=torch.bfloat16),
                             values, torch.ones((1, n)))
    # (x, values, scale, part, tickets, out, rows, K, N, k_chunk)
    assert {name for name, _ in launched} == {"prt_w8a16_splitk"}
    assert [a[6] for _, a in launched] == [1, 3, 8, 9, 64, 72, 256]
    assert {a[7:] for _, a in launched} == {(k, n, geo.k_chunk)}
    assert scratch == [(geo.chunks * rows * n, geo.tickets)
                       for rows in (1, 3, 8, 9, 64, 72, 256)]


@pytest.mark.parametrize("k,n", LLAMA + OTHER)
def test_w8a16_splitk_geometry_fills_the_card(k, n):
    """256 blocks (two per SM of the H100) at every Llama-3.2-1B int8
    shape, the down projection the one `kernel_route` sends to #17; the
    chunks tile the K rows in multiples of 16, at least 64 a chunk unless
    one chunk takes them all."""
    geo = tq.w8a16_splitk_geometry(k, n)
    strips = n // 64
    assert geo.blocks == strips * geo.chunks and geo.tickets == strips
    assert geo.k_chunk % 16 == 0
    assert (geo.chunks - 1) * geo.k_chunk < k <= geo.chunks * geo.k_chunk
    assert geo.k_chunk >= 64 or geo.chunks == 1
    assert tq.w8a16_splitk_geometry(k, n) == geo
    if (k, n) in LLAMA:
        assert geo.blocks == 256
    if (k, n) == (8192, 2048):
        assert tq.kernel_route(8, k, n) == "w8a16_splitk"
        assert (geo.chunks, geo.k_chunk) == (8, 1024)


# (K, N, k_chunk): the geometry's chunk, an explicit one dividing K, and an
# explicit one that leaves a shorter last chunk
CHUNKED = [(2048, 256, None), (1024, 512, 256), (2048, 128, 640)]


@pytest.mark.parametrize("k,n,k_chunk", CHUNKED)
@pytest.mark.parametrize("rows", [1, 3, 8, 64])
def test_w8a16_splitk_chunked_plain_matches_pallas_interpret(rng, rows, k, n,
                                                             k_chunk):
    """The plain version in #17's chunk order against the JAX split-K
    kernel (`_w8a16_2d_call`, Pallas interpret, its K tiles of 256 rows)
    and against `dequant_matmul_reference`, each within twice the f32
    summation bound, and itself within the bound of the exact result."""
    values, scale = _weights(rng, k, n)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    xb = torch.tensor(x).bfloat16()
    if k_chunk is None:
        assert tq.w8a16_splitk_geometry(k, n).chunks > 1
    got = tq.w8a16_splitk_chunked_plain(xb, torch.tensor(values),
                                        torch.tensor(scale), k_chunk)
    exact, bound = _bound(xb, values, scale, k)
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    assert bool(((got.double() - exact).abs() <= bound).all())
    want = np.asarray(jq._w8a16_2d_call(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(values),
        jnp.asarray(scale), block_n=n, block_k=256, interpret=True))
    assert bool(((torch.tensor(want).double() - got.double()).abs()
                 <= 2 * bound).all())
    ref = tq.dequant_matmul_reference(xb, torch.tensor(values),
                                      torch.tensor(scale), nt=False)
    assert bool(((ref.double() - got.double()).abs() <= 2 * bound).all())


def test_w8a16_splitk_chunked_plain_sums_chunks_in_order(rng):
    """With the geometry's chunk it is the tile plain version at that tile,
    bit for bit: the same matmuls summed in the same order."""
    k, n = 2048, 256
    values, scale = (torch.tensor(a) for a in _weights(rng, k, n))
    xb = torch.tensor(rng.standard_normal((5, k)).astype(np.float32)).bfloat16()
    geo = tq.w8a16_splitk_geometry(k, n)
    assert torch.equal(tq.w8a16_splitk_chunked_plain(xb, values, scale),
                       tq.w8a16_2d_plain(xb, values, scale, geo.k_chunk))


# #14's launches (`w8a16_cuda`, the K < 8192 products): Llama-3.2-1B's k / v,
# q / o and gate / up projections with their (strips, chunks, k_chunk), then
# the least N (one strip), the least K (one chunk) and a ragged last chunk
W8A16_GEOMETRY = [
    ((2048, 512), (8, 32, 64)), ((2048, 2048), (32, 8, 256)),
    ((2048, 8192), (128, 2, 1024)), ((2048, 64), (1, 32, 64)),
    ((16, 64), (1, 1, 16)), ((2064, 512), (8, 26, 80)),
]


@pytest.mark.parametrize("shape,want", W8A16_GEOMETRY)
def test_w8a16_launches_the_splitk_body_at_every_row_count(monkeypatch, shape,
                                                            want):
    """#14 launches its C entry at `w8a16_splitk_geometry(K, N)` whatever
    the row count, with partials sized by the chunk count: so the order of
    every column's sum is fixed by (K, N) alone and a row alone keeps the
    bits it has inside a batch (held on the card by chip_smoke.py; the
    CPU library matmul of the plain version is not batch-invariant)."""
    k, n = shape
    geo = tq.w8a16_splitk_geometry(k, n)
    assert (geo.tickets, geo.chunks, geo.k_chunk) == want
    assert geo.blocks == geo.tickets * geo.chunks
    if (k, n) in LLAMA:
        assert geo.blocks == 256 and tq.kernel_route(8, k, n) == "w8a16"
    launched, scratch = [], []
    monkeypatch.setattr(tq.w8a16_cuda, "launches", tq.w8a16_cuda.launches)
    monkeypatch.setattr(tq, "_check_cuda", lambda *a, **kw: None)

    def fake_scratch(dev, floats, tickets):
        scratch.append((floats, tickets))
        return torch.zeros(floats), torch.zeros(tickets)

    monkeypatch.setattr(tq, "_tile2d_scratch", fake_scratch)
    monkeypatch.setattr(tq, "_launch",
                        lambda name, dev, *args: launched.append((name, args)))
    values = torch.zeros((k, n), dtype=torch.int8)
    rows = (1, 9, 256)
    for b in rows:
        tq.w8a16_cuda(torch.zeros((b, k), dtype=torch.bfloat16), values,
                      torch.ones((1, n)))
    # (x, values, scale, part, tickets, out, rows, K, N, k_chunk)
    assert {name for name, _ in launched} == {"prt_w8a16"}
    assert [a[6] for _, a in launched] == list(rows)
    assert {a[7:] for _, a in launched} == {(k, n, geo.k_chunk)}
    assert scratch == [(geo.chunks * b * n if geo.chunks > 1 else 0,
                        geo.tickets) for b in rows]


@pytest.mark.parametrize("shape,want", W8A16_GEOMETRY)
def test_w8a16_chunked_plain_within_bound_at_14s_geometry(rng, shape, want):
    """The plain version in #14's chunk order, 9 rows, lies within the f32
    summation bound of the f64 product at every geometry #14 launches."""
    k, n = shape
    values, scale = _weights(rng, k, n)
    xb = torch.tensor(rng.standard_normal((9, k)).astype(np.float32)
                      ).bfloat16()
    got = tq.w8a16_splitk_chunked_plain(xb, torch.tensor(values),
                                        torch.tensor(scale))
    exact, bound = _bound(xb, values, scale, k)
    assert got.dtype == torch.float32 and got.shape == (9, n)
    assert bool(((got.double() - exact).abs() <= bound).all())
    # the chunk order is the tile plain version's at #14's k_chunk
    assert torch.equal(got, tq.w8a16_2d_plain(
        xb, torch.tensor(values), torch.tensor(scale), want[2]))


def test_w8a16_nt_geometry_is_the_cards():
    """#15's launch geometry is reported by its C entry, which picks the
    kernel for the launch too: there is none to report for a CPU device."""
    with pytest.raises(ValueError, match="geometry is the card's"):
        tq.w8a16_nt_geometry(8, 128_256, torch.device("cpu"))


@pytest.mark.parametrize("name,shape", [
    ("w8a16_nt", (128, 64)), ("w8a16_splitk", (8192, 1024))])
def test_redesigned_wrappers_refuse_cpu_tensors(name, shape):
    """#15 and #17 at shapes of their route still refuse CPU tensors,
    with the message that names the device, and count no launch."""
    x = torch.zeros((2, shape[1] if name == "w8a16_nt" else shape[0]),
                    dtype=torch.bfloat16)
    n = shape[0] if name == "w8a16_nt" else shape[1]
    values = torch.zeros(shape, dtype=torch.int8)
    scale = torch.ones((n, 1) if name == "w8a16_nt" else (1, n))
    before = tq.KERNELS[name].launches
    with pytest.raises(ValueError, match="the CUDA kernel needs CUDA tensors"):
        tq.KERNELS[name](x, values, scale)
    assert tq.KERNELS[name].launches == before


def test_quant_ab_needs_a_card(capsys):
    """The same-call timing script of these kernels measures on the card
    only: on a host without CUDA it stops before building anything."""
    from persian_rag_tpu_torch.scripts import quant_ab

    assert quant_ab.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_quant_ab_compares_saved_outputs(tmp_path, capsys):
    """`--compare` counts, by kernel, the outputs two saved runs share bit
    for bit (the keys both runs hold)."""
    from persian_rag_tpu_torch.scripts import quant_ab

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"w4a16 8192 2048 1": "x", "w4a16 8192 2048 8": "y",
                             "w8a16_nt 2048 128256 1": "z", "w8a16 1 1 1": "q"}))
    b.write_text(json.dumps({"w4a16 8192 2048 1": "x", "w4a16 8192 2048 8": "y",
                             "w8a16_nt 2048 128256 1": "other"}))
    assert quant_ab.main(["--compare", str(a), str(b)]) == 0
    lines = [json.loads(line.split(" ", 1)[1])
             for line in capsys.readouterr().out.splitlines()]
    assert lines == [
        {"kernel": "w4a16", "outputs": 2, "bit_equal": 2},
        {"kernel": "w8a16_nt", "outputs": 1, "bit_equal": 0}]
