"""#16's launch geometry and the quantized kernels' ragged K in
ops/quant_matmul.py of the port, on the CPU: `w8a8_geometry` is a function
of (K, N) alone and cuts K into chunks that cover it; int32 partials summed
in its chunks (or in any grouping of them) equal the plain version bit for
bit; the wrappers take a K that is no multiple of 16 (x padded with zeros by
`_pad_x`, which changes no sum) and match the JAX functions there.

Tolerances: w8a8 sums exactly in int32 on both sides: equal. w8a16 / w4a16:
every bf16 x int8 (int4) product is exact in f32, so the two differ only in
the order of the f32 sum: w8a16 rtol 1e-5, atol 1e-5 * max scale * K (as
test_torch_quant_matmul.py), w4a16 atol 1e-5 (as
test_torch_quant_int4.py)."""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from persian_rag_tpu.ops import quant_matmul as jq
from persian_rag_tpu_torch.ops import quant_matmul as tq

# Llama-3.2-1B's gate / up and down shapes (K, N), where #16 is timed
LLAMA = [(2048, 8192), (8192, 2048)]
# one and two strips, a ragged K, a ragged last chunk, more chunks than a
# block of either row regime spans, the least K
EDGES = [(2048, 64), (2048, 128), (100, 256), (2056, 8192), (8200, 2048),
         (20000, 128), (1, 64)]


@pytest.mark.parametrize("k,n", LLAMA + EDGES)
def test_w8a8_geometry_covers_k(k, n):
    """Chunks of a multiple of 32 rows, at most 1,024 (the K rows a block
    holds in registers), that cover K exactly with a ragged last one; 256
    units (about two per SM of the H100) at both Llama shapes."""
    geo = tq.w8a8_geometry(k, n)
    assert geo.strips == n // 64 and geo.tickets == geo.strips
    assert geo.units == geo.strips * geo.chunks
    assert geo.k_chunk % 32 == 0 and geo.k_chunk <= 1024
    assert (geo.chunks - 1) * geo.k_chunk < k <= geo.chunks * geo.k_chunk
    assert tq.w8a8_geometry(k, n) == geo
    if (k, n) in LLAMA:
        assert geo.units == 256 and geo.k_chunk == 1024


def test_w8a8_geometry_is_a_function_of_k_and_n(monkeypatch):
    """The launch takes its chunk from `w8a8_geometry(K, N)` and from
    nothing else, at every row count; the int32 sums scratch holds rows * N
    values when there is more than one chunk, and x reaches the kernel
    padded to a multiple of 16 values."""
    assert list(inspect.signature(tq.w8a8_geometry).parameters) == ["k", "n"]
    launched, scratch = [], []
    monkeypatch.setattr(tq.w8a8_cuda, "launches", tq.w8a8_cuda.launches)
    monkeypatch.setattr(tq, "_check_cuda", lambda *a, **kw: None)

    def fake_scratch(dev, ints, tickets):
        scratch.append((ints, tickets))
        return torch.zeros(max(ints, 4)), torch.zeros(tickets)

    monkeypatch.setattr(tq, "_w8a8_scratch", fake_scratch)
    monkeypatch.setattr(tq, "_launch",
                        lambda name, dev, *args: launched.append((name, args)))
    k, n = 8200, 2048
    geo = tq.w8a8_geometry(k, n)
    rows = (1, 3, 8, 64, 256)
    for b in rows:
        tq.w8a8_cuda(torch.zeros((b, k), dtype=torch.int8),
                     torch.zeros((k, n), dtype=torch.int8), torch.ones((1, n)))
    # (x, values, scale, sums, tickets, out, rows, K, N, k_chunk)
    assert {name for name, _ in launched} == {"prt_w8a8"}
    assert [a[6] for _, a in launched] == list(rows)
    assert {a[7:] for _, a in launched} == {(k, n, geo.k_chunk)}
    assert scratch == [(b * n, geo.strips) for b in rows]
    assert tq.w8a8_cuda.launches == len(rows)


def _int32_chunked(x_q, values, scale, k_chunk, group=1):
    """f32(sum of int32 partials of K chunks of k_chunk rows, `group`
    chunks a partial) * scale: the kernel's order of the exact sum."""
    acc = torch.zeros((x_q.shape[0], values.shape[1]), dtype=torch.int32)
    span = k_chunk * group
    for k0 in range(0, values.shape[0], span):
        acc += (x_q[:, k0:k0 + span].long()
                @ values[k0:k0 + span].long()).to(torch.int32)
    return acc.float() * scale


@pytest.mark.parametrize("k,n", [(100, 256), (2056, 128), (8200, 64),
                                 (4096, 128)])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_w8a8_chunked_int32_sum_equals_plain(rng, k, n, group):
    """Whatever the grouping of the geometry's chunks into a block's span,
    the int32 partials add up to the plain version's bits (int32 sums are
    exact while 127^2 K < 2^31), at full-scale int8 values where the sum
    passes 2^24."""
    x_q = torch.tensor(rng.integers(-127, 128, (5, k)).astype(np.int8))
    x_q[0] = 127
    values = torch.tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    values[:, 0] = 127
    scale = torch.tensor(rng.random((1, n)).astype(np.float32) * 0.01)
    geo = tq.w8a8_geometry(k, n)
    got = _int32_chunked(x_q, values, scale, geo.k_chunk, group)
    assert torch.equal(got, tq.PLAIN["w8a8"](x_q, values, scale))
    if k >= 4096:
        assert float(got[0, 0] / scale[0, 0]) > 2 ** 24


@pytest.mark.parametrize("halves", [False, True])
@pytest.mark.parametrize("k", [100, 2056, 2048])
def test_pad_x_changes_no_sum(rng, k, halves):
    """`_pad_x` gives each row (int4: each half) a multiple of 16 values,
    zeros past the real ones; the padded x against the weights with zero
    rows in the same places is the same product. A K that needs no padding
    returns x itself."""
    x = torch.tensor(rng.standard_normal((3, k)).astype(np.float32))
    xp = tq._pad_x(x, halves=halves)
    half = k // 2 if halves else k
    pad = -half % 16
    if pad == 0:
        assert xp is x
        return
    assert xp.shape == (3, k + (2 if halves else 1) * pad)
    w = torch.tensor(rng.standard_normal((k, 7)).astype(np.float32))
    if halves:
        zeros = torch.zeros((pad, 7))
        wp = torch.cat([w[:half], zeros, w[half:], zeros])
        assert torch.equal(xp[:, half:half + pad], torch.zeros((3, pad)))
        assert torch.equal(xp[:, half + pad:2 * half + pad], x[:, half:])
    else:
        wp = torch.cat([w, torch.zeros((pad, 7))])
        assert torch.equal(xp[:, :k], x)
    assert torch.equal(xp[:, -pad:], torch.zeros((3, pad)))
    np.testing.assert_allclose((xp.double() @ wp.double()).numpy(),
                               (x.double() @ w.double()).numpy(), rtol=1e-12)


def _quantized(rng, kind, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    if kind == "w4a16":
        packed, scale = jq.quantize_weight_int4(jnp.asarray(w))
        return np.asarray(packed), np.asarray(scale)
    values, scale = jq.quantize_weight(jnp.asarray(w), axis=0)
    return np.asarray(values), np.asarray(scale)


@pytest.mark.parametrize("kind", ["w8a8", "w8a16", "w4a16"])
@pytest.mark.parametrize("k", [100, 2056])
def test_ragged_k_matches_jax(rng, kind, k):
    """At a K that is no multiple of 16 the JAX functions compute (Pallas
    interpret); the port's route reaches the same kernel and its plain
    version matches them."""
    n = 256
    values, scale = _quantized(rng, kind, k, n)
    x = rng.standard_normal((3, k)).astype(np.float32)
    assert tq.kernel_route(3, k, n, kind=kind) == kind
    jfn = {"w8a8": jq.w8a8_matmul, "w8a16": jq.w8a16_matmul,
           "w4a16": jq.w4a16_matmul}[kind]
    tfn = {"w8a8": tq.w8a8_matmul, "w8a16": tq.w8a16_matmul,
           "w4a16": tq.w4a16_matmul}[kind]
    xin = x if kind == "w8a8" else jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jfn(jnp.asarray(xin), jnp.asarray(values),
                          jnp.asarray(scale), interpret=True))
    tx = torch.tensor(x) if kind == "w8a8" else torch.tensor(x).bfloat16()
    got = tfn(tx, torch.tensor(values), torch.tensor(scale)).numpy()
    assert got.shape == (3, n)
    if kind == "w8a8":
        np.testing.assert_array_equal(got, want)
    elif kind == "w8a16":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(scale.max()) * k)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["w8a16", "w8a16_splitk", "w4a16", "w8a8"])
def test_cuda_wrappers_take_a_ragged_k(name):
    """The (K, N) kernel wrappers no longer refuse a K that is no multiple
    of 16 (of 32 for int4), nor a row that is not 16-byte aligned (a slice
    of such an x): on CPU tensors they get as far as the device check,
    which comes last, and count no launch."""
    k, n = 100, 128
    x = torch.zeros((3, k), dtype=torch.int8 if name == "w8a8"
                    else torch.bfloat16)[1:]
    values = torch.zeros((k // 2 if name == "w4a16" else k, n),
                         dtype=torch.int8)
    before = tq.KERNELS[name].launches
    with pytest.raises(ValueError, match="the CUDA kernel needs CUDA tensors"):
        tq.KERNELS[name](x, values, torch.ones((1, n)))
    assert tq.KERNELS[name].launches == before


def test_nt_wrapper_still_needs_k_a_multiple_of_16():
    """#15 reads (N, K) weight rows with 16-byte loads: a ragged K raises
    the limit by name, before the device check."""
    with pytest.raises(ValueError, match="K=100 must be a multiple of 16"):
        tq.KERNELS["w8a16_nt"](torch.zeros((1, 100), dtype=torch.bfloat16),
                               torch.zeros((64, 100), dtype=torch.int8),
                               torch.ones((64, 1)))


def test_w8a8_refuses_a_k_past_the_int32_sum():
    """127^2 K must stay below 2^31: the wrapper names the limit."""
    k = tq.W8A8_MAX_K + 1
    assert tq.W8A8_MAX_K == 133_144
    with pytest.raises(ValueError, match="exceeds 133144"):
        tq.w8a8_cuda(torch.zeros((1, k), dtype=torch.int8),
                     torch.zeros((k, 64), dtype=torch.int8),
                     torch.ones((1, 64)))


@pytest.mark.parametrize("name", ["one-tile", "two-blocks", "no-hint",
                                  "hint-128"])
def test_quant_ab_variants_edit_the_kernel_source(name):
    """Each `quant_ab.py --variants` copy of csrc/quant_matmul.cu applies
    every edit exactly once; an unknown name is refused before anything is
    built."""
    from persian_rag_tpu_torch.ops import _build
    from persian_rag_tpu_torch.scripts import quant_ab

    assert sorted(quant_ab.W8A8_VARIANTS) == sorted(
        ["one-tile", "two-blocks", "no-hint", "hint-128"])
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    out = quant_ab.variant_source(src, name)
    for old, new in quant_ab.W8A8_VARIANTS[name]:
        assert src.count(old) == 1 and new in out
    with pytest.raises(SystemExit):
        quant_ab.main(["--variants", "no-such-variant"])


def test_quant_ab_bounds_w8a8_at_the_int8_rate():
    """#16's bound: int8 x, int8 weights, the f32 scale and output once at
    3.35 TB/s, or 2 B K N operations at 1,979 TOP/s, whichever is larger:
    the bytes at every timed row count of Llama-3.2-1B's gate / up shape."""
    from persian_rag_tpu_torch.scripts import quant_ab

    for b in quant_ab.TIMED_ROWS:
        got = quant_ab._bound("w8a8", b, 2048, 8192)
        n_bytes = b * 2048 + 2048 * 8192 + 4 * 8192 + 4 * b * 8192
        assert got["bound_by"] == "bytes"
        assert got["bound_ms"] == pytest.approx(1e3 * n_bytes / 3.35e12,
                                                rel=1e-12)
        # the operations' time, below the bytes' even at 256 rows
        assert 1e3 * 2 * b * 2048 * 8192 / 1979e12 < got["bound_ms"]
