"""int4 weights (w4a16) and int8 activations (w8a8) in ops/quant_matmul.py of
the port, against the JAX package: the same numpy inputs go through
`persian_rag_tpu.ops.quant_matmul` (its Pallas kernels in interpret mode)
and the port (CPU tensors: the kernels' plain versions).

Tolerances: int4 packing is bit-equal. w4a16: every bf16 x int4 product is
exact in f32, so the two differ only in the order of the f32 sum: atol 1e-5
(outputs of magnitude ~1). w8a8: the int32 sum is exact and both sides
quantize the activations with the same f32 arithmetic (round half to even),
so the results are equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from persian_rag_tpu.ops import quant_matmul as jq
from persian_rag_tpu_torch.ops import quant_matmul as tq

K, N = 256, 384


def _int4(rng, k=K, n=N):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    packed, scale = jq.quantize_weight_int4(jnp.asarray(w))
    return w, np.asarray(packed), np.asarray(scale)


def _int8(rng, k=K, n=N):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    values, scale = jq.quantize_weight(jnp.asarray(w), axis=0)
    return np.asarray(values), np.asarray(scale)


@pytest.mark.parametrize("k,n", [(96, 160), (2, 128), (256, 384)])
def test_quantize_weight_int4_bit_equal(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero channel hits the 1e-8 floor
    w[0, 3] = 40.0  # a channel whose other rows round to 0
    jp, js = jq.quantize_weight_int4(jnp.asarray(w))
    tp, ts = tq.quantize_weight_int4(torch.tensor(w))
    assert tp.dtype == torch.int8 and tp.shape == (k // 2, n)
    assert ts.dtype == torch.float32 and ts.shape == js.shape
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_unpack_int4_every_byte():
    """Both nibbles of all 256 byte values, sign-extended as the JAX
    package's `_unpack_int4` does; -8 (a high or low nibble of 8) occurs."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    jlo, jhi = jq._unpack_int4(jnp.asarray(packed).astype(jnp.int32))
    tlo, thi = tq.unpack_int4(torch.tensor(packed))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert tlo.min() == thi.min() == -8 and tlo.max() == thi.max() == 7


@pytest.mark.parametrize("rows", [1, 3, 8, 300])
def test_w4a16_matches_pallas_interpret(rng, rows):
    _, packed, scale = _int4(rng)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jq.w4a16_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scale), interpret=True))
    got = tq.w4a16_matmul(torch.tensor(x).bfloat16(), torch.tensor(packed),
                          torch.tensor(scale))
    assert got.dtype == torch.float32 and got.shape == (rows, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_w4a16_leading_dims_and_library_route(rng):
    _, packed, scale = _int4(rng, n=130)  # N % 128 != 0: the library route
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    want = np.asarray(jq.w4a16_matmul(jnp.asarray(x), jnp.asarray(packed),
                                      jnp.asarray(scale), interpret=True))
    # f32 activations are rounded to bf16 by the port, as by the JAX package
    got = tq.w4a16_matmul(torch.tensor(x), torch.tensor(packed),
                          torch.tensor(scale))
    assert got.shape == (2, 3, 130)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 3, 8, 256])
def test_w8a8_equal_to_pallas_interpret(rng, rows):
    values, scale = _int8(rng)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    x[0, 5] = 0.0
    want = np.asarray(jq.w8a8_matmul(jnp.asarray(x), jnp.asarray(values),
                                     jnp.asarray(scale), interpret=True))
    got = tq.w8a8_matmul(torch.tensor(x), torch.tensor(values),
                         torch.tensor(scale))
    assert got.dtype == torch.float32 and got.shape == (rows, N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_w8a8_quantizes_rows_as_jax(rng):
    x = rng.standard_normal((5, K)).astype(np.float32)
    x[1] = 0.0  # an all-zero row hits the 1e-8 floor
    x[2, :4] = [0.5, -0.5, 1.5, 2.5]  # halves round to even
    xf = jnp.asarray(x)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    jscale = jnp.maximum(amax, 1e-8) / 127.0
    jq_x = jnp.clip(jnp.round(xf / jscale), -127, 127).astype(jnp.int8)
    tq_x, tscale = tq.quantize_rows(torch.tensor(x))
    np.testing.assert_array_equal(tq_x.numpy(), np.asarray(jq_x))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


def test_w8a8_plain_sum_is_exact(rng):
    """The plain version's int32 sum equals an int64 numpy product even
    where it passes 2^24 (f32 could not hold it)."""
    k, n = 4096, 128
    xq = np.full((2, k), 127, np.int8)
    xq[1, ::2] = -127
    values = rng.integers(100, 128, (k, n)).astype(np.int8)
    exact = xq.astype(np.int64) @ values.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    scale = np.ones((1, n), np.float32)
    got = tq.PLAIN["w8a8"](torch.tensor(xq), torch.tensor(values),
                           torch.tensor(scale))
    np.testing.assert_array_equal(
        got.numpy(), exact.astype(np.int32).astype(np.float32))


def test_w8a8_above_256_rows_takes_the_w8a16_route(rng):
    """Past the kernel's row limit the JAX package quantizes no
    activations: the w8a16 convert-and-matmul route."""
    values, scale = _int8(rng, n=130)  # N % 128 != 0 is fine on that route
    x = rng.standard_normal((300, K)).astype(np.float32)
    args = (torch.tensor(values), torch.tensor(scale))
    got = tq.w8a8_matmul(torch.tensor(x), *args)
    assert torch.equal(got, tq.dequant_matmul_reference(torch.tensor(x), *args,
                                                        nt=False))
    want = np.asarray(jq.w8a8_matmul(jnp.asarray(x), jnp.asarray(values),
                                     jnp.asarray(scale), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(scale.max()) * K)


@pytest.mark.parametrize("rows,k,n,kind,route", [
    (1, 2048, 2048, "w4a16", "w4a16"),
    (3, 2048, 512, "w4a16", "w4a16"),
    (8, 8192, 2048, "w4a16", "w4a16"),    # no split-K route for int4
    (300, 2048, 8192, "w4a16", None),
    (8, 2048, 130, "w4a16", None),
    (1, 2048, 8192, "w8a8", "w8a8"),
    (8, 8192, 2048, "w8a8", "w8a8"),
    (300, 2048, 8192, "w8a8", None),
    (300, 2048, 130, "w8a8", None),
])
def test_routing(rows, k, n, kind, route):
    assert tq.kernel_route(rows, k, n, kind=kind) == route


def test_w8a8_refuses_unaligned_output_width(rng):
    with pytest.raises(ValueError, match="multiple of 128"):
        tq.kernel_route(8, 2048, 130, kind="w8a8")
    with pytest.raises(ValueError, match="weight format"):
        tq.kernel_route(8, 2048, 128, kind="w2a16")


@pytest.mark.parametrize("name,x_dtype,rows", [
    ("w4a16", torch.bfloat16, 32), ("w8a8", torch.int8, 64)])
def test_cuda_wrappers_refuse_cpu_tensors(name, x_dtype, rows):
    """A kernel wrapper never computes on the host: CPU tensors only reach
    the plain version through the dispatcher."""
    x = torch.zeros((1, 64), dtype=x_dtype)
    values = torch.zeros((rows, 64), dtype=torch.int8)
    before = tq.KERNELS[name].launches
    with pytest.raises(ValueError, match="CUDA"):
        tq.KERNELS[name](x, values, torch.ones((1, 64)))
    assert tq.KERNELS[name].launches == before


# -- #18's split-K geometry and its chunk order -----------------------------------

# Llama-3.2-1B's int4 projections (K, N): k / v, q / o, gate / up, down
LLAMA_INT4 = [(2048, 512), (2048, 2048), (2048, 8192), (8192, 2048)]
# the same projections cut to a small K (the geometry still cuts them)
SMALL_INT4 = [(256, 512), (256, 2048), (256, 8192), (1024, 2048)]


def test_w4a16_geometry_is_a_function_of_k_and_n(monkeypatch):
    """The launch takes its chunks from `w4a16_geometry(K, N)` and from
    nothing else: the same k_chunk reaches the kernel at every row count."""
    import inspect
    assert list(inspect.signature(tq.w4a16_geometry).parameters) == ["k", "n"]
    launched = []
    monkeypatch.setattr(tq.w4a16_cuda, "launches", tq.w4a16_cuda.launches)
    monkeypatch.setattr(tq, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tq, "_tile2d_scratch",
                        lambda dev, floats, tickets: (torch.zeros(floats),
                                                      torch.zeros(tickets)))
    monkeypatch.setattr(tq, "_launch",
                        lambda name, dev, *args: launched.append(args))
    k, n = 8192, 2048
    packed = torch.zeros((k // 2, n), dtype=torch.int8)
    for rows in (1, 3, 8, 64, 256):
        tq.w4a16_cuda(torch.zeros((rows, k), dtype=torch.bfloat16), packed,
                      torch.ones((1, n)))
    # (x, packed, scale, part, tickets, out, rows, K, N, k_chunk)
    assert [a[6] for a in launched] == [1, 3, 8, 64, 256]
    assert {a[7:] for a in launched} == {
        (k, n, tq.w4a16_geometry(k, n).k_chunk)}


@pytest.mark.parametrize("k,n", LLAMA_INT4 + SMALL_INT4 + [(32, 64), (96, 128)])
def test_w4a16_geometry_fills_the_card(k, n):
    """At least 128 blocks (about one per SM of the H100) at every
    Llama-3.2-1B int4 shape and 256 at the down projection; the chunks
    tile the K/2 packed rows in multiples of 16, at least 64 a chunk
    unless one chunk takes them all."""
    geo = tq.w4a16_geometry(k, n)
    kh, strips = k // 2, n // 64
    assert geo.blocks == strips * geo.chunks and geo.tickets == strips
    assert geo.k_chunk % 16 == 0
    assert (geo.chunks - 1) * geo.k_chunk < kh <= geo.chunks * geo.k_chunk
    assert geo.k_chunk >= 64 or geo.chunks == 1
    assert tq.w4a16_geometry(k, n) == geo
    if (k, n) in LLAMA_INT4:
        assert geo.blocks >= (256 if k == 8192 else 128)


@pytest.mark.parametrize("k,n", SMALL_INT4)
@pytest.mark.parametrize("rows", [1, 3, 8, 64])
def test_w4a16_chunked_plain_matches_pallas_interpret(rng, rows, k, n):
    """The plain version in #18's chunk order against the JAX
    `w4a16_matmul` (Pallas interpret). Every bf16 x int4 product is exact
    in f32, so each side lies within the f32 summation bound of the exact
    result, (K + 2) 2^-24 sum_k |x w| scale (K - 1 additions and the
    scale's product, each rounding once): the two within twice that."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    packed, scale = (np.asarray(a) for a in
                     jq.quantize_weight_int4(jnp.asarray(w)))
    x = rng.standard_normal((rows, k)).astype(np.float32)
    xb = torch.tensor(x).bfloat16()
    assert tq.w4a16_geometry(k, n).chunks > 1
    got = tq.w4a16_chunked_plain(xb, torch.tensor(packed), torch.tensor(scale))
    want = np.asarray(jq.w4a16_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scale), interpret=True))
    lo, hi = tq.unpack_int4(torch.tensor(packed))
    wq = torch.cat([lo, hi]).double()
    xd = xb.double()
    bound = (k + 2) * 2.0 ** -24 * (xd.abs() @ wq.abs()) * torch.tensor(
        scale).double()
    exact = (xd @ wq) * torch.tensor(scale).double()
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((torch.tensor(want).double() - got.double()).abs()
                 <= 2 * bound).all())
