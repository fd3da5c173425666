"""ops/quant_matmul.py of the port against the JAX package: the same numpy
inputs go through `persian_rag_tpu.ops.quant_matmul` (its Pallas kernels in
interpret mode) and the port (CPU tensors: the kernels' plain versions).
Every product bf16 x int8 is exact in f32, so the two differ only in the
order of the f32 sum: rtol 1e-5, atol 1e-5 * max scale * K."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from persian_rag_tpu.ops import quant_matmul as jq
from persian_rag_tpu_torch.ops import quant_matmul as tq

K, N = 256, 384


def _weights(rng, k, n, nt=False):
    w = (rng.standard_normal((n, k) if nt else (k, n)) * 0.05).astype(np.float32)
    values, scale = jq.quantize_weight(jnp.asarray(w), axis=1 if nt else 0)
    return w, np.asarray(values), np.asarray(scale)


def _close(got, want, scale, k):
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(scale.max()) * k)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_bit_equal(rng, axis):
    w = (rng.standard_normal((96, 160)) * 0.3).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero channel hits the 1e-8 floor
    w[5, :] = 0.0
    jv, js = jq.quantize_weight(jnp.asarray(w), axis=axis)
    tv, ts = tq.quantize_weight(torch.tensor(w), axis=axis)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == js.shape
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("b", [1, 5, 16])
@pytest.mark.parametrize("nt", [False, True])
def test_kernel_route_matches_pallas_interpret(rng, b, nt):
    _, values, scale = _weights(rng, K, N, nt)
    x = rng.standard_normal((b, K)).astype(np.float32)
    jfn = jq.w8a16_matmul_nt if nt else jq.w8a16_matmul
    tfn = tq.w8a16_matmul_nt if nt else tq.w8a16_matmul
    want = np.asarray(jfn(jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(values), jnp.asarray(scale),
                          interpret=True))
    assert tq.kernel_route(b, K, N, nt) == ("w8a16_nt" if nt else "w8a16")
    got = tfn(torch.tensor(x).bfloat16(), torch.tensor(values),
              torch.tensor(scale))
    assert got.dtype == torch.float32 and got.shape == (b, N)
    _close(got.numpy(), want, scale, K)


@pytest.mark.parametrize("nt", [False, True])
def test_leading_dims(rng, nt):
    _, values, scale = _weights(rng, K, N, nt)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    jfn = jq.w8a16_matmul_nt if nt else jq.w8a16_matmul
    tfn = tq.w8a16_matmul_nt if nt else tq.w8a16_matmul
    want = np.asarray(jfn(jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(values), jnp.asarray(scale),
                          interpret=True))
    # f32 activations are rounded to bf16 by the port, as by the JAX package
    got = tfn(torch.tensor(x), torch.tensor(values), torch.tensor(scale))
    assert got.shape == (2, 3, N)
    _close(got.numpy(), want, scale, K)


def test_split_k_shape(rng):
    k, n = 8192, 1024
    _, values, scale = _weights(rng, k, n)
    x = rng.standard_normal((2, k)).astype(np.float32)
    want = np.asarray(jq.w8a16_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(values),
        jnp.asarray(scale), interpret=True))
    assert tq.kernel_route(2, k, n) == "w8a16_splitk"
    got = tq.w8a16_matmul(torch.tensor(x).bfloat16(), torch.tensor(values),
                          torch.tensor(scale))
    _close(got.numpy(), want, scale, k)


@pytest.mark.parametrize("rows,k,n,nt,route", [
    (1, 2048, 512, False, "w8a16"),
    (256, 2048, 8192, False, "w8a16"),
    (257, 2048, 8192, False, None),
    (8, 2048, 130, False, None),
    (8, 8192, 2048, False, "w8a16_splitk"),
    (8, 8192, 1152, False, "w8a16"),       # N % 1024 != 0
    (8, 8320, 2048, False, "w8a16"),       # K % 256 != 0
    (8, 4096, 2048, False, "w8a16"),       # K below the split threshold
    (8, 2048, 128_256, True, "w8a16_nt"),
    (300, 2048, 128_256, True, None),
    (8, 8192, 2048, True, "w8a16_nt"),
])
def test_routing(rows, k, n, nt, route):
    assert tq.kernel_route(rows, k, n, nt) == route


@pytest.mark.parametrize("rows,n", [(257, 384), (4, 130)])
def test_library_route_matches_jax(rng, rows, n):
    _, values, scale = _weights(rng, K, n)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jq.w8a16_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(values),
        jnp.asarray(scale), interpret=True))
    got = tq.w8a16_matmul(torch.tensor(x).bfloat16(), torch.tensor(values),
                          torch.tensor(scale))
    _close(got.numpy(), want, scale, K)


def test_reference_infers_nt_and_refuses_square(rng):
    _, values, scale = _weights(rng, K, N, nt=True)
    x = torch.tensor(rng.standard_normal((3, K)).astype(np.float32))
    a = tq.dequant_matmul_reference(x, torch.tensor(values), torch.tensor(scale))
    b = tq.dequant_matmul_reference(x, torch.tensor(values),
                                    torch.tensor(scale), nt=True)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="square"):
        tq.dequant_matmul_reference(
            x, torch.zeros((K, K), dtype=torch.int8), torch.ones((1, K)))


@pytest.mark.parametrize("call", [
    lambda: tq.quantize_weight_int4(torch.zeros(3, 4)),
    lambda: tq.w4a16_matmul(torch.zeros((1, 32)),
                            torch.zeros((8, 128), dtype=torch.int8),
                            torch.ones((1, 128))),
    lambda: tq.w8a8_matmul(torch.zeros((1, 64)),
                           torch.zeros((64, 130), dtype=torch.int8),
                           torch.ones((1, 130))),
])
def test_leftovers_raise(call):
    """The int4 and w8a8 entries, ported, refuse what they cannot compute:
    an odd K to pack, activations of another K than the packed weights,
    and (as the JAX package's block picker) a w8a8 N % 128 != 0."""
    with pytest.raises(ValueError, match="even K|K=|multiple of 128"):
        call()


@pytest.mark.parametrize("name", ["w8a16", "w8a16_nt", "w8a16_splitk"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper never computes on the host: CPU tensors only reach
    the plain version through the dispatcher."""
    x = torch.zeros((1, 64), dtype=torch.bfloat16)
    values = torch.zeros((64, 64), dtype=torch.int8)
    before = tq.KERNELS[name].launches
    with pytest.raises(ValueError, match="CUDA"):
        tq.KERNELS[name](x, values, torch.ones((1, 64)))
    assert tq.KERNELS[name].launches == before


def test_dispatch_checks_shapes_and_devices():
    with pytest.raises(ValueError, match="K="):
        tq.w8a16_matmul(torch.zeros((1, 32)), torch.zeros((64, 128), dtype=torch.int8),
                        torch.ones((1, 128)))
    with pytest.raises(ValueError, match="one device"):
        tq.w8a16_matmul(torch.zeros((1, 64)),
                        torch.zeros((64, 128), dtype=torch.int8, device="meta"),
                        torch.ones((1, 128)))
