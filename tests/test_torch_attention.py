"""The port's attention against the JAX package's, on the CPU.

The same q, k, v (made with numpy from a seed) go through the JAX
``flash_attention`` / ``blockwise_attention``
(``predictionio_tpu/parallel/ring_attention.py``; off the TPU its
``flash_attention`` is ``blockwise_attention``) and through the port's
(``predictionio_tpu_torch/parallel/ring_attention.py``; on a CPU tensor
its ``flash_attention`` runs ``blockwise_attention``, the plain version of
the hand-written kernel ``csrc/flash_attn.cu``).

Tolerances. f32: 1e-5 absolute and relative; both sides compute the same
blocks and carries in f32 and differ only in the order of their sums. bf16:
both round the inputs and the softmax weights to bf16 at the same points, so
an element differs only where an f32 summation-order difference tips a
bf16 rounding; they are held to two bf16 steps (rtol 2**-7, atol 2**-7,
outputs of magnitude up to ~3), and the output dtype is pinned to bf16.

The kernel itself runs only on a card: ``test_kernel_matches_plain_on_the_card``
carries the ``cuda`` marker and skips here; ``chip_smoke.py`` holds the kernel
against its plain version on the card at the serving shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.parallel import ring_attention as jra  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.parallel import ring_attention as tra  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0**-7

#: (B, L, H, D, block_size): the unaligned tails of
#: tests/test_parallel_seq.py at head dims 8, 24 and 64, one aligned case,
#: and L 128 / D 64, the shape at which the TPU takes the Pallas kernel
SHAPES = [
    (2, 25, 2, 8, 10),
    (2, 24, 3, 24, 10),
    (1, 7, 2, 64, 512),
    (2, 32, 4, 8, 8),
    (1, 128, 2, 64, 1024),
    (1, 128, 2, 64, 48),
]


def _qkv(seed, B, L, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(3)]


def _ids(shape):
    return "B{}-L{}-H{}-D{}-bs{}".format(*shape)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_f32_matches_jax(shape, causal):
    B, L, H, D, bs = shape
    arrs = _qkv(sum(shape), B, L, H, D)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    want_flash = np.asarray(jra.flash_attention(jq, jk, jv, causal=causal,
                                                block_size=bs))
    want_block = np.asarray(jra.blockwise_attention(jq, jk, jv, causal=causal,
                                                    block_size=bs))
    got_flash = tra.flash_attention(tq, tk, tv, causal=causal, block_size=bs)
    got_block = tra.blockwise_attention(tq, tk, tv, causal=causal,
                                        block_size=bs)
    for got in (got_flash, got_block):
        assert got.dtype == torch.float32 and got.shape == (B, L, H, D)
        for want in (want_flash, want_block):
            np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                       atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_bf16_matches_jax(shape, causal):
    B, L, H, D, bs = shape
    arrs = _qkv(sum(shape) + 1, B, L, H, D)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    want = jra.blockwise_attention(jq, jk, jv, causal=causal, block_size=bs)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    for got in (tra.flash_attention(tq, tk, tv, causal=causal, block_size=bs),
                tra.blockwise_attention(tq, tk, tv, causal=causal,
                                        block_size=bs)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_cpu_tensor_never_reaches_the_kernel():
    arrs = _qkv(3, 1, 9, 2, 8)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    before = dict(kernels.LAUNCHES)
    lib = kernels._lib
    tra.flash_attention(tq, tk, tv, causal=True)
    assert kernels.LAUNCHES == before
    assert kernels._lib is lib  # nothing was built


@pytest.mark.parametrize("bad", [
    "dtype", "rank", "shape_mismatch", "head_dim_odd", "head_dim_big",
    "empty", "cpu"])
def test_kernel_wrapper_refuses(bad):
    """What the kernel does not take raises before any build or launch."""
    shape, dtype = (1, 16, 2, 8), torch.float32
    if bad == "head_dim_odd":
        shape = (1, 16, 2, 12)
    elif bad == "head_dim_big":
        shape = (1, 16, 1, 136)
    elif bad == "empty":
        shape = (1, 0, 2, 8)
    elif bad == "dtype":
        dtype = torch.float16
    q = torch.zeros(shape, dtype=dtype)
    k, v = torch.zeros_like(q), torch.zeros_like(q)
    if bad == "rank":
        q, k, v = q[0], k[0], v[0]
    elif bad == "shape_mismatch":
        k = torch.zeros(1, 17, 2, 8)
    before = dict(kernels.LAUNCHES)
    match = "CUDA" if bad == "cpu" else "flash_attention_fwd"
    with pytest.raises(ValueError, match=match):
        kernels.flash_attention_fwd(q, k, v, causal=True)
    assert kernels.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the flash-attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(cuda_device, dtype):
    dt = getattr(torch, dtype)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    for B, L, H, D, _bs in SHAPES:
        arrs = _qkv(B + L, B, L, H, D)
        q, k, v = (torch.from_numpy(a).to(cuda_device, dt) for a in arrs)
        for causal in (False, True):
            got = tra.flash_attention(q, k, v, causal=causal)
            want = tra.blockwise_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert got.dtype == dt
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
