"""The port's attention gradients against the JAX package's, on the CPU.

The same q, k, v and output gradient (made with numpy from a seed) go
through ``jax.vjp`` of the JAX ``flash_attention``
(``predictionio_tpu/parallel/ring_attention.py``; off the TPU it is
``blockwise_attention``, which is what the JAX trainer differentiates
there) and through three routes of the port
(``predictionio_tpu_torch/parallel/ring_attention.py``):
``blockwise_attention_bwd``, the plain version of the backward kernels
``csrc/flash_attn_bwd.cu``; the ``FlashAttention`` autograd Function on CPU
tensors, which is how the seqrec model's ``flash_attention`` trains; and
``torch.autograd`` through ``blockwise_attention``.

Tolerances, against each gradient's largest magnitude. f32: 1e-4; the
routes compute the same products in f32 and differ in the order of their
sums and in where the softmax is normalised (the kernels' backward forms
P = exp(S - lse), autodiff differentiates the carries). bf16: 2**-6; the
port rounds P and dS to bf16 before their products, as the stock TPU
kernel does, while autodiff of the bf16 forward rounds elsewhere, so a
gradient element may differ by a few bf16 steps of the largest one.

The logsumexp the forward returns is held to JAX's ``m + log(l)`` from
``mha_reference_no_custom_vjp(..., save_residuals=True)``, the stock
kernel's own reference, with q pre-scaled by 1/sqrt(D) (its scale is 1),
within 1e-5.

``EDGE_SHAPES`` are the backward kernels' tile edges (rows crossing a 64-
and a 128-row tile, head dims that are no multiple of 16, a lone row): the
card holds the kernels against ``blockwise_attention_bwd`` there, and
``test_gradients_match_jax_vjp_at_kernel_tile_edges`` anchors that plain
version to JAX at the same shapes.

The kernels run only on a card: ``test_backward_kernels_match_plain_on_the_card``
carries the ``cuda`` marker and skips here; ``chip_smoke.py`` holds them
against ``blockwise_attention_bwd`` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import (  # noqa: E402
    mha_reference_no_custom_vjp)

from predictionio_tpu.parallel import ring_attention as jra  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.parallel import ring_attention as tra  # noqa: E402

from tests.test_torch_attention import SHAPES, _ids  # noqa: E402

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
LSE_TOL = 1e-5


def _arrays(seed, B, L, H, D):
    """q, k, v and the output gradient, f32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(4)]


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


#: the backward kernels' tile edges (B, L, H, D, plain block size): L 129
#: and 200 cross a 128- and a 64-row tile boundary, D 40 and 120 are no
#: multiple of the bf16 k-step 16 (zero-padded on the card), L 1 is a lone
#: row; chip_smoke.py holds the kernels against the plain version there
EDGE_SHAPES = [
    (2, 129, 2, 40, 64),
    (2, 200, 2, 40, 64),
    (2, 257, 2, 120, 64),
    (3, 1, 2, 8, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_gradients_match_jax_vjp(shape, causal, dtype):
    _check_routes(shape, causal, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=_ids)
def test_gradients_match_jax_vjp_at_kernel_tile_edges(shape, causal, dtype):
    _check_routes(shape, causal, dtype)


def _check_routes(shape, causal, dtype):
    """``jax.vjp`` of the JAX ``flash_attention`` against the port's three
    routes, each gradient within ``GRAD_TOL`` of its largest magnitude."""
    B, L, H, D, bs = shape
    arrs = _arrays(sum(shape) + 7, B, L, H, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrs)
    _out, vjp = jax.vjp(
        lambda q, k, v: jra.flash_attention(q, k, v, causal=causal,
                                            block_size=bs), jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jdo)]

    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    o, lse = tra.blockwise_attention(q, k, v, causal=causal, block_size=bs,
                                     return_lse=True)
    routes = {"blockwise_attention_bwd": tra.blockwise_attention_bwd(
        q, k, v, o, lse, do, causal=causal, block_size=bs)}
    for name, fn in (("FlashAttention", tra.flash_attention),
                     ("autograd", tra.blockwise_attention)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=causal, block_size=bs)
        routes[name] = torch.autograd.grad(out, leaves, do)
    for name, grads in routes.items():
        for g, w, which in zip(grads, want, ("dq", "dk", "dv")):
            assert g.dtype == tdt and g.shape == (B, L, H, D), (name, which)
            _close(g, w, GRAD_TOL[dtype], (name, which))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_lse_matches_jax_reference(shape, causal):
    B, L, H, D, bs = shape
    q, k, v, _ = _arrays(sum(shape) + 11, B, L, H, D)
    to_bhld = (0, 2, 1, 3)
    _o, l, m = mha_reference_no_custom_vjp(
        jnp.asarray(q.transpose(to_bhld)) / np.sqrt(D),
        jnp.asarray(k.transpose(to_bhld)), jnp.asarray(v.transpose(to_bhld)),
        causal=causal, save_residuals=True)
    want = np.asarray(m) + np.log(np.asarray(l))
    _out, lse = tra.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        block_size=bs, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, L)
    np.testing.assert_allclose(lse.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)


def test_inference_never_records_a_backward():
    """Serving runs under inference mode: the plain forward, no residual."""
    arrs = _arrays(5, 1, 9, 2, 8)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    with torch.inference_mode():
        out = tra.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    out = tra.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


_BWD = {"dkv": kernels.flash_attention_bwd_dkv,
        "dq": kernels.flash_attention_bwd_dq}


@pytest.mark.parametrize("binding", sorted(_BWD))
@pytest.mark.parametrize("bad", [
    "dtype", "rank", "shape_mismatch", "head_dim_odd", "head_dim_big",
    "empty", "cpu", "lse_shape", "di_dtype", "too_long"])
def test_backward_kernel_wrappers_refuse(binding, bad):
    """What the backward kernels do not take raises before any build or
    launch: the forward's refusals, plus the [B, H, L] f32 rows."""
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
    if bad == "too_long":  # a shape check only: no memory behind it
        q = torch.empty(1, 64 * 65535 + 1, 1, 8, device="meta")
    k, v, do = q, q, q
    B, L, H, _ = q.shape
    lse = torch.zeros(B, H, L, device=q.device)
    di = torch.zeros(B, H, L, device=q.device)
    if bad == "rank":
        q = q[0]
    elif bad == "shape_mismatch":
        do = torch.zeros(1, 17, 2, 8)
    elif bad == "lse_shape":
        lse = torch.zeros(B, L, H)
    elif bad == "di_dtype":
        di = di.double()
    before = dict(kernels.LAUNCHES)
    lib = kernels._lib
    match = "CUDA" if bad == "cpu" else f"flash_attention_bwd_{binding}"
    with pytest.raises(ValueError, match=match):
        _BWD[binding](q, k, v, do, lse, di, causal=True)
    assert kernels.LAUNCHES == before
    assert kernels._lib is lib  # nothing was built


def test_forward_wrapper_refuses_a_bad_lse_buffer():
    q = torch.zeros(1, 16, 2, 8)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="flash_attention_fwd: lse"):
        kernels.flash_attention_fwd(q, q, q, causal=True,
                                    lse=torch.zeros(1, 16, 2))
    assert kernels.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the backward kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_on_the_card(cuda_device, dtype):
    tdt = getattr(torch, dtype)
    for B, L, H, D, _bs in SHAPES + EDGE_SHAPES:
        arrs = _arrays(B + L + D, B, L, H, D)
        q, k, v, do = (torch.from_numpy(a).to(cuda_device, tdt) for a in arrs)
        for causal in (False, True):
            lse = torch.empty(B, H, L, device=cuda_device)
            o = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse)
            _ref_o, ref_lse = tra.blockwise_attention(
                q, k, v, causal=causal, return_lse=True)
            torch.testing.assert_close(lse, ref_lse, rtol=LSE_TOL,
                                       atol=LSE_TOL)
            di = tra.attention_di(o, do)
            dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                                     causal=causal)
            dq = kernels.flash_attention_bwd_dq(q, k, v, do, lse, di,
                                                causal=causal)
            want = tra.blockwise_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)
            torch.cuda.synchronize()
            for g, w in zip((dq, dk, dv), want):
                assert g.dtype == tdt
                _close(g.cpu(), w.cpu(), GRAD_TOL[dtype], (B, L, H, D))
