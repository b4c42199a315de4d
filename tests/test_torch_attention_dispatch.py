"""The port's attention dispatch by head dim, against the JAX package's.

The reference ``flash_attention`` (``predictionio_tpu/parallel/
ring_attention.py``) answers every head dim. The port's
(``predictionio_tpu_torch/parallel/ring_attention.py``) gives every head
dim up to 256 to the hand-written kernels: zero-padded (``_pad_features``)
to a head dim they take (a multiple of 8 up to 128, else 256), with the
scale of the original D, and sliced back. On a card a larger head dim
raises in the kernel wrappers before any launch.

- Parity with JAX's ``flash_attention`` and its ``jax.vjp`` at D 10, 12,
  136 and 256 on the CPU, where the kernels' path runs their plain versions
  on the padded tensors. Tolerances as in ``tests/test_torch_attention.py``
  (f32 1e-5, bf16 2**-7) and ``tests/test_torch_attention_grad.py`` (each
  gradient against its largest magnitude: f32 1e-4, bf16 2**-6).
- Padding is exact: the plain versions on padded tensors with the original
  scale, sliced back, equal the unpadded ones within 1e-6 (f32; the two
  differ only in the order of sums over a longer feature axis).
- The routing a CUDA tensor takes, shown on the CPU with ``meta`` tensors
  (no data, no card) and stand-ins for the kernel wrappers that count their
  calls and check what they are given: the kernels at every head dim up to
  256, with padded shapes and the original scale; the real wrappers refuse
  D 264 and f16.
- On the card (``cuda`` marker, skipped here): the launch counters move at
  D 10, 136 and 256, and the results match the plain version.
"""

import ast
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.parallel import ring_attention as jra  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.parallel import ring_attention as tra  # noqa: E402

from tests.test_torch_attention import BF16_TOL, F32_TOL  # noqa: E402
from tests.test_torch_attention_grad import GRAD_TOL, _close  # noqa: E402

#: (B, L, H, D, plain block size): head dims the kernels take only padded
#: (10 and 12 to 16, 136 to 256) and the widest they take (256), with a
#: ragged tail block
DISPATCH_SHAPES = [
    (2, 25, 2, 10, 10),
    (1, 19, 3, 12, 8),
    (1, 11, 2, 136, 8),
    (1, 13, 2, 256, 8),
]


def _width(D):
    """The head dim the kernels run ``D`` at."""
    return -(-D // 8) * 8 if D <= 128 else 256


def _ids(shape):
    return "B{}-L{}-H{}-D{}-bs{}".format(*shape)


def _arrays(seed, B, L, H, D, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", DISPATCH_SHAPES, ids=_ids)
def test_forward_matches_jax(shape, causal, dtype):
    B, L, H, D, bs = shape
    arrs = _arrays(sum(shape) + 3, B, L, H, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jra.flash_attention(*(jnp.asarray(a, jdt) for a in arrs),
                               causal=causal, block_size=bs)
    assert want.dtype == jdt
    got = tra.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                              causal=causal, block_size=bs)
    assert got.dtype == tdt and got.shape == (B, L, H, D)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", DISPATCH_SHAPES, ids=_ids)
def test_gradients_match_jax_vjp(shape, causal, dtype):
    """``jax.vjp`` of the JAX ``flash_attention`` against the port's
    ``flash_attention`` under autograd and ``FlashAttention`` called
    directly."""
    B, L, H, D, bs = shape
    arrs = _arrays(sum(shape) + 5, B, L, H, D, n=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrs)
    _out, vjp = jax.vjp(lambda q, k, v: jra.flash_attention(
        q, k, v, causal=causal, block_size=bs), jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jdo)]
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    routes = {
        "flash_attention": lambda *x: tra.flash_attention(
            *x, causal=causal, block_size=bs),
        "FlashAttention": lambda *x: tra.FlashAttention.apply(
            *x, causal, bs)}
    for name, fn in routes.items():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        assert out.dtype == tdt and out.shape == (B, L, H, D)
        grads = torch.autograd.grad(out, leaves, do)
        for g, w, which in zip(grads, want, ("dq", "dk", "dv")):
            assert g.dtype == tdt and g.shape == (B, L, H, D), (name, which)
            _close(g, w, GRAD_TOL[dtype], (name, which))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [1, 10, 12, 20, 127, 136])
def test_padding_is_exact(D, causal):
    """The plain versions on features zero-padded to a head dim the kernels
    take, with the scale of the original D, sliced back: the unpadded
    results."""
    B, L, H = 2, 21, 2
    q, k, v, do = (torch.from_numpy(a)
                   for a in _arrays(D + 40, B, L, H, D, n=4))
    scale = 1.0 / D**0.5
    padded = tra._pad_features(q, k, v, do)
    assert all(t.shape == (B, L, H, _width(D)) for t in padded)
    assert all(torch.equal(t[..., :D], x) and not t[..., D:].any()
               for t, x in zip(padded, (q, k, v, do)))
    qp, kp, vp, dop = padded
    o, lse = tra.blockwise_attention(q, k, v, causal=causal, block_size=8,
                                     return_lse=True)
    op, lsep = tra.blockwise_attention(qp, kp, vp, causal=causal,
                                       block_size=8, return_lse=True,
                                       scale=scale)
    torch.testing.assert_close(op[..., :D], o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lsep, lse, rtol=1e-6, atol=1e-6)
    assert not op[..., D:].any()
    want = tra.blockwise_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       block_size=8)
    got = tra.blockwise_attention_bwd(qp, kp, vp, op, lsep, dop,
                                      causal=causal, block_size=8,
                                      scale=scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :D], w, rtol=1e-6, atol=1e-6)
    assert tra._pad_features(qp, kp)[0] is qp  # a width the kernels take


class _FakeKernels:
    """Stand-ins for the attention kernel wrappers on ``meta`` tensors: they
    check the shapes and scale they are given, count their calls and
    return empty results of the right shapes."""

    def __init__(self, D):
        self.D, self.calls = D, []

    def _take(self, name, q, scale):
        assert q.device.type == "meta" and q.is_contiguous()
        assert q.shape[-1] == _width(self.D)
        assert scale == pytest.approx(1.0 / self.D**0.5)
        self.calls.append(name)

    def flash_attention_fwd(self, q, k, v, *, causal, lse=None, scale=None):
        assert k.shape == v.shape == q.shape
        self._take("fwd", q, scale)
        return torch.empty_like(q)

    def flash_attention_bwd_dkv(self, q, k, v, do, lse, di, *, causal,
                                scale=None):
        assert do.shape == q.shape and di.shape == lse.shape
        self._take("dkv", q, scale)
        return torch.empty_like(q), torch.empty_like(q)

    def flash_attention_bwd_dq(self, q, k, v, do, lse, di, *, causal,
                               scale=None):
        self._take("dq", q, scale)
        return torch.empty_like(q)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("D", [8, 10, 12, 24, 64, 128, 136, 200, 256])
def test_device_tensors_route_by_head_dim(monkeypatch, D, grad):
    """A tensor off the CPU (``meta`` here, CUDA on the card) reaches the
    kernel wrappers at every head dim up to 256, padded to the width the
    kernels take (up to 128 the next multiple of 8, above it 256), with the
    original scale; the results come back at D."""
    fake = _FakeKernels(D)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        monkeypatch.setattr(tra.kernels, name, getattr(fake, name))
    q, k, v = (torch.empty(2, 33, 2, D, device="meta", requires_grad=grad)
               for _ in range(3))
    out = tra.flash_attention(q, k, v, causal=True)
    assert out.shape == (2, 33, 2, D) and out.device.type == "meta"
    if grad:
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
    assert fake.calls == (["fwd", "dkv", "dq"] if grad else ["fwd"])


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("D,dtype,match", [
    (264, torch.float32, "head dim that is a multiple of 8 up to 128, or 256"),
    (512, torch.bfloat16, "head dim that is a multiple of 8 up to 128, or 256"),
    (10, torch.float16, "dtype torch.float16"),
    (136, torch.float16, "dtype torch.float16"),
])
def test_what_the_kernels_do_not_take_raises_off_the_cpu(D, dtype, match,
                                                          grad):
    """Off the CPU, a head dim above 256 or a dtype other than f32 and bf16
    raises in the kernel wrappers before any build or launch, with and
    without autograd; nothing falls back to the plain version."""
    q = torch.empty(1, 8, 2, D, dtype=dtype, device="meta",
                    requires_grad=grad)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tra.flash_attention(q, q, q, causal=True)
    assert kernels.LAUNCHES == before


def test_dispatch_has_no_try():
    """The path is chosen by the shape rule, never by catching a failed
    build or launch."""
    tree = ast.parse(inspect.getsource(tra))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("script", ["attn_fwd_ab.py", "attn_bwd_ab.py",
                                    "topk_ab.py"])
def test_card_scripts_import_no_jax(script):
    """The A/B scripts run on the machine with the card, which has no jax:
    like the port, they import none of it nor the JAX package."""
    path = inspect.getfile(tra).rsplit("predictionio_tpu_torch", 1)[0]
    tree = ast.parse(open(f"{path}scripts/{script}").read())
    roots = {alias.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for alias in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert roots and not roots & {"jax", "jaxlib", "flax", "predictionio_tpu"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the attention kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [10, 136, 256])
def test_head_dim_routing_on_the_card(cuda_device, D, dtype):
    tdt = getattr(torch, dtype)
    B, L, H = 2, 200, 2
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, tdt)
                   for a in _arrays(D, B, L, H, D, n=4))
    before = dict(kernels.LAUNCHES)
    got = tra.flash_attention(q, k, v, causal=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(tra.flash_attention(*leaves, causal=True),
                                leaves, do)
    torch.cuda.synchronize()
    moved = {key: kernels.LAUNCHES[key] - before[key] for key in before}
    assert moved == {"topk": 0, "topk_rows": 0, "topk_select": 0,
                     "topk_sort": 0, "topk_merge": 0, "flash_attention": 2,
                     "flash_attention_bwd_dkv": 1,
                     "flash_attention_bwd_dq": 1}
    want = tra.blockwise_attention(q, k, v, causal=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    wants = torch.autograd.grad(tra.blockwise_attention(*leaves, causal=True),
                                leaves, do)
    for g, w in zip(grads, wants):
        _close(g.cpu(), w.cpu(), GRAD_TOL[dtype], D)
