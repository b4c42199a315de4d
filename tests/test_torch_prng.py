"""The port's numpy threefry (``predictionio_tpu_torch/prng.py``) against
``jax.random``.

Keys, bits and permutations must be bitwise equal, and the float32 draws
within 2.4e-7 relative (they are bitwise equal on this tree's jax and
XLA; the bound leaves one float32 ulp for another XLA's rounding of its
``log``). The seeded inits built on it, seqrec's ``init_params`` and its
epoch shuffle, are held against the reference's flax ``model.init`` and
``jax.random.permutation``.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu_torch import prng  # noqa: E402

REL = 2.4e-7


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), np.finfo(np.float32).tiny),
                        initial=0.0))


@pytest.mark.parametrize("seed", [0, 3, 7, 42, 12345, 2**31 - 1, -1, -77])
def test_prngkey_is_bitwise_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 3, 7, 64])
def test_split_is_bitwise_jax(num):
    for seed in (0, 7, 99):
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), num),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_split_chain_is_bitwise_jax():
    k, jk = prng.PRNGKey(5), jax.random.PRNGKey(5)
    for _ in range(10):
        k, _sub = prng.split(k)
        jk, _jsub = jax.random.split(jk)
        np.testing.assert_array_equal(k, np.asarray(jk))


@pytest.mark.parametrize("data", [0, 1, 2, 12345, 2**31, 2**32 - 1])
def test_fold_in_is_bitwise_jax(data):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(prng.fold_in(np.asarray(key), data),
                                  np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (4097,)])
def test_random_bits_are_bitwise_jax(shape):
    key = jax.random.PRNGKey(21)
    np.testing.assert_array_equal(
        prng.random_bits(np.asarray(key), shape),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))


@pytest.mark.parametrize("shape,lo,hi", [((5,), 0.0, 1.0),
                                         ((100, 3), -2.0, 3.5),
                                         ((64, 64), 0.25, 0.5)])
def test_uniform_matches_jax(shape, lo, hi):
    key = jax.random.PRNGKey(8)
    got = prng.uniform(np.asarray(key), shape, lo, hi)
    want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
    assert got.dtype == np.float32
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("shape", [(5,), (100, 3), (1000, 64),
                                   (138493, 64)])
def test_normal_matches_jax(shape):
    """(138493, 64) is the reference's ALS init of the ML-20M users at
    rank 64."""
    key = jax.random.split(jax.random.PRNGKey(7))[1]
    got = prng.normal(np.asarray(key), shape)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("shape", [(5,), (100, 3), (48, 144), (256, 768)])
def test_truncated_normal_matches_jax(shape):
    key = jax.random.PRNGKey(13)
    got = prng.truncated_normal(np.asarray(key), -2, 2, shape)
    want = np.asarray(jax.random.truncated_normal(key, -2, 2, shape))
    assert _rel(got, want) <= REL
    assert np.all(np.abs(got) < 2)


def test_erf_at_the_truncation_bounds_is_jax():
    x = np.float32(2) / np.float32(np.sqrt(2))
    for v in (x, -x):
        assert prng.erf(v) == np.asarray(jax.lax.erf(jnp.float32(v)))


@pytest.mark.parametrize("n", [1, 7, 20000])
def test_permutation_is_bitwise_jax(n):
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(2), i)
        np.testing.assert_array_equal(
            prng.permutation(np.asarray(key), n),
            np.asarray(jax.random.permutation(key, n)))


def test_permutation_ties_keep_jax_order():
    """At n = 20000 about one shuffle in twenty draws two equal 32-bit
    sort keys; XLA's CPU sort is stable there, as the port's argsort."""
    n, found = 20000, 0
    for i in range(200):
        key = jax.random.fold_in(jax.random.PRNGKey(9), i)
        _, sub = jax.random.split(key)
        bits = np.asarray(jax.random.bits(sub, (n,), jnp.uint32))
        if len(np.unique(bits)) == n:
            continue
        found += 1
        np.testing.assert_array_equal(
            prng.permutation(np.asarray(key), n),
            np.asarray(jax.random.permutation(key, n)))
        if found == 2:
            break
    assert found >= 1


def test_fold_in_static_is_flax():
    from flax.core import scope

    key = jax.random.PRNGKey(4)
    for path in (("Block_0", "Dense_1", 2), ("item_embed", 1), (1,),
                 ("LayerNorm_0", 2)):
        np.testing.assert_array_equal(
            prng.fold_in_static(np.asarray(key), path),
            np.asarray(scope._fold_in_static(key, path)))


# -- the seeded inits --------------------------------------------------------


@pytest.mark.parametrize("shape", [dict(n_items=30, max_len=12, embed_dim=16,
                                        num_heads=2, num_blocks=2, seed=5),
                                   dict(n_items=200, max_len=50, embed_dim=24,
                                        num_heads=2, num_blocks=3, seed=0)],
                         ids=["small", "template"])
def test_seqrec_init_params_equal_flax_init(shape):
    from predictionio_tpu.models import seq_attention as ref
    from predictionio_tpu_torch.models import seq_attention as port

    n_items, seed = shape.pop("n_items"), shape["seed"]
    model = ref._make_model(n_items, ref.SeqRecConfig(**shape))
    kinit, _ = jax.random.split(jax.random.PRNGKey(seed))
    want = model.init(kinit, jnp.zeros((2, shape["max_len"]), jnp.int32))
    got = port.init_params(n_items, port.SeqRecConfig(**shape), seed)
    flat_w = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_w.keys() == flat_g.keys()
    for name, w in flat_w.items():
        g = flat_g[name]
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert _rel(g, w) <= REL, name


def test_seqrec_epoch_shuffle_is_the_references():
    """The trainer's epoch orders: the second half of split(PRNGKey(seed)),
    split again each epoch, then permutation (reference
    models/seq_attention.py train_seq_rec)."""
    seed, n = 3, 257
    ep, jep = prng.split(prng.PRNGKey(seed))[1], \
        jax.random.split(jax.random.PRNGKey(seed))[1]
    for _ in range(3):
        ep, sub = prng.split(ep)
        jep, jsub = jax.random.split(jep)
        np.testing.assert_array_equal(
            prng.permutation(sub, n),
            np.asarray(jax.random.permutation(jsub, n)))


def test_als_init_draws_are_the_references():
    """train_als's default init, as the port builds it, equals the
    reference's draws (models/als.py train_als)."""
    seed, nu, ni, rank = 3, 500, 300, 10
    k_u, k_v = prng.split(prng.PRNGKey(seed))
    jk_u, jk_v = jax.random.split(jax.random.PRNGKey(seed))
    v = np.abs(prng.normal(k_v, (ni, rank))) / np.sqrt(rank)
    jv = np.abs(np.asarray(jax.random.normal(jk_v, (ni, rank),
                                             jnp.float32))) / np.sqrt(rank)
    u = np.abs(prng.normal(k_u, (nu, rank))) / np.sqrt(rank)
    ju = np.abs(np.asarray(jax.random.normal(jk_u, (nu, rank),
                                             jnp.float32))) / np.sqrt(rank)
    assert _rel(v, jv) <= REL and _rel(u, ju) <= REL


def test_prng_imports_neither_jax_nor_torch():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(prng.__file__).read_text())
    roots = {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    roots |= {a.name.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.Import) for a in n.names}
    assert roots <= {"__future__", "hashlib", "math", "typing", "numpy"}
