"""The seqrec serving slice: the JAX model and the port's, on one set of weights.

The JAX package's ``_make_model(...).init`` gives the flax parameter tree;
every leaf is then moved by seeded numpy noise so that no LayerNorm scale is
1 and no bias is 0 (a swapped or dropped parameter would otherwise hide).
The port receives the tree through ``convert.seqrec_model_from_numpy`` and
the same left-padded histories (``build_sequences`` of the JAX package on a
numpy event log with histories of 1 to 21 events, some past ``max_len``).

Tolerance. The two models round to bf16 at the same points (each Dense's
input, kernel, product and bias, and its ReLU); elsewhere they compute in
f32 and differ only in the order of sums. Where no bf16 rounding tips, the
logits agree to f32 rounding (4.8e-07 measured); a tipped rounding moves
an element by one bf16 step. So the logits are held to 2**-7 (one bf16 step
at the logits' magnitude, ~2), and their mean difference to 1e-5, which a
systematic drift (torch's LayerNorm epsilon 1e-5 for flax's 1e-6, or a
fused product-plus-bias) exceeds by two orders of magnitude.
Served lists must name the same items wherever neighbouring scores differ
by more than that tolerance, with scores within it.
"""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.models.seq_attention import (  # noqa: E402
    SeqRecConfig as JaxConfig, SeqRecModel as JaxSeqRecModel, _make_model,
    build_sequences as jax_build_sequences)
from predictionio_tpu_torch.controller import FirstServing, TrainResult  # noqa: E402
from predictionio_tpu_torch.convert import seqrec_model_from_numpy  # noqa: E402
from predictionio_tpu_torch.models import seq_attention as tsa  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.templates.seqrec import engine as tengine  # noqa: E402
from predictionio_tpu_torch.workflow.create_server import (  # noqa: E402
    EngineServer, serve)

TOL = 2.0**-7
MEAN_TOL = 1e-5
N_ITEMS, N_USERS, MAX_LEN = 60, 24, 16


def _events(seed=0):
    """A numpy event log: user u has 1 + (5u mod 21) events at increasing
    times, so histories range from one item to past max_len."""
    rng = np.random.default_rng(seed)
    users, items, times = [], [], []
    for u in range(N_USERS):
        n = 1 + (5 * u) % 21
        users += [f"u{u}"] * n
        items += [f"i{int(j)}" for j in rng.integers(0, N_ITEMS, n)]
        times += list(rng.permutation(n).astype(float) + 100.0 * u)
    return (np.asarray(users, dtype=object), np.asarray(items, dtype=object),
            np.asarray(times))


def _jax_setup(num_heads: int):
    cfg = JaxConfig(max_len=MAX_LEN, embed_dim=32, num_heads=num_heads,
                    num_blocks=2)
    seqs, uids, iids = jax_build_sequences(*_events(), max_len=MAX_LEN)
    assert len(iids) <= N_ITEMS
    net = _make_model(len(iids), cfg)
    params = net.init(jax.random.PRNGKey(num_heads),
                      jnp.zeros((2, MAX_LEN), jnp.int32))
    rng = np.random.default_rng(num_heads)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    jm = JaxSeqRecModel(params=params, seqs=seqs, user_ids=uids,
                        item_ids=iids, config=cfg)
    return jm, net


def _port(jm) -> tsa.SeqRecModel:
    uinv, iinv = jm.user_ids.inverse, jm.item_ids.inverse
    return seqrec_model_from_numpy(
        jm.params, jm.seqs, [uinv[i] for i in range(len(uinv))],
        [iinv[j] for j in range(len(iinv))],
        tsa.SeqRecConfig(**jm.config.__dict__), device="cpu")


@pytest.fixture(scope="module", params=[2, 4], ids=["heads2", "heads4"])
def models(request):
    jm, net = _jax_setup(request.param)
    return jm, net, _port(jm)


def test_build_sequences_matches_jax():
    want, wu, wi = jax_build_sequences(*_events(), max_len=MAX_LEN)
    got, gu, gi = tsa.build_sequences(*_events(), max_len=MAX_LEN)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert gu.to_dict() == wu.to_dict() and gi.to_dict() == wi.to_dict()
    assert (got[:, 0] == 0).any() and (got[:, 0] > 0).any()  # pad and full


def test_forward_last_matches_jax(models):
    jm, net, tm = models
    want_all = np.asarray(net.apply(jm.params, jnp.asarray(jm.seqs)))
    with torch.inference_mode():
        got_all = tm._net(torch.from_numpy(jm.seqs)).numpy()
    got = tm.logits_last(jm.seqs)
    assert got.shape == (len(jm.seqs), len(jm.item_ids) + 1)
    assert got.dtype == np.float32
    for g, w in ((got, want_all[:, -1, :]), (got_all, want_all)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        assert np.abs(g - w).mean() <= MEAN_TOL


def _check_lists(got, want, tol=TOL):
    """Same items where neighbouring scores differ by more than ``tol``;
    scores within ``tol``."""
    assert len(got) == len(want)
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    for r, ((gi, _), (wi, ws_r)) in enumerate(zip(got, want)):
        near = [abs(ws_r - ws[n]) <= tol
                for n in (r - 1, r + 1) if 0 <= n < len(ws)]
        if not any(near):
            assert gi == wi, (r, got, want)


QUERIES = [("u0", 4), ("u3", 10), ("u7", 1), ("u11", 20), ("u5", 100),
           ("nobody", 5), ("u19", 0), ("u20", 10), ("u2", 7)]


@pytest.mark.parametrize("exclude_seen", [True, False])
def test_batch_recommend_matches_jax(models, exclude_seen):
    jm, _net, tm = models
    users = [u for u, _ in QUERIES]
    nums = [n for _, n in QUERIES]
    want = jm.batch_recommend(users, nums, exclude_seen=exclude_seen)
    got = tm.batch_recommend(users, nums, exclude_seen=exclude_seen)
    assert got[users.index("nobody")] == [] and got[users.index("u19")] == []
    assert len(got[users.index("u5")]) > 20  # num past the catalog: all left
    for g, w in zip(got, want):
        _check_lists(g, w)
    if exclude_seen:
        row = jm.user_ids["u3"]
        seen = {jm.item_ids.inverse[int(i) - 1]
                for i in jm.seqs[row] if i > 0}
        assert not seen & {i for i, _ in got[users.index("u3")]}


def test_recommend_products_matches_jax(models):
    jm, _net, tm = models
    for user, num in QUERIES:
        _check_lists(tm.recommend_products(user, num),
                     jm.recommend_products(user, num))


def test_batch_chunks_and_pad_buckets(models, monkeypatch):
    """More queries than BATCH_CHUNK run one forward per chunk, each padded
    to a power of two >= 8, with the same answers."""
    jm, _net, tm = models
    users = [f"u{u}" for u in range(N_USERS)]
    nums = [5] * len(users)
    whole = tm.batch_recommend(users, nums)
    shapes = []
    real = tsa.SeqRecModel.logits_last

    def spy(self, seqs):
        shapes.append(seqs.shape[0])
        return real(self, seqs)

    monkeypatch.setattr(tsa.SeqRecModel, "BATCH_CHUNK", 10)
    monkeypatch.setattr(tsa.SeqRecModel, "logits_last", spy)
    forwards = tm.forwards
    chunked = tm.batch_recommend(users, nums)
    assert shapes == [16, 16, 8]
    assert tm.forwards == forwards + 3
    for g, w in zip(chunked, whole):
        _check_lists(g, w)


def _served(tm, batch_max=8) -> EngineServer:
    p = tm.config
    algo = tengine.SeqRecAlgorithm(tengine.AlgorithmParams(
        max_len=p.max_len, embed_dim=p.embed_dim, num_heads=p.num_heads,
        num_blocks=p.num_blocks))
    result = TrainResult([tm], [algo], FirstServing(), ["seqrec"])
    return EngineServer(tengine.engine_factory(), result, "seqrec-test",
                        device="cpu", batch_max=batch_max)


def test_serve_over_http_matches_batch_recommend(models):
    jm, _net, tm = models
    forwards = tm.forwards
    server = _served(tm)
    assert server.deployed.warmed == [8]  # lattice {1, 8}: one b_pad
    assert tm.forwards == forwards + 1
    assert tm.device == torch.device("cpu")
    launches = dict(kernels.LAUNCHES)
    with serve(server, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}/queries.json"
        for user, num in QUERIES + [("u4", None)]:
            body = {"user": user} if num is None else {"user": user,
                                                       "num": num}
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                got = json.loads(resp.read())["itemScores"]
            want = tm.batch_recommend([user], [10 if num is None else num])[0]
            assert [(g["item"], g["score"]) for g in got] == \
                [(i, s) for i, s in want]
            _check_lists([(g["item"], g["score"]) for g in got],
                         jm.recommend_products(user, 10 if num is None
                                               else num))
    assert kernels.LAUNCHES == launches  # the CPU runs the plain version


def test_serve_query_batch_matches_jax_template(models):
    jm, _net, tm = models
    server = _served(tm, batch_max=16)
    outcomes = server.serve_query_batch(
        [{"user": u, "num": n} for u, n in QUERIES] + [{"num": 3}])
    assert outcomes[-1][0] == "err"  # no user: a bad query fails alone
    for (user, num), (tag, body) in zip(QUERIES, outcomes):
        assert tag == "ok"
        _check_lists([(g["item"], g["score"]) for g in body["itemScores"]],
                     jm.recommend_products(user, num))


def test_convert_refuses_bad_inputs(models):
    jm, _net, _tm = models
    uinv, iinv = jm.user_ids.inverse, jm.item_ids.inverse
    users = [uinv[i] for i in range(len(uinv))]
    items = [iinv[j] for j in range(len(iinv))]
    cfg = tsa.SeqRecConfig(**jm.config.__dict__)
    with pytest.raises(ValueError, match="seqs"):
        seqrec_model_from_numpy(jm.params, jm.seqs[:, 1:], users, items, cfg,
                                device="cpu")
    with pytest.raises(ValueError, match="user id"):
        seqrec_model_from_numpy(jm.params, jm.seqs, users[1:], items, cfg,
                                device="cpu")
    with pytest.raises(ValueError, match="shape"):
        seqrec_model_from_numpy(jm.params, jm.seqs, users, items,
                                tsa.SeqRecConfig(**{**jm.config.__dict__,
                                                    "embed_dim": 16}),
                                device="cpu")


def test_init_params_matches_the_flax_tree():
    """``init_params`` names and shapes every leaf as ``_make_model``'s
    init does, at flax's init scales."""
    cfg = JaxConfig(max_len=MAX_LEN, embed_dim=32, num_heads=2, num_blocks=2)
    want = _make_model(N_ITEMS, cfg).init(jax.random.PRNGKey(0),
                                          jnp.zeros((2, MAX_LEN), jnp.int32))
    got = tsa.init_params(N_ITEMS, tsa.SeqRecConfig(**cfg.__dict__), seed=0)
    flat_w = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g == flat_w
    p = got["params"]
    assert abs(p["item_embed"]["embedding"].std() - 0.02) < 0.002
    k = p["Block_0"]["Dense_2"]["kernel"]
    assert abs(k.std() - np.sqrt(1 / 32)) < 0.02 and np.abs(k).max() <= \
        2 * np.sqrt(1 / 32) / 0.87962566103423978 + 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the flash-attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_forward_last_kernel_matches_plain_on_the_card(models, cuda_device):
    from predictionio_tpu_torch.parallel.ring_attention import (
        blockwise_attention)

    jm, _net, tm = models
    tm.attach_model(cuda_device)
    x = torch.from_numpy(jm.seqs).to(cuda_device)
    before = kernels.LAUNCHES["flash_attention"]
    with torch.inference_mode():
        got = tm._net.forward_last(x)
        want = tm._net.forward_last(x, attention=blockwise_attention)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + jm.config.num_blocks
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    tm.attach_model("cpu")
