"""Seqrec training on the port against the JAX trainer, on the CPU.

One train step: the JAX step built as ``train_seq_rec`` builds it
(``_make_model``, ``loss_fn``, ``jax.value_and_grad``) and the port's
``seq_rec_loss`` + backward run from the same flax parameters (the JAX init,
moved by seeded numpy noise so no LayerNorm scale is 1 and no bias 0) on the
same batch. The loss agrees within 1e-5 relative: both compute it in f32
from logits that round to bf16 at the same points. The gradients are held
twice. With the model's bf16 Dense layers, each leaf within 2**-3 of that
leaf's largest magnitude: every Dense cotangent is rounded to bf16 on both
sides, a summation-order difference tips some of those roundings, and the
leaves are sums over all positions with much cancellation. How far bf16
rounding moves these gradients at all was measured on this fixture: JAX's
own gradients move by up to 17% of a leaf's largest magnitude between bf16
and f32 Dense layers, while the port and JAX differ by at most 4.9% (and
the port's kernels and its plain path by 5.5% at full width on the card,
``chip_smoke.py`` phase 6b); 2**-3 keeps twice that margin. With
f32 Dense layers on both sides (flax's ``Dense`` and the port's, patched
for the test), nothing rounds to bf16 and each leaf agrees within 1e-5 of
its largest magnitude (8.4e-7 measured): that pins the backward itself.

The whole trainer: JAX's ``train_seq_rec`` and the port's on the cyclic
fixture of ``tests/test_parallel_seq.py`` with ``batch_size >= users``, so
each epoch is one full batch and the shuffle order cannot matter; the port
gets the init JAX draws (``PRNGKey(seed)`` -> split -> ``model.init``)
through ``init_params``. Every user's top-1 next item agrees, and the loss
of the trained weights on all histories agrees (30
Adam steps carry the rounding differences of every step forward: measured
2.5e-4 with f32 Dense layers on both sides and 2.4e-3 with the bf16 ones,
held to 1e-3 and 1e-2).

The template: ``Engine.train`` of the port's seqrec engine with an
in-memory data source learns the cycles of ``test_seq_rec_learns_cycle``
and ``TestSeqRec.test_next_item_prediction``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.models.seq_attention import (  # noqa: E402
    SeqRecConfig as JaxConfig, _make_model,
    build_sequences as jax_build_sequences, train_seq_rec as jax_train)
from predictionio_tpu_torch.controller import (  # noqa: E402
    DataSource, EngineParams)
from predictionio_tpu_torch.controller.engine import (  # noqa: E402
    StopAfterPrepareInterruption, StopAfterReadInterruption)
from predictionio_tpu_torch.models import seq_attention as tsa  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.parallel.ring_attention import (  # noqa: E402
    blockwise_attention)
from predictionio_tpu_torch.templates.seqrec import engine as tengine  # noqa: E402
from predictionio_tpu_torch.workflow.context import (  # noqa: E402
    Context, WorkflowParams)

from tests.test_parallel_seq import _cyclic_history  # noqa: E402
from tests.test_torch_seqrec import _events  # noqa: E402

LOSS_RTOL = 1e-5
#: gradient leaves against their largest magnitude: the bf16 model, and the
#: model with f32 Dense layers
GRAD_TOL = {"bf16": 2.0**-3, "f32": 1e-5}
#: the trained models' loss, relative: 30 Adam steps carry rounding
#: differences forward (measured 2.5e-4 with f32 Dense layers, 2.4e-3 with
#: bf16 ones)
TRAINER_LOSS_RTOL = {"f32": 1e-3, "bf16": 1e-2}
CYCLE_CFG = dict(max_len=12, embed_dim=32, num_heads=2, num_blocks=1,
                 epochs=30, batch_size=32, lr=3e-3)


def _jax_loss_fn(model):
    """``loss_fn`` of the JAX trainer (seq_attention.py:257-262)."""
    def loss_fn(p, batch):
        inp, tgt = batch[:, :-1], batch[:, 1:]
        logits = model.apply(p, inp)
        mask = (tgt > 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss_fn


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_as_flax(net: tsa.SeqRec, n_items, cfg) -> dict:
    """The gradients of ``net``'s parameters as a flax-named tree."""
    g = tsa.SeqRec(n_items, cfg)
    with torch.no_grad():
        for dst, src in zip(g.parameters(), net.parameters()):
            dst.copy_(src.grad)
    return g.to_flax()


def _f32_dense(monkeypatch):
    """Both models with f32 Dense layers: flax's ``Dense`` without its bf16
    dtype (the module keeps its class name, so the tree's names stay) and
    the port's ``Dense`` as a plain f32 product plus bias."""
    import flax.linen as nn

    dense = nn.Dense
    monkeypatch.setattr(nn, "Dense", lambda *a, dtype=None, **kw: dense(
        *a, dtype=jnp.float32, **kw))
    monkeypatch.setattr(tsa.Dense, "forward",
                        lambda self, x: x @ self.kernel + self.bias)


@pytest.mark.parametrize("dense", ["bf16", "f32"])
@pytest.mark.parametrize("num_heads", [2, 4])
def test_one_train_step_matches_jax(num_heads, dense, monkeypatch):
    if dense == "f32":
        _f32_dense(monkeypatch)
    max_len = 16
    jcfg = JaxConfig(max_len=max_len, embed_dim=32, num_heads=num_heads,
                     num_blocks=2)
    seqs, _uids, iids = jax_build_sequences(*_events(), max_len=max_len)
    n_items = len(iids)
    model = _make_model(n_items, jcfg)
    params = _perturbed(model.init(jax.random.PRNGKey(num_heads),
                                   jnp.zeros((2, max_len), jnp.int32)),
                        num_heads)
    batch = seqs[(seqs > 0).any(axis=1)]
    want_loss, want_g = jax.value_and_grad(_jax_loss_fn(model))(
        params, jnp.asarray(batch))

    cfg = tsa.SeqRecConfig(**jcfg.__dict__)
    net = tsa.SeqRec(n_items, cfg).load_flax(params)
    loss = tsa.seq_rec_loss(net, torch.from_numpy(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    got, want = _flat(_grads_as_flax(net, n_items, cfg)), _flat(want_g)
    assert got.keys() == want.keys()
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        assert err <= GRAD_TOL[dense] * float(np.abs(w).max()), (key, err)


def test_chunked_loss_sums_to_the_whole(monkeypatch):
    """A batch split into row chunks, each chunk's loss weighted by its
    share of the real targets, gives the same loss and gradients as the
    whole batch (the chip's plain step runs so); f32 Dense layers, so that
    only the order of f32 sums differs."""
    _f32_dense(monkeypatch)
    cfg = tsa.SeqRecConfig(max_len=16, embed_dim=32, num_heads=2,
                           num_blocks=1)
    seqs, _u, iids = tsa.build_sequences(*_events(), max_len=16)
    batch = torch.from_numpy(seqs)
    net = tsa.SeqRec(len(iids), cfg).load_flax(
        tsa.init_params(len(iids), cfg, 3))
    whole = tsa.seq_rec_loss(net, batch, blockwise_attention)
    whole.backward()
    g_whole = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    count = (batch[:, 1:] > 0).sum().float()
    parts = 0.0
    for s in range(0, len(batch), 5):
        chunk = batch[s:s + 5]
        share = (chunk[:, 1:] > 0).sum().clamp(min=1).float() / count
        part = tsa.seq_rec_loss(net, chunk, blockwise_attention) * share
        part.backward()
        parts += float(part.detach())
    np.testing.assert_allclose(parts, float(whole), rtol=1e-6)
    for g, w in zip((p.grad for p in net.parameters()), g_whole):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def _cyclic():
    cfg = JaxConfig(**CYCLE_CFG)
    seqs, uids, iids = jax_build_sequences(*_cyclic_history(),
                                           max_len=cfg.max_len)
    return cfg, seqs, uids, iids


@pytest.fixture(scope="module", params=["bf16", "f32"])
def trained_pair(request):
    """Both trainers on the cyclic fixture from the init the JAX trainer
    draws (seq_attention.py:249-251), with the model's bf16 Dense layers or
    f32 ones; the loss of each trained model on every history."""
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "f32":
            _f32_dense(mp)
        cfg, seqs, uids, iids = _cyclic()
        jm = jax_train(seqs, uids, iids, cfg)
        net = _make_model(len(iids), cfg)
        kinit, _kshuf = jax.random.split(jax.random.PRNGKey(cfg.seed))
        init = jax.tree_util.tree_map(np.asarray, net.init(
            kinit, jnp.zeros((2, cfg.max_len), jnp.int32)))
        tm = tsa.train_seq_rec(seqs, uids, iids,
                               tsa.SeqRecConfig(**cfg.__dict__),
                               device="cpu", init_params=init)
        batch = seqs[(seqs > 0).any(axis=1)]
        want_loss = float(_jax_loss_fn(net)(jm.params, jnp.asarray(batch)))
        tnet = tsa.SeqRec(len(iids), tm.config).load_flax(tm.params)
        with torch.no_grad():
            got_loss = float(tsa.seq_rec_loss(tnet, torch.from_numpy(batch)))
    return request.param, jm, tm, got_loss, want_loss


def test_trainer_matches_jax(trained_pair):
    dense, jm, tm, got_loss, want_loss = trained_pair
    users = [jm.user_ids.inverse[i] for i in range(len(jm.user_ids))]
    want = jm.batch_recommend(users, [1] * len(users), exclude_seen=False)
    got = tm.batch_recommend(users, [1] * len(users), exclude_seen=False)
    assert [g[0][0] for g in got] == [w[0][0] for w in want]
    assert got[users.index("u0")][0][0] == "i0"  # u0 last saw i5
    np.testing.assert_allclose(got_loss, want_loss,
                               rtol=TRAINER_LOSS_RTOL[dense])
    assert got_loss < 0.5  # it learned the cycle


def test_trainer_is_reproducible_and_moves_the_init():
    _cfg, seqs, uids, iids = _cyclic()
    cfg = tsa.SeqRecConfig(**{**CYCLE_CFG, "epochs": 2})
    once = tsa.train_seq_rec(seqs, uids, iids, cfg, device="cpu")
    twice = tsa.train_seq_rec(seqs, uids, iids, cfg, device="cpu")
    init = _flat(tsa.init_params(len(iids), cfg, 0))
    for key, v in _flat(once.params).items():
        np.testing.assert_array_equal(v, _flat(twice.params)[key])
        assert v.dtype == np.float32
    assert any(not np.array_equal(v, init[k])
               for k, v in _flat(once.params).items())
    assert once.device == torch.device("cpu")


def test_trainer_handles_users_without_history_and_wraps(monkeypatch):
    """Empty histories are dropped, and a tail batch wraps (7 users in
    batches of 3: three batches, the last one reusing two users)."""
    seqs = np.zeros((9, 6), np.int32)
    seqs[:7, 2:] = (np.arange(7)[:, None] + np.arange(4)) % 8 + 1
    from predictionio_tpu_torch.storage.bimap import BiMap

    uids = BiMap({f"u{i}": i for i in range(9)})
    iids = BiMap({f"i{j}": j for j in range(8)})
    cfg = tsa.SeqRecConfig(max_len=6, embed_dim=16, num_heads=2,
                           num_blocks=1, epochs=1, batch_size=3)
    steps = []
    real = tsa.seq_rec_loss

    def spy(net, batch, *args, **kw):
        steps.append(batch.clone())
        return real(net, batch, *args, **kw)

    monkeypatch.setattr(tsa, "seq_rec_loss", spy)
    tsa.train_seq_rec(seqs, uids, iids, cfg, device="cpu")
    assert [tuple(b.shape) for b in steps] == [(3, 6)] * 3
    rows = torch.cat(steps)
    assert bool((rows > 0).any(1).all())  # no empty history trained
    assert len({tuple(r.tolist()) for r in rows}) == 7


def test_trainer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: training succeeds")
    _cfg, seqs, uids, iids = _cyclic()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsa.train_seq_rec(seqs, uids, iids, tsa.SeqRecConfig(epochs=1))


def test_to_flax_round_trips_and_jax_apply_agrees():
    cfg = JaxConfig(max_len=16, embed_dim=32, num_heads=4, num_blocks=2)
    seqs, _u, iids = jax_build_sequences(*_events(), max_len=16)
    model = _make_model(len(iids), cfg)
    params = _perturbed(model.init(jax.random.PRNGKey(7),
                                   jnp.zeros((2, 16), jnp.int32)), 7)
    tcfg = tsa.SeqRecConfig(**cfg.__dict__)
    net = tsa.SeqRec(len(iids), tcfg).load_flax(params)
    exported = net.to_flax()
    flat, want = _flat(exported), _flat(params)
    assert flat.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(flat[key], v)
    again = tsa.SeqRec(len(iids), tcfg).load_flax(exported)
    for a, b in zip(again.parameters(), net.parameters()):
        assert torch.equal(a, b)
    with torch.no_grad():
        got = net(torch.from_numpy(seqs)).numpy()
    jax_logits = np.asarray(model.apply(exported, jnp.asarray(seqs)))
    np.testing.assert_allclose(got, jax_logits, rtol=2.0**-7, atol=2.0**-7)


class _Memory(DataSource):
    """An in-memory data source: the event store comes with the storage
    slice."""

    events: tuple = ()

    def read_training(self, ctx):
        return tengine.TrainingData(*self.events)


def _engine(events):
    engine = tengine.engine_factory()
    engine.data_source_classes = {"": type("Mem", (_Memory,),
                                           {"events": events})}
    return engine


def test_template_learns_the_cycle_through_engine_train():
    """test_seq_rec_learns_cycle's semantics through Engine.train."""
    engine = _engine(_cyclic_history())
    ep = EngineParams(algorithm_params_list=(
        ("seqrec", tengine.AlgorithmParams(**CYCLE_CFG)),))
    ctx = Context(device="cpu")
    result = engine.train(ctx, ep)
    model = result.models[0]
    assert model.recommend_products("u0", 2, exclude_seen=False)[0][0] == "i0"
    assert [p for p, _ in ctx.phase_times] == [
        "datasource.read_training", "preparator.prepare", "train[seqrec#0]"]


def test_template_next_item_prediction():
    """TestSeqRec.test_next_item_prediction's semantics through the port:
    48 users view 4 of 6 items in a cycle; u0 viewed i0..i3, so the next
    is i4; batched and single predictions agree; unknown users get
    nothing."""
    users, items, times = [], [], []
    for u in range(48):
        for t in range(4):
            users.append(f"u{u}")
            items.append(f"i{(u + t) % 6}")
            times.append(float(t))
    engine = _engine((np.asarray(users, dtype=object),
                      np.asarray(items, dtype=object), np.asarray(times)))
    ep = EngineParams(algorithm_params_list=(
        ("seqrec", tengine.AlgorithmParams(
            max_len=4, embed_dim=32, num_heads=2, num_blocks=1, epochs=40,
            batch_size=48, lr=3e-3)),))
    result = engine.train(Context(device="cpu"), ep)
    algo, model = result.algorithms[0], result.models[0]
    out = algo.predict(model, tengine.Query(user="u0", num=2))
    assert out.itemScores and out.itemScores[0].item == "i4"
    queries = [(0, tengine.Query(user="u0", num=2)),
               (1, tengine.Query(user="u5", num=3)),
               (2, tengine.Query(user="nosuch", num=2))]
    got = dict(algo.batch_predict(model, queries))
    assert [s.item for s in got[0].itemScores] == \
        [s.item for s in out.itemScores]
    single = algo.predict(model, tengine.Query(user="u5", num=3))
    assert [s.item for s in got[1].itemScores] == \
        [s.item for s in single.itemScores]
    np.testing.assert_allclose([s.score for s in got[1].itemScores],
                               [s.score for s in single.itemScores],
                               rtol=1e-5, atol=1e-6)
    assert got[2].itemScores == ()


def test_engine_train_sanity_check_and_stop_after_read():
    empty = (np.asarray([], dtype=object), np.asarray([], dtype=object),
             np.asarray([]))
    ep = EngineParams(algorithm_params_list=(
        ("seqrec", tengine.AlgorithmParams(epochs=1)),))
    with pytest.raises(ValueError, match="No interaction events"):
        _engine(empty).train(Context(device="cpu"), ep)
    ctx = Context(device="cpu",
                  workflow_params=WorkflowParams(stop_after_read=True))
    with pytest.raises(StopAfterReadInterruption):
        _engine(_cyclic_history()).train(ctx, ep)


def test_engine_train_stop_after_prepare_and_skip_sanity_check():
    """``stop_after_prepare`` stops after the preparator ran;
    ``skip_sanity_check`` lets empty training data through to it."""
    empty = (np.asarray([], dtype=object), np.asarray([], dtype=object),
             np.asarray([]))
    ep = EngineParams(algorithm_params_list=(
        ("seqrec", tengine.AlgorithmParams(epochs=1)),))
    ctx = Context(device="cpu", workflow_params=WorkflowParams(
        skip_sanity_check=True, stop_after_prepare=True))
    with pytest.raises(StopAfterPrepareInterruption):
        _engine(empty).train(ctx, ep)
    assert [p for p, _ in ctx.phase_times] == [
        "datasource.read_training", "preparator.prepare"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the attention kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_kernels_match_plain_on_the_card(cuda_device):
    cfg = tsa.SeqRecConfig(max_len=16, embed_dim=32, num_heads=2,
                           num_blocks=2)
    seqs, _u, iids = tsa.build_sequences(*_events(), max_len=16)
    batch = torch.from_numpy(seqs).to(cuda_device)
    tree = tsa.init_params(len(iids), cfg, 5)
    grads, losses = [], []
    for attention in (tsa.flash_attention, blockwise_attention):
        net = tsa.SeqRec(len(iids), cfg).load_flax(tree).to(cuda_device)
        before = dict(kernels.LAUNCHES)
        loss = tsa.seq_rec_loss(net, batch, attention)
        loss.backward()
        torch.cuda.synchronize()
        if attention is tsa.flash_attention:
            for key in ("flash_attention", "flash_attention_bwd_dkv",
                        "flash_attention_bwd_dq"):
                assert kernels.LAUNCHES[key] == before[key] + cfg.num_blocks
        losses.append(float(loss.detach()))
        grads.append(_flat(_grads_as_flax(net.cpu(), len(iids), cfg)))
    np.testing.assert_allclose(losses[0], losses[1], rtol=LOSS_RTOL)
    for key, w in grads[1].items():
        err = float(np.abs(grads[0][key] - w).max())
        assert err <= GRAD_TOL["bf16"] * float(np.abs(w).max()), (key, err)
