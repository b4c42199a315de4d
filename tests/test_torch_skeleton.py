"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package, and it never falls back to the CPU behind the caller's back.

The import pin runs in a subprocess: this test process has jax loaded
already (``tests/conftest.py`` imports it), so only a fresh interpreter can
show what importing the port, serving through it (two variants with
feedback on) and training through it pulls in.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "predictionio_tpu_torch"

_DRIVE = r"""
import importlib, json, pkgutil, sys
import numpy as np
import predictionio_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, "predictionio_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from predictionio_tpu_torch.controller import FirstServing, TrainResult
from predictionio_tpu_torch.convert import als_model_from_numpy
from predictionio_tpu_torch.templates.recommendation import engine
from predictionio_tpu_torch.workflow.create_server import EngineServer, serve
import urllib.request

rng = np.random.default_rng(0)
model = als_model_from_numpy(
    rng.standard_normal((20, 8)).astype(np.float32),
    rng.standard_normal((300, 8)).astype(np.float32),
    [f"u{i}" for i in range(20)], [f"i{j}" for j in range(300)],
    rank=8, lambda_=0.1, device="cpu")
result = TrainResult([model], [engine.ALSAlgorithm(engine.AlgorithmParams())],
                     FirstServing(), ["als"])
# two variants on one server, each publishing feedback (to a closed port)
server, child = (EngineServer(
    engine.engine_factory(), TrainResult(
        [als_model_from_numpy(
            rng.standard_normal((20, 8)).astype(np.float32),
            rng.standard_normal((300, 8)).astype(np.float32),
            [f"u{i}" for i in range(20)], [f"i{j}" for j in range(300)],
            rank=8, lambda_=0.1, device="cpu")],
        [engine.ALSAlgorithm(engine.AlgorithmParams())], FirstServing(),
        ["als"]), f"pin-{vid}", device="cpu", batch_max=8, variant_id=vid,
    feedback_url="http://127.0.0.1:9", access_key="k")
    for vid in ("default", "b"))
server.variants.register("b", child, weight=1.0)
answered = set()
with serve(server, "127.0.0.1", 0) as front:
    for user in ("u3", "u4", "u5", "u6"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/queries.json",
            data=json.dumps({"user": user, "num": 4}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
            answered.add(json.loads(
                resp.headers["X-PIO-Provenance"])["variantId"])
    # every publish's first post made (a drain discards those not started)
    import time
    end = time.monotonic() + 30
    while time.monotonic() < end and any(
            s.feedback.stats()["inflightTasks"] for s in (server, child)):
        time.sleep(0.01)
from predictionio_tpu_torch.convert import seqrec_model_from_numpy
from predictionio_tpu_torch.models.seq_attention import SeqRecConfig, init_params
from predictionio_tpu_torch.templates.seqrec import engine as seng

cfg = SeqRecConfig(max_len=8, embed_dim=16, num_heads=2, num_blocks=1)
seqs = rng.integers(0, 31, (6, 8)).astype(np.int32)
srec = seqrec_model_from_numpy(
    init_params(30, cfg, seed=0), seqs, [f"s{i}" for i in range(6)],
    [f"i{j}" for j in range(30)], cfg, device="cpu")
sresult = TrainResult([srec], [seng.SeqRecAlgorithm(seng.AlgorithmParams())],
                      FirstServing(), ["seqrec"])
sserver = EngineServer(seng.engine_factory(), sresult, "pin-seq",
                       device="cpu", batch_max=8)
with serve(sserver, "127.0.0.1", 0) as front:
    req = urllib.request.Request(
        f"http://127.0.0.1:{front.port}/queries.json",
        data=b'{"user": "s2", "num": 3}', method="POST")
    sbody = json.loads(urllib.request.urlopen(req, timeout=30).read())
from predictionio_tpu_torch.controller import DataSource, EngineParams
from predictionio_tpu_torch.workflow.context import Context

class Events(DataSource):
    def read_training(self, ctx):
        users = np.asarray([f"s{u}" for u in range(6) for _ in range(5)],
                           dtype=object)
        items = np.asarray([f"i{(u + t) % 7}" for u in range(6)
                            for t in range(5)], dtype=object)
        return seng.TrainingData(users, items,
                                 np.tile(np.arange(5.0), 6))

tengine = seng.engine_factory()
tengine.data_source_classes = {"": Events}
trained = tengine.train(Context(device="cpu"), EngineParams(
    algorithm_params_list=(("seqrec", seng.AlgorithmParams(
        max_len=6, embed_dim=16, num_heads=2, num_blocks=1, epochs=1,
        batch_size=4)),)))
trained_items = trained.models[0].recommend_products("s1", 2)
print(json.dumps({
    "modules": len(names),
    "trained_items": len(trained_items),
    "items": len(body["itemScores"]),
    "variants": sorted(answered),
    "feedback_published": sum(s.feedback.stats()["failed"]
                              + s.feedback.stats()["sent"]
                              + s.feedback.stats()["dropped"]
                              for s in (server, child)),
    "seq_items": len(sbody["itemScores"]),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "jaxlib" or m.startswith("jaxlib.")),
    "reference": sorted(m for m in sys.modules if m == "predictionio_tpu"
                        or m.startswith("predictionio_tpu.")),
    "aiohttp": sorted(m for m in sys.modules if m == "aiohttp"
                      or m.startswith("aiohttp.")),
}))
"""


def test_port_never_loads_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 20
    assert out["items"] == 4
    assert out["variants"] == ["b", "default"]
    assert out["feedback_published"] >= 4  # a retry may have posted too
    assert out["seq_items"] == 3
    assert out["trained_items"] == 2
    assert out["jax"] == []
    assert out["reference"] == []
    assert out["aiohttp"] == []


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                            "predictionio_tpu", "templates", "aiohttp"), (
            path, mod)


#: the console, the event server and what they brought into the port
CONSOLE_MODULES = [
    "predictionio_tpu_torch.tools.cli",
    "predictionio_tpu_torch.tools.import_export",
    "predictionio_tpu_torch.tools.templates",
    "predictionio_tpu_torch.api",
    "predictionio_tpu_torch.api.event_server",
    "predictionio_tpu_torch.api.stats",
    "predictionio_tpu_torch.api.webhooks",
    "predictionio_tpu_torch.api.webhooks.base",
    "predictionio_tpu_torch.api.webhooks.mailchimp",
    "predictionio_tpu_torch.api.webhooks.segmentio",
    "predictionio_tpu_torch.obs.http",
    "predictionio_tpu_torch.obs.trace",
]

#: evaluation (``pio eval``): the controller's metrics, evaluation and
#: FastEval modules, the workflow that runs them and the templates
EVAL_MODULES = [
    "predictionio_tpu_torch.controller.metric",
    "predictionio_tpu_torch.controller.evaluation",
    "predictionio_tpu_torch.controller.fast_eval",
    "predictionio_tpu_torch.workflow",
    "predictionio_tpu_torch.templates.recommendation.engine",
    "predictionio_tpu_torch.templates.movielensevaluation",
    "predictionio_tpu_torch.templates.movielensevaluation.engine",
]

#: tuning (``pio tune``): the tuning workflow and the sample engine its
#: serial path runs
TUNE_MODULES = [
    "predictionio_tpu_torch.workflow.tuning",
    "predictionio_tpu_torch.testing",
    "predictionio_tpu_torch.testing.sample_engine",
]

#: the engine server's instrumentation and golden traffic: waterfalls,
#: flight recorder, SLO tracker, device ledger, capture, replay, shadow
OBS_MODULES = [
    "predictionio_tpu_torch.obs.waterfall",
    "predictionio_tpu_torch.obs.flight",
    "predictionio_tpu_torch.obs.slo",
    "predictionio_tpu_torch.obs.device",
    "predictionio_tpu_torch.obs.capture",
    "predictionio_tpu_torch.obs.replay",
    "predictionio_tpu_torch.workflow.microbatch",
    "predictionio_tpu_torch.workflow.tracing",
    "predictionio_tpu_torch.workflow.create_server",
    "predictionio_tpu_torch.workflow.variants",
    "predictionio_tpu_torch.workflow.feedback",
]

_FORBIDDEN = ("jax", "jaxlib", "predictionio_tpu", "aiohttp")

_IMPORT_ONE = r"""
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in %r)))
""" % (_FORBIDDEN,)


@pytest.fixture(scope="module")
def console_imports():
    """Each console module imported alone in a fresh interpreter (four at
    a time): the forbidden modules each one loaded."""
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, PYTHONPATH=str(REPO))

    def one(module):
        proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                              cwd=str(REPO), env=env, capture_output=True,
                              text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    modules = CONSOLE_MODULES + EVAL_MODULES + TUNE_MODULES + OBS_MODULES
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(modules, pool.map(one, modules)))


@pytest.mark.parametrize("module", CONSOLE_MODULES + EVAL_MODULES
                         + TUNE_MODULES + OBS_MODULES)
def test_console_module_loads_no_jax_or_aiohttp(console_imports, module):
    assert console_imports[module] == []


def test_pio_status_runs_without_jax(tmp_path):
    """``python -m predictionio_tpu_torch.tools.cli status`` exits 0 and
    names the devices; ``-X importtime`` lists every module it imported,
    and none is jax, aiohttp or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PIO_HOME=str(tmp_path))
    env.pop("PIO_PLATFORM", None)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "predictionio_tpu_torch.tools.cli", "status"], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "devices: " in proc.stdout
    assert "Your system is all ready to go." in proc.stdout
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in
                proc.stderr.splitlines() if ln.startswith("import time:")]
    assert "predictionio_tpu_torch.tools" in imported  # cli runs as __main__
    assert [m for m in imported if m.split(".")[0] in _FORBIDDEN] == []


def test_resolve_device_raises_without_cuda():
    from predictionio_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_pins_full_f32():
    from predictionio_tpu_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    torch.set_float32_matmul_precision("high")
    try:
        resolve_device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision("highest")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_deploy_without_cuda_raises():
    """No silent host serving: a server asked for the default device on a
    machine without one refuses to deploy."""
    import numpy as np

    from predictionio_tpu_torch.controller import FirstServing, TrainResult
    from predictionio_tpu_torch.models.als import ALSConfig, ALSModel
    from predictionio_tpu_torch.storage.bimap import BiMap
    from predictionio_tpu_torch.templates.recommendation import engine
    from predictionio_tpu_torch.workflow.create_server import EngineServer

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: deploy succeeds")
    model = ALSModel(np.ones((2, 4), np.float32), np.ones((3, 4), np.float32),
                     BiMap({"a": 0, "b": 1}), BiMap({"x": 0, "y": 1, "z": 2}),
                     ALSConfig(rank=4))
    result = TrainResult([model], [engine.ALSAlgorithm(engine.AlgorithmParams())],
                         FirstServing(), ["als"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineServer(engine.engine_factory(), result, "x")
    assert getattr(model, "_retriever", None) is None


#: every kernel source under csrc/ and the TPU kernel it names as replaced
#: (or that it replaces none)
_REPLACES = {
    "topk.cu": "predictionio_tpu/ops/retrieval.py::_topk_kernel",
    "flash_attn.cu": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                     "::_flash_attention_kernel",
    "flash_attn_bwd.cu": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                         "\n// _flash_attention_dkv_kernel (dK, dV) and "
                         "_flash_attention_dq_kernel (dQ)",
    # head dims above 256, which the JAX package answers with plain
    # blockwise_attention: no TPU kernel to name
    "flash_attn_wide.cu": "Replaces no TPU kernel.",
    "flash_attn_wide_fwd.cu": "Replaces no TPU kernel.",
    # head dims above 1,024, likewise
    "flash_attn_huge.cu": "Replaces no TPU kernel.",
}


def test_every_kernel_source_is_known():
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == \
        sorted(_REPLACES)


@pytest.mark.parametrize("name", sorted(_REPLACES))
def test_kernel_source_targets_hopper(name):
    from predictionio_tpu_torch.ops import kernels

    path = PORT / "csrc" / name
    src = path.read_text()
    assert _REPLACES[name] in src
    assert "sm_90a" in src  # written for Hopper, and says so
    assert "#include <torch" not in src  # plain C interface: seconds to build
    assert "#include <ATen" not in src and "#include <c10" not in src
    assert path in kernels.SOURCES  # built by the one load() call
    assert kernels.BUILD_DIR == PORT / "_build"
    gitignore = (REPO / ".gitignore").read_text().split()
    assert "predictionio_tpu_torch/_build/" in gitignore
