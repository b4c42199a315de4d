"""Engine server: deploys a trained engine as an HTTP service on the device.

The port of ``predictionio_tpu/workflow/create_server.py``'s serving core:

- ``Deployed`` attaches each retrieval model's catalog to a
  ``DeviceRetriever`` and its query table to a ``ServingPipeline``, and
  builds each network model (seqrec) on the server's device, then prewarms
  the batch lattice of both. A failed attach raises: the server never
  serves on the host in silence.
- ``EngineServer`` serves single queries and micro-batches
  (``serve_query`` / ``serve_query_batch``) through a ``MicroBatcher``. It
  is built from a stored ``EngineInstance`` (``prepare_deploy``: the blob
  checksum, then the fallback walk over older COMPLETED instances of the
  same engine triple, whose skips land in ``deploy_skips``) or from an
  in-memory ``(engine, TrainResult, instance_id)``. ``reload_latest()``
  swaps a storage-backed server to the newest COMPLETED instance: the
  fresh bundle is attached and prewarmed while the old one keeps serving,
  then swapped in one reference assignment.
- ``serve(server, host, port)`` is the HTTP front end on the standard
  library: ``POST /queries.json``, ``GET /`` (status), ``GET /stats.json``
  and ``GET /reload``. Handler threads submit to the batcher's asyncio
  loop, which runs on a background thread.

``POST /reload/delta`` (streaming fold-in) comes with the streaming
slice.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import logging
import threading
import time
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..controller.engine import Engine, TrainResult
from ..controller.params import parse_params
from ..device import resolve_device
from ..obs.metrics import METRICS
from ..ops import kernels
from ..storage import EngineInstance, Storage
from .context import Context
from .core_workflow import prepare_deploy
from .microbatch import DeadlineExceeded, DispatchTimeout, MicroBatcher, ServerBusy

log = logging.getLogger("predictionio_tpu_torch.server")

__all__ = ["BadQuery", "Deployed", "EngineServer", "HttpServing", "serve"]

_M_SERVE = METRICS.histogram(
    "pio_serving_latency_seconds",
    "end-to-end POST /queries.json latency as the client saw it")
_M_QUERIES = METRICS.counter(
    "pio_queries_total",
    "queries by outcome (ok/bad_request/busy/deadline/watchdog/error)",
    labelnames=("status",))

#: Stuck-dispatch watchdog of the micro-batcher (the JAX server's default):
#: a batch still running after this long answers 504 instead of hanging.
DISPATCH_TIMEOUT_S = 30.0


class BadQuery(ValueError):
    """A query that does not decode into the algorithm's query class; the
    HTTP layer answers 400 for it alone, the rest of its batch is served."""


def _to_jsonable(x: Any) -> Any:
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):  # numpy scalar
        return x.item()
    return x


@dataclasses.dataclass
class Deployed:
    """One deployed engine instance on one device (the swap unit of
    ``reload_latest``). ``prewarm_batch`` > 0 launches the kernel at
    deploy for every pad bucket up to that batch ceiling. ``instance`` is
    the stored record a storage-backed deploy came from."""

    instance_id: str
    result: TrainResult
    device: Any = None
    prewarm_batch: int = 0
    instance: EngineInstance | None = None
    warmed: list = dataclasses.field(default_factory=list, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for model in self.result.models:
            attach_model = getattr(model, "attach_model", None)
            if attach_model is not None:
                attach_model(device=self.device)
                log.info("%s attached on %s", type(model).__name__,
                         self.device)
                continue
            attach = getattr(model, "attach_retriever", None)
            if attach is None:
                continue  # not a retrieval model: nothing to put on device
            attach(device=self.device)
            log.info("device retriever attached to %s on %s",
                     type(model).__name__, self.device)
            if getattr(model, getattr(model, "_query_attr", ""), None) \
                    is not None:
                model.attach_pipeline()
                log.info("serving pipeline attached to %s",
                         type(model).__name__)
        if self.prewarm_batch > 0:
            self._prewarm()

    def _prewarm(self):
        """Launch the kernels for the full pad-bucketed batch lattice —
        every power-of-two bucket up to the micro-batcher's ceiling — so no
        query pays the kernel build or a first launch: the retriever and
        pipeline of a retrieval model, the forward of a network model."""
        lattice = {1, self.prewarm_batch}
        b = 8
        while b < self.prewarm_batch:
            lattice.add(b)
            b *= 2
        sizes = sorted(lattice)
        for model in self.result.models:
            if getattr(model, "attach_model", None) is not None:
                warmed = model.prewarm(batch_sizes=sizes)
                self.warmed.extend(warmed)
                log.info("prewarmed %s forward at b_pad %s",
                         type(model).__name__, warmed)
                continue
            for attr in ("_retriever", "_pipeline"):
                r = getattr(model, attr, None)
                if r is not None:
                    warmed = r.prewarm(batch_sizes=sizes)
                    self.warmed.extend(warmed)
                    log.info("prewarmed %s.%s shapes %s",
                             type(model).__name__, attr, warmed)


class EngineServer:
    """Holds the deployed bundle + bookkeeping; the HTTP handlers delegate
    here.

    ``source`` is a stored ``EngineInstance`` (its blob is rehydrated by
    ``prepare_deploy``; a corrupt or unloadable blob makes the deploy walk
    to the next-newest COMPLETED instance of the same engine triple, and
    the first error is raised when none loads) or an in-memory
    ``TrainResult`` served under ``instance_id``."""

    def __init__(self, engine: Engine,
                 source: EngineInstance | TrainResult,
                 instance_id: str | None = None, *,
                 ctx: Context | None = None, device=None,
                 batch_window_ms: float = 1.0,
                 batch_max: int = 128, batch_inflight: int = 8):
        self.engine = engine
        self.batch_max = batch_max
        self.device = resolve_device(device)
        self.ctx = ctx or Context(mode="Serving", device=self.device)
        #: instances skipped by the most recent deploy/reload because
        #: their blob was corrupt or unloadable (status() reports them)
        self.deploy_skips: list[dict] = []
        self._reload_lock = threading.Lock()  # serialize reloads
        if isinstance(source, EngineInstance):
            inst, result, self.deploy_skips = \
                self._deploy_with_fallback(source)
            self.deployed = Deployed(inst.id, result, device=self.device,
                                     prewarm_batch=batch_max, instance=inst)
        else:
            if instance_id is None:
                raise ValueError("an in-memory TrainResult needs an "
                                 "instance_id")
            self.deployed = Deployed(instance_id, source, device=self.device,
                                     prewarm_batch=batch_max)
        self.start_time = datetime.now(timezone.utc)
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        # serving stats are read-modify-written from several dispatch
        # threads; the lock keeps the running average exact
        self._stats_lock = threading.Lock()
        # micro-batching dispatcher: coalesce concurrent queries into one
        # kernel call; window <= 0 disables (per-query dispatch)
        self.batcher = None
        if batch_window_ms > 0:
            self.batcher = MicroBatcher(
                self.serve_query_batch,
                max_batch=batch_max, window_s=batch_window_ms / 1000.0,
                max_inflight=batch_inflight,
                adaptive=True,  # window_s is a ceiling: an idle server adds
                # ~0 latency, a loaded one stretches toward a full batch
                dispatch_timeout_s=DISPATCH_TIMEOUT_S,
            )

    @property
    def engine_instance_id(self) -> str:
        return self.deployed.instance_id

    # -- query hot path ----------------------------------------------------
    @staticmethod
    def _decode(algo, query_json: dict):
        decode = getattr(algo, "decode_query", None)
        try:
            if decode is not None:
                return decode(query_json)
            qcls = getattr(algo, "query_class", None)
            return (parse_params(qcls, query_json) if qcls is not None
                    else query_json)
        except (ValueError, TypeError, KeyError) as e:
            raise BadQuery(str(e)) from e

    def serve_query(self, query_json: dict) -> dict:
        """Single-query path (batching disabled)."""
        tag, payload = self.serve_query_batch([query_json])[0]
        if tag == "err":
            raise payload
        return payload

    def serve_query_batch(self, query_jsons) -> list[tuple[str, Any]]:
        """Serve a coalesced batch; one outcome ("ok", result) |
        ("err", BadQuery) PER query — a malformed query fails alone. Each
        algorithm predicts its whole sub-batch through ``batch_predict``
        (one kernel call for a retrieval model); a failure there raises
        for the whole batch."""
        t0 = time.perf_counter()
        bundle = self.deployed
        result = bundle.result
        n = len(query_jsons)
        errors: dict[int, Exception] = {}
        first_qs: list[Any] = list(query_jsons)
        per_algo: list[dict[int, Any]] = []
        for ai, (algo, model) in enumerate(zip(result.algorithms, result.models)):
            decoded: list[tuple[int, Any]] = []
            for i, qj in enumerate(query_jsons):
                if i in errors:
                    continue
                try:
                    q = self._decode(algo, qj)
                except BadQuery as e:
                    errors[i] = e
                    continue
                if ai == 0:
                    first_qs[i] = q
                decoded.append((i, q))
            per_algo.append(dict(algo.batch_predict(model, decoded))
                            if decoded else {})

        outcomes: list[tuple[str, Any]] = []
        for i in range(n):
            if i in errors:
                outcomes.append(("err", errors[i]))
                continue
            preds = [pa[i] for pa in per_algo]
            served = result.serving.serve(first_qs[i], preds)
            outcomes.append(("ok", _to_jsonable(served)))

        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.request_count += n
            self.last_serving_sec = dt / n
            self.avg_serving_sec += (
                (dt / n - self.avg_serving_sec) * n / self.request_count)
        return outcomes

    # -- deploy fallback (blob integrity / unloadable blobs) ---------------
    def _deploy_with_fallback(self, first: EngineInstance):
        """Try ``first``; when its blob is corrupt (ModelIntegrityError)
        or unloadable, walk the next-newest COMPLETED instances of the
        same engine triple. Returns (instance, TrainResult, skips);
        re-raises the FIRST error when every candidate fails."""
        candidates = [first]
        try:
            meta = Storage.get_metadata()
            for c in meta.engine_instance_get_completed(
                    first.engine_id, first.engine_version, first.engine_variant):
                if all(c.id != x.id for x in candidates):
                    candidates.append(c)
        except Exception:  # metadata unreachable: just try `first`
            log.exception("could not list fallback candidates")
        skips: list[dict] = []
        first_err: Exception | None = None
        for cand in candidates:
            try:
                result = prepare_deploy(self.engine, cand, self.ctx)
            except Exception as e:  # noqa: BLE001 — try the next-newest
                if first_err is None:
                    first_err = e
                skips.append({"engineInstanceId": cand.id,
                              "error": f"{type(e).__name__}: {e}"})
                log.error(
                    "deploy of engine instance %s failed (%s: %s); "
                    "falling back to the next-newest COMPLETED instance",
                    cand.id, type(e).__name__, e)
                continue
            if skips:
                log.warning(
                    "deployed engine instance %s after skipping %d "
                    "corrupt/unloadable newer instance(s): %s",
                    cand.id, len(skips),
                    [s["engineInstanceId"] for s in skips])
            return cand, result, skips
        assert first_err is not None
        raise first_err

    # -- hot reload (MasterActor ReloadServer, :315-336) -------------------
    def reload_latest(self) -> str:
        """Swap to the newest COMPLETED instance of the served engine
        triple (with the fallback walk); returns the instance id now
        serving. The fresh bundle is attached and prewarmed before the
        swap, so the old one answers every query until then; a failed
        attach raises and leaves the old bundle serving."""
        with self._reload_lock:
            return self._reload_latest()

    def _reload_latest(self) -> str:
        inst = self.deployed.instance
        if inst is None:
            raise RuntimeError("reload needs a server deployed from storage "
                               "(an EngineInstance), not a TrainResult")
        latest = Storage.get_metadata().engine_instance_get_latest_completed(
            inst.engine_id, inst.engine_version, inst.engine_variant)
        if latest is None:
            raise RuntimeError("no COMPLETED engine instance to reload")
        # fallback walk: a corrupt newest blob must not take down a
        # healthy server — the old bundle keeps serving while we try the
        # next-newest COMPLETED instance
        fresh_inst, result, skips = self._deploy_with_fallback(latest)
        fresh = Deployed(fresh_inst.id, result, device=self.device,
                         prewarm_batch=self.batch_max, instance=fresh_inst)
        self.deployed = fresh  # atomic reference swap
        self.deploy_skips = skips
        # the old bundle's device tensors go with its last reference (a
        # batch in flight on it holds one until it answers); a reference
        # cycle through it would keep them until the collector runs
        gc.collect()
        log.info("Reloaded engine instance %s", fresh_inst.id)
        return fresh_inst.id

    async def dispatch_query(self, query_json: dict):
        """The one query entry for the HTTP layer: the micro-batcher, or a
        worker thread when batching is disabled."""
        if self.batcher is None:
            return await asyncio.to_thread(self.serve_query, query_json)
        return await self.batcher.submit(query_json)

    def status(self) -> dict:
        inst = self.deployed.instance
        return {
            "status": "alive",
            "engineInstanceId": self.engine_instance_id,
            **({"engineVariant": inst.engine_variant,
                "engineFactory": inst.engine_factory} if inst else {}),
            "deploySkips": list(self.deploy_skips),
            "startTime": self.start_time.isoformat(),
            "requestCount": self.request_count,
            "avgServingSec": self.avg_serving_sec,
            "lastServingSec": self.last_serving_sec,
            "algorithms": [type(a).__name__
                           for a in self.deployed.result.algorithms],
            "device": str(self.deployed.device),
            **({"batching": self.batcher.stats()} if self.batcher else {}),
        }

    def serving_stats(self) -> dict:
        """Machine-readable serving telemetry (GET /stats.json)."""
        with self._stats_lock:
            counters = {
                "requestCount": self.request_count,
                "avgServingSec": self.avg_serving_sec,
                "lastServingSec": self.last_serving_sec,
            }
        pipeline = None
        for model in self.deployed.result.models:
            p = getattr(model, "_pipeline", None)
            if p is not None:
                pipeline = p.stats()
                break

        def _hist(name: str):
            h = METRICS.get(name)
            return h.snapshot() if h is not None else None

        return {
            **counters,
            "latency": {
                "serving": _hist("pio_serving_latency_seconds"),
                "queueWait": _hist("pio_microbatch_queue_wait_seconds"),
                "dispatch": _hist("pio_microbatch_dispatch_seconds"),
                "device": _hist("pio_microbatch_device_seconds"),
            },
            "batching": self.batcher.stats() if self.batcher else None,
            "pipeline": pipeline,
            "kernelLaunches": dict(kernels.LAUNCHES),
            "device": str(self.deployed.device),
        }


def _http_status(e: BaseException) -> tuple[str, int]:
    """(outcome label, HTTP status) of a failed query, as the JAX server
    answers: 400 malformed, 503 busy, 504 deadline or watchdog; any other
    failure is the server's own (500)."""
    if isinstance(e, BadQuery):
        return "bad_request", 400
    if isinstance(e, ServerBusy):
        return "busy", 503
    if isinstance(e, DeadlineExceeded):
        return "deadline", 504
    if isinstance(e, DispatchTimeout):
        return "watchdog", 504
    return "error", 500


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default backlog of 5 drops connects under a burst of
    # concurrent clients, which then retry after a 1 s SYN timeout
    request_queue_size = 1024


class HttpServing:
    """A running HTTP front end: a ``ThreadingHTTPServer`` on one thread
    and the micro-batcher's asyncio loop on another. ``close()`` stops
    both, after the batcher has drained."""

    def __init__(self, server: EngineServer, host: str, port: int):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self.loop.run_forever, name="pio-batcher-loop",
            daemon=True)
        self._loop_thread.start()
        self.httpd = _HTTPServer((host, port), _handler_for(self))
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="pio-http", daemon=True)
        self._http_thread.start()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def query(self, query_json: dict):
        """Serve one query on the batcher's loop (from any thread)."""
        return asyncio.run_coroutine_threadsafe(
            self.server.dispatch_query(query_json), self.loop).result()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.server.batcher is not None:
            asyncio.run_coroutine_threadsafe(
                self.server.batcher.drain(), self.loop).result()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._loop_thread.join()
        self._http_thread.join()
        self.loop.close()

    def __enter__(self) -> "HttpServing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _handler_for(front: HttpServing):
    server = front.server

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body leave in two writes; with Nagle on, the second
        # waits for the client's delayed ACK (~40 ms)
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route through logging
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, body) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/":
                self._send(200, server.status())
            elif path == "/stats.json":
                self._send(200, server.serving_stats())
            elif path == "/reload":
                try:
                    iid = server.reload_latest()
                except Exception as e:  # noqa: BLE001 — answer, log
                    log.exception("reload failed")
                    self._send(500, {"message": str(e)})
                else:
                    self._send(200, {"message": "Reloaded",
                                     "engineInstanceId": iid})
            else:
                self._send(404, {"message": f"no route {path}"})

        def do_POST(self):
            t0 = time.perf_counter()
            path = self.path.split("?", 1)[0]
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length)
            if path != "/queries.json":
                self._send(404, {"message": f"no route {path}"})
                return
            label, status = "ok", 200
            try:
                query_json = json.loads(raw)
            except (json.JSONDecodeError, UnicodeDecodeError):
                label, status = "bad_request", 400
                body = {"message": "Malformed JSON body."}
            else:
                if not isinstance(query_json, dict):
                    label, status = "bad_request", 400
                    body = {"message": "Query must be a JSON object."}
                else:
                    try:
                        body = front.query(query_json)
                    except Exception as e:  # noqa: BLE001 — answer, log
                        label, status = _http_status(e)
                        if status >= 500:
                            log.exception("query failed")
                        body = {"message": str(e)}
            _M_SERVE.record(time.perf_counter() - t0)
            _M_QUERIES.inc(status=label)
            self._send(status, body)

    return Handler


def serve(server: EngineServer, host: str = "0.0.0.0",
          port: int = 8000) -> HttpServing:
    """Start the HTTP front end for ``server`` on ``host:port`` (port 0
    picks a free one) and return it running; ``close()`` stops it."""
    return HttpServing(server, host, port)
