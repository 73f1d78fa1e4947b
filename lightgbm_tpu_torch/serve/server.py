"""Threaded HTTP JSON serving endpoint with a hot-swap model registry.

The port's copy of lightgbm_tpu/serve/server.py. Stdlib only (http.server +
threading + json). One process serves on one device, the ``device`` of
``ServeApp`` (default ``cuda``; it refuses to start when that device is
absent, instead of serving on the CPU). The request path is

    HTTP thread -> MicroBatcher queue -> worker thread -> BucketedDispatcher
    (pad to pow2 rows) -> packed device dispatch -> fan results back out

Endpoints:
  GET  /healthz       liveness + backend + model readiness (+ draining)
  GET  /metrics       Prometheus text exposition (serve instruments + the
                      process-wide obs registry)
  GET  /metrics.json  the JSON snapshot + per-model bucket stats
  GET  /models        registry listing (fingerprint, version, shape, objective)
  POST /models        {"name": ..., "path": ...} — load or atomically hot-swap
  POST /predict       {"rows": [[...]], "model"?, "raw_score"?, "pred_leaf"?,
                       "fused"?, "deadline_ms"?} -> {"predictions": ...};
                       503 + Retry-After when shed, 504 past the deadline

Resilience: per-request deadlines (default ``default_deadline_s``,
overridable per request), queue-depth admission control that sheds with 503
before enqueueing work, a dispatch retried once on a device failure, and a
graceful drain (``ServeApp.drain``) the SIGTERM handler in
serve/__main__.py drives. A second failure is a 500, counted as
``serve_dispatch_failures``: the JAX package's CPU re-dispatch after it is
not ported (a fallback that would hide the device).

The drift monitor (lightgbm_tpu/serve/drift.py: ``drift=``,
``LIGHTGBM_TPU_DRIFT=1``, ``/drift``) is not ported: each raises
NotImplementedError naming itself (``/drift`` answers 501 with it).

Hot swap is atomic by construction: a swap builds the complete ServedModel
(parse, pack, dispatchers) off the registry lock, then replaces the dict
entry under it; in-flight batches keep serving the object they were keyed
to (the batch key carries the ServedModel instance, not the name), so a
request never sees half a model.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.model_text import model_fingerprint, peek_model_header
from ..obs import registry as obs_registry
from ..obs import retrace as retrace_mod
from ..obs import sanitize as sanitize_mod
from ..obs import trace as trace_mod
from ..resil import backoff, faults
from ..utils import log
from ..utils.log import LightGBMError
from ..utils.vfile import vopen
from . import httpbase
from .batcher import BatcherClosed, MicroBatcher
from .cache import DEFAULT_MAX_ROWS, BucketedDispatcher, next_bucket
from .metrics import ServeMetrics
from .packed import PackedEnsemble

#: default per-request deadline; every request may override it with a
#: ``deadline_ms`` body field (the old single global PREDICT_TIMEOUT_S)
DEFAULT_DEADLINE_S = 120.0
#: default queued-request cap for admission control (0 disables shedding)
DEFAULT_MAX_QUEUE_DEPTH = 1024
#: Retry-After seconds a shed response advertises
SHED_RETRY_AFTER_S = 1
#: the env switch of the JAX package's drift monitor (not ported)
ENV_DRIFT = "LIGHTGBM_TPU_DRIFT"
#: the lineage sidecar the continuous-training loop writes beside a model
LINEAGE_SUFFIX = ".lineage.json"


def drift_not_ported(name: str) -> NotImplementedError:
    """The refusal of one of the drift monitor's options (``name``)."""
    return NotImplementedError(
        "%s: the feature-drift monitor (lightgbm_tpu/serve/drift.py) is not ported to "
        "lightgbm_tpu_torch yet" % name
    )


def load_lineage(model_path: str, file_sha: str) -> Optional[Dict]:
    """Read and fingerprint-check the lineage sidecar next to ``model_path``
    (lightgbm_tpu/loop/controller.py ``load_lineage``); None when absent or
    written for different bytes (a stale sidecar must not attribute one
    model's lineage to another)."""
    try:
        with open(model_path + LINEAGE_SUFFIX, encoding="utf-8") as fh:
            body = json.load(fh)
    except OSError:
        return None
    except ValueError:
        log.warning("serve: lineage sidecar for %r is not valid JSON; ignored" % model_path)
        return None
    if body.get("fingerprint") != file_sha:
        log.warning("serve: lineage sidecar for %r was written for different model bytes "
                    "(fingerprint mismatch); ignored" % model_path)
        return None
    return body


def _check_deadline(deadline: float) -> float:
    """A usable deadline is finite, positive, and within what
    ``Future.result(timeout=...)`` accepts — anything past
    ``threading.TIMEOUT_MAX`` (~292 years) raises OverflowError inside
    threading, turning a malformed deadline into a 500."""
    if not (math.isfinite(deadline)
            and 0 < deadline <= threading.TIMEOUT_MAX):
        raise LightGBMError(
            "deadline must be a positive number of seconds <= %g, got %r"
            % (threading.TIMEOUT_MAX, deadline)
        )
    return deadline


def _on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device of the calling thread (the
    kernels launch through the CUDA runtime's current device); nothing on
    the CPU."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


class ServeOverloaded(Exception):
    """Request rejected BEFORE any work was enqueued (queue saturated, or
    the server is draining); the HTTP layer maps it to 503 + Retry-After.
    ``reason`` is a stable token ("queue_full" / "draining") clients and
    metric labels key off; ``detail`` is the human sentence."""

    def __init__(self, reason: str, detail: str = "",
                 retry_after_s: int = SHED_RETRY_AFTER_S):
        super().__init__(
            "server overloaded: %s" % (detail or reason)
        )
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """The request's deadline elapsed before its result arrived; mapped to
    HTTP 504. The batched work itself is abandoned, not cancelled — a
    same-key neighbor in the batch still gets its answer."""


class ServedModel:
    """One immutable registry entry: packed model + its shape-bucketed
    dispatchers. Replaced wholesale on hot swap, never mutated."""

    def __init__(
        self,
        name: str,
        path: str,
        ensemble: PackedEnsemble,
        file_sha: str,
        version: int,
        min_bucket_rows: int = 16,
        lineage: Optional[Dict[str, object]] = None,
        max_rows: int = DEFAULT_MAX_ROWS,
    ) -> None:
        self.name = name
        self.path = path
        self.ensemble = ensemble
        self.file_sha = file_sha
        self.version = version
        self.loaded_at = time.time()
        # training lineage from the fingerprint-checked .lineage.json
        # sidecar the continuous-training loop publishes next to the model:
        # parent-model fingerprint + manifest digest. None when the model
        # was published by other means.
        self.lineage = lineage
        ens = ensemble
        self.leaves_disp = BucketedDispatcher(ens.leaves_dev, min_rows=min_bucket_rows,
                                              max_rows=max_rows)
        self.fused_disp = BucketedDispatcher(
            lambda X: ens.fused_scores(torch.as_tensor(X, device=ens.device)).cpu().numpy(),
            min_rows=min_bucket_rows, max_rows=max_rows,
        )

    # -- prediction kinds (all return row-LEADING arrays for the batcher) --

    def run(self, kind: str, X: np.ndarray) -> np.ndarray:
        ens = self.ensemble
        X = ens._check_width(X)
        # the kernels launch on the current stream of the serving device,
        # in the calling (batcher worker) thread
        with _on_device(ens.device):
            if kind == "fused" or kind == "fused_raw":
                return ens.finalize_fused(
                    self.fused_disp(X.astype(np.float32)),
                    raw_score=(kind == "fused_raw"),
                )
            codes, isnan = ens._host_codes(X)
            leaves = self.leaves_disp(codes, isnan).T.astype(np.int32)  # [N, T]
        if kind == "leaf":
            return leaves
        raw = ens._finalize_raw(leaves)
        if kind == "raw" or ens.objective is None:
            return raw
        return ens.objective.convert_output(raw)

    def warmup(self, max_rows: int) -> List[int]:
        F = self.ensemble.num_features
        with _on_device(self.ensemble.device):
            exact = self.leaves_disp.warmup(
                lambda n: (np.zeros((n, F), np.int32), np.zeros((n, F), bool)),
                max_rows=max_rows,
            )
            self.fused_disp.warmup(
                lambda n: (np.zeros((n, F), np.float32),), max_rows=max_rows
            )
        return exact

    def info(self) -> Dict[str, object]:
        ens = self.ensemble
        lin = self.lineage or {}
        return {
            "name": self.name,
            "path": self.path,
            "version": self.version,
            "fingerprint": ens.fingerprint,
            "file_sha": self.file_sha,
            "num_trees": ens.num_trees,
            "num_features": ens.num_features,
            "num_class": ens.num_class,
            "objective": ens.objective.to_string() if ens.objective else "",
            "average_output": ens.average_output,
            "loaded_at": self.loaded_at,
            # lineage (null without a matching .lineage.json sidecar)
            "parent_fingerprint": lin.get("parent_fingerprint"),
            "manifest_digest": lin.get("manifest_digest"),
            "published_cycle": lin.get("cycle"),
        }


class ModelRegistry:
    """name -> ServedModel with atomic hot swap.

    ``warmup_rows > 0`` makes every load (startup AND hot swap) pre-compile
    the new model's row buckets off-lock before it goes live, then — when
    the retrace watchdog is armed — re-arm with the fresh counts. Without
    this, a hot swap on a hardened server (LIGHTGBM_TPU_RETRACE=fail) would
    fail its first requests on the new model's legitimate first compiles.
    """

    # declared acquisition order (graftlint JX013 + the runtime lock
    # sanitizer, obs/sanitize.py): the load/hot-swap serializer is always
    # taken before the registry-dict lock, never the reverse
    _LOCK_ORDER = ("_load_lock", "_lock")

    def __init__(self, min_bucket_rows: int = 16, warmup_rows: int = 0, device="cuda") -> None:
        self._models: Dict[str, ServedModel] = {}
        self._lock = sanitize_mod.make_lock("serve.registry")
        # serializes whole load/hot-swap builds (rare operator actions):
        # overlapping loads would race on the shared watchdog disarm/arm
        # window below. Separate from _lock so concurrent predicts are
        # never blocked behind a build.
        self._load_lock = sanitize_mod.make_lock("serve.registry.load")
        self.min_bucket_rows = min_bucket_rows
        self.warmup_rows = warmup_rows
        # with a warm-up, a batch past the warmed ladder (the batcher may
        # coalesce up to max_batch_rows + one request) is split into chunks
        # of the top warmed bucket, so no dispatch meets an unwarmed shape
        self.max_rows = (next_bucket(warmup_rows, next_bucket(max(min_bucket_rows, 1), 1))
                         if warmup_rows > 0 else DEFAULT_MAX_ROWS)
        self.device = torch.device(device)

    def load(self, name: str, path: str) -> ServedModel:
        """Load (or atomically replace) ``name`` from a model-text file. The
        whole build happens off the registry lock; a failed load leaves the
        old model serving."""
        from ..basic import Booster

        with self._load_lock:
            with vopen(path) as fh:
                text = fh.read()
            peek_model_header(text)  # cheap validation before the full parse
            booster = Booster(model_str=text, device=self.device)
            ensemble = booster.to_packed()
            file_sha = model_fingerprint(text)
            lineage = load_lineage(path, file_sha)
            # the whole build — parse, pack, dispatchers — happens off the
            # registry lock; only the version stamp + dict swap hold it, so
            # concurrent predicts never block behind a hot swap
            served = ServedModel(name, path, ensemble, file_sha, 0, self.min_bucket_rows,
                                 lineage=lineage, max_rows=self.max_rows)
            # the incoming model's warmup shapes are legitimate: they must
            # not trip an armed watchdog (LIGHTGBM_TPU_RETRACE=fail would
            # fail the swap on its own warmup). Suspend it for the build and
            # re-arm with the fresh counts in a finally.
            was_armed = retrace_mod.WATCHDOG.armed
            if was_armed:
                retrace_mod.disarm()
            try:
                if self.warmup_rows > 0:
                    # warm the new model's buckets before it goes live:
                    # in-flight traffic keeps hitting the old model's
                    # warmed dispatchers meanwhile
                    buckets = served.warmup(self.warmup_rows)
                    log.info("serve: model %r warmed buckets %s" % (name, buckets))
                with self._lock:
                    served.version = (
                        self._models[name].version + 1 if name in self._models else 1
                    )
                    self._models[name] = served
            finally:
                if was_armed:
                    retrace_mod.arm()
        log.info(
            "serve: model %r v%d loaded from %s (%d trees, %d features)"
            % (name, served.version, path, ensemble.num_trees, ensemble.num_features)
        )
        return served

    def get(self, name: Optional[str]) -> ServedModel:
        with self._lock:
            if name is None:
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                raise LightGBMError(
                    "Request must name a model (server has %d loaded)"
                    % len(self._models)
                )
            if name not in self._models:
                raise LightGBMError("Unknown model: %s" % name)
            return self._models[name]

    def list(self) -> List[Dict[str, object]]:
        with self._lock:
            models = list(self._models.values())
        return [m.info() for m in models]

    def __len__(self) -> int:
        with self._lock:
            return len(self._models)


class ServeApp:
    """Registry + batcher + metrics behind a plain-python predict() — the
    HTTP handler is a thin shell over this (and tests drive it directly)."""

    def __init__(
        self,
        mode: str = "exact",
        batch: bool = True,
        max_batch_rows: int = 4096,
        max_delay_ms: float = 2.0,
        min_bucket_rows: int = 16,
        warmup_rows: int = 0,
        default_deadline_s: float = DEFAULT_DEADLINE_S,
        max_queue_depth: int = DEFAULT_MAX_QUEUE_DEPTH,
        drift: Optional[bool] = None,
        device="cuda",
    ) -> None:
        from ..basic import resolve_device

        if mode not in ("exact", "fused"):
            raise LightGBMError("serve mode must be 'exact' or 'fused'")
        if drift:
            raise drift_not_ported("drift=True (--drift)")
        if drift is None and os.environ.get(ENV_DRIFT, "") not in ("", "0"):
            raise drift_not_ported("%s=1" % ENV_DRIFT)
        self.mode = mode
        # the serving device; raises when cuda is asked for and absent
        self.device = resolve_device(device)
        self.backend = self.device.type
        self.metrics = ServeMetrics()
        self.registry = ModelRegistry(min_bucket_rows, warmup_rows, device=self.device)
        # fail at startup, not per-request: a bad --deadline-s would
        # otherwise surface as a 400 on every single /predict
        self.default_deadline_s = _check_deadline(float(default_deadline_s))
        self.max_queue_depth = int(max_queue_depth)
        self.batcher = (
            MicroBatcher(
                self._dispatch,
                max_batch_rows=max_batch_rows,
                max_delay_ms=max_delay_ms,
                metrics=self.metrics,
            )
            if batch
            else None
        )
        self.started_at = time.time()
        # drain/shed state: _state_lock orders the draining flag against the
        # in-flight count so drain() can never observe a transient zero while
        # a request is between admission and registration
        self._state_lock = sanitize_mod.make_lock("serve.state")
        # marks handler threads whose whole request track_request already
        # counts, so predict()'s own accounting doesn't count them twice
        self._tracked_thread = threading.local()
        self._idle = threading.Condition(self._state_lock)
        self._inflight = 0
        self.draining = False

    def _kind(self, raw_score: bool, pred_leaf: bool, fused: Optional[bool]) -> str:
        if pred_leaf:
            return "leaf"
        use_fused = self.mode == "fused" if fused is None else fused
        if use_fused:
            return "fused_raw" if raw_score else "fused"
        return "raw" if raw_score else "value"

    def _run_model(self, model: ServedModel, kind: str, X: np.ndarray) -> np.ndarray:
        faults.maybe_fire("serve.dispatch")  # named site (resil/faults.py)
        return model.run(kind, X)

    def _dispatch(self, key: Tuple[ServedModel, str], X: np.ndarray) -> np.ndarray:
        """Device dispatch, retried once. Client faults
        (LightGBMError/ValueError/TypeError: bad width, malformed rows)
        propagate untouched — retrying a 400 would only burn device time. A
        second failure raises (a 500), counted as ``serve_dispatch_failures``."""
        model, kind = key
        try:
            return self._run_model(model, kind, X)
        except (LightGBMError, ValueError, TypeError):
            raise
        except Exception as e:
            self.metrics.incr("serve_dispatch_retries")
            log.warning(
                "serve: dispatch failed (%s: %s); retrying once"
                % (type(e).__name__, str(e)[:200])
            )
            time.sleep(next(backoff.delays(2, base_s=0.05)))
            try:
                return self._run_model(model, kind, X)
            except (LightGBMError, ValueError, TypeError):
                raise
            except Exception as e2:
                self.metrics.incr("serve_dispatch_failures")
                log.warning(
                    "serve: dispatch failed twice (%s: %s); failing the batch"
                    % (type(e2).__name__, str(e2)[:200])
                )
                raise

    def _admit(self) -> bool:
        """Admission control, called BEFORE any work is enqueued: a draining
        server and a saturated queue both shed with 503 + Retry-After, so
        overload pushes back at the door instead of growing the queue past
        any deadline's reach. Returns whether THIS call took an in-flight
        slot: inside track_request (the HTTP path) the handler already holds
        one for the whole request, and counting again would double the
        drain report's stranded-request number."""
        with self._state_lock:
            if self.draining:
                self.metrics.registry.counter("serve_shed").inc(
                    reason="draining"
                )
                raise ServeOverloaded("draining")
            if (
                self.batcher is not None
                and self.max_queue_depth > 0
                and self.batcher.queue_depth() >= self.max_queue_depth
            ):
                self.metrics.registry.counter("serve_shed").inc(
                    reason="queue_full"
                )
                raise ServeOverloaded(
                    "queue_full",
                    "queue depth %d at limit %d"
                    % (self.batcher.queue_depth(), self.max_queue_depth),
                )
            if getattr(self._tracked_thread, "active", False):
                return False
            self._inflight += 1
            return True

    def predict(
        self,
        X: np.ndarray,
        model: Optional[str] = None,
        raw_score: bool = False,
        pred_leaf: bool = False,
        fused: Optional[bool] = None,
        deadline_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, ServedModel]:
        served = self.registry.get(model)
        kind = self._kind(raw_score, pred_leaf, fused)
        key = (served, kind)
        deadline = self.default_deadline_s if deadline_s is None else float(deadline_s)
        if deadline_s is not None:
            # JSON happily carries 1e309 (parsed as inf), negatives, or huge
            # finite values past threading.TIMEOUT_MAX; fut.result() raises
            # OverflowError deep in threading on any of them — reject bad
            # deadlines as the client fault they are (HTTP 400)
            _check_deadline(deadline)
        counted = self._admit()
        t0 = time.perf_counter()  # interval clock: immune to NTP steps
        try:
            # the request-lifecycle root span: queue wait + batch gather +
            # dispatch + reply all nest inside (or alongside, for the worker
            # thread's events) this one — obs/trace.py
            with trace_mod.span(
                "serve.request", cat="serve", model=served.name, kind=kind,
                rows=int(X.shape[0]),
            ):
                if self.batcher is not None:
                    fut = self.batcher.submit(key, X)
                else:
                    # no-batch mode still honors the deadline: run the direct
                    # dispatch on its own thread so result(timeout=) can 504
                    # a hung device call instead of blocking forever (the
                    # dispatch is abandoned, not cancelled — same contract
                    # as the batcher path)
                    fut = Future()

                    def _direct(f=fut, k=key, rows=X):
                        try:
                            f.set_result(self._dispatch(k, rows))
                        except BaseException as e:
                            f.set_exception(e)

                    threading.Thread(
                        target=_direct, name="lgbtpu-serve-direct",
                        daemon=True,
                    ).start()
                try:
                    out = fut.result(timeout=deadline)
                except FuturesTimeout:
                    self.metrics.incr("serve_deadline_exceeded")
                    raise DeadlineExceeded(
                        "request exceeded its %.3fs deadline" % deadline
                    )
        finally:
            if counted:
                with self._state_lock:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()
        # request accounting lives HERE, not in the HTTP handler, so direct
        # drivers (tests, obs smoke, embedding hosts) meter identically
        m = self.metrics
        m.qps.record()
        m.incr("requests")
        m.incr("rows", int(X.shape[0]))
        m.request_latency.record(time.perf_counter() - t0)
        return out, served

    def drift_snapshot(self) -> Dict[str, object]:
        """The JAX package's /drift body; the drift monitor is not ported."""
        raise drift_not_ported("/drift")

    def dispatcher_stats(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for info in self.registry.list():
            name = str(info["name"])
            served = self.registry.get(name)
            out[name] = {
                "exact": served.leaves_disp.stats(),
                "fused": served.fused_disp.stats(),
            }
        return out

    def arm_retrace_watchdog(self) -> None:
        """Snapshot the trace counts as the warm baseline: any new shape of
        a packed entry after this is a retrace (warned once;
        LIGHTGBM_TPU_RETRACE=fail raises). Called by ``python -m
        lightgbm_tpu_torch.serve`` once startup warmup has dispatched every
        bucket (obs/retrace.py)."""
        retrace_mod.arm()

    def prometheus_metrics(self) -> str:
        """Prometheus text: this app's serving instruments + the process-wide
        obs registry (traces, fired faults, the training code's counters).
        Per-model bucket stats ride as labeled gauges so steady-state
        retraces are scrapeable per model."""
        g_buckets = self.metrics.registry.gauge("model_buckets")
        g_retrace = self.metrics.registry.gauge("model_bucket_retraces")
        for name, stats in self.dispatcher_stats().items():
            for kind in ("exact", "fused"):
                g_buckets.set(
                    len(stats[kind]["buckets"]), model=name, kind=kind
                )
                g_retrace.set(
                    stats[kind]["retraces"], model=name, kind=kind
                )
        return (
            self.metrics.prometheus_text()
            + obs_registry.REGISTRY.prometheus_text()
        )

    @contextlib.contextmanager
    def track_request(self):
        """Hold the in-flight count across an ENTIRE request, response write
        included. The HTTP handler wraps do_POST in this: predict()'s own
        accounting releases when the result is computed, but the drain must
        also wait out the handler thread's JSON serialization + socket write
        (daemon threads die at process exit — an un-tracked write window
        would let exit cut off the last responses)."""
        self._tracked_thread.active = True
        with self._state_lock:
            self._inflight += 1
        try:
            yield
        finally:
            self._tracked_thread.active = False
            with self._state_lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: stop admitting, wait for in-flight requests,
        flush the batcher. Returns True when every in-flight request
        completed within ``timeout_s`` (the SIGTERM handler in
        serve/__main__.py exits 0 either way — a drain timeout is logged and
        pending futures are force-failed by the batcher close).
        """
        with trace_mod.span("serve.drain", cat="serve"):
            deadline = time.perf_counter() + timeout_s
            with self._idle:
                self.draining = True
                while self._inflight > 0:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._idle.wait(remaining)
                stranded = self._inflight  # read under the lock: the count
                clean = stranded == 0      # the warning reports must be the
                                           # one the timeout decision saw
            if not clean:
                log.warning(
                    "serve: drain timed out after %.1fs with %d request(s) "
                    "in flight" % (timeout_s, stranded)
                )
            self.close()
        self.metrics.registry.counter("serve_drains").inc()
        return clean

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()


class _Handler(httpbase.JsonHandler):
    server_version = "lightgbm-tpu-torch-serve/1.0"
    log_prefix = "serve"

    @property
    def app(self) -> ServeApp:
        return self.server.app  # type: ignore[attr-defined]

    def _retryable_503(self, error: str, reason: str, retry_after_s: int) -> None:
        raw = json.dumps({"error": error, "reason": reason}).encode("utf-8")
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", str(retry_after_s))
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _body(self) -> Dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            return {}
        raw = self.rfile.read(length)
        obj = json.loads(raw.decode("utf-8"))
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    # -- routes ------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        app = self.app
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._json(
                200,
                {
                    "status": "draining" if app.draining else "ok",
                    "backend": app.backend,
                    "mode": app.mode,
                    "batching": app.batcher is not None,
                    "ready": len(app.registry) > 0 and not app.draining,
                    "models": [str(i["name"]) for i in app.registry.list()],
                    "uptime_s": round(time.time() - app.started_at, 1),
                },
            )
        elif path == "/metrics":
            # Prometheus text exposition; the JSON snapshot is /metrics.json
            self._text(
                200, app.prometheus_metrics(), httpbase.PROM_CONTENT_TYPE,
            )
        elif path == "/metrics.json":
            self._json(200, app.metrics.snapshot(app.dispatcher_stats()))
        elif path == "/drift":
            # the drift monitor is not ported: 501 naming the endpoint
            try:
                app.drift_snapshot()
            except NotImplementedError as e:
                self._json(501, {"error": str(e)})
        elif path == "/models":
            self._json(200, {"models": app.registry.list()})
        else:
            self._json(404, {"error": "unknown path %s" % path})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        # the whole request — response write included — counts as in-flight,
        # so a SIGTERM drain waits for the bytes to reach the socket
        with self.app.track_request():
            self._do_POST()

    def _do_POST(self) -> None:
        app = self.app
        path = self.path.split("?", 1)[0]
        try:
            body = self._body()
            if path == "/predict":
                rows = body.get("rows")
                if not rows:
                    self._json(400, {"error": "missing 'rows'"})
                    return
                X = np.asarray(rows, np.float64)
                if X.ndim == 1:
                    X = X[None, :]
                deadline_ms = body.get("deadline_ms")
                out, served = app.predict(
                    X,
                    model=body.get("model"),
                    raw_score=bool(body.get("raw_score", False)),
                    pred_leaf=bool(body.get("pred_leaf", False)),
                    fused=body.get("fused"),
                    deadline_s=(
                        float(deadline_ms) / 1e3
                        if deadline_ms is not None
                        else None
                    ),
                )
                # request counters + latency are recorded by app.predict
                lin = served.lineage or {}
                self._json(
                    200,
                    {
                        "model": served.name,
                        "version": served.version,
                        "fingerprint": served.ensemble.fingerprint,
                        # lineage: which model this one grew from + which
                        # training run produced it (null without the loop's
                        # .lineage.json sidecar)
                        "parent_fingerprint": lin.get("parent_fingerprint"),
                        "manifest_digest": lin.get("manifest_digest"),
                        "n": int(X.shape[0]),
                        "predictions": np.asarray(out).tolist(),
                    },
                )
            elif path == "/models":
                name = body.get("name")
                mpath = body.get("path")
                if not name or not mpath:
                    self._json(400, {"error": "need 'name' and 'path'"})
                    return
                served = app.registry.load(str(name), str(mpath))
                app.metrics.incr("model_loads")
                self._json(200, {"loaded": served.info()})
            else:
                self._json(404, {"error": "unknown path %s" % path})
        except ServeOverloaded as e:
            # shed BEFORE enqueueing work: 503 + Retry-After is the
            # backpressure contract clients key their retry loops off
            # (counted as serve_shed_total in app.predict's admission)
            self._retryable_503(str(e), e.reason, e.retry_after_s)
        except BatcherClosed as e:
            # server-side shutdown abandonment (wedged-worker force-fail or
            # a submit racing the close): retryable, so 503 — a 400 would
            # tell fail-over-capable clients to drop the request for good
            app.metrics.incr("errors")
            self._retryable_503(str(e), "shutting_down", SHED_RETRY_AFTER_S)
        except DeadlineExceeded as e:
            app.metrics.incr("errors")
            self._json(504, {"error": str(e)})
        except (LightGBMError, ValueError, TypeError, OSError) as e:
            # TypeError covers np.asarray on malformed rows (e.g. JSON null
            # in a row) — a client fault, not a server one
            app.metrics.incr("errors")
            self._json(400, {"error": str(e)})
        except Exception as e:  # keep the server up; surface the cause
            app.metrics.incr("errors")
            log.warning("serve: internal error: %r" % (e,))
            self._json(500, {"error": "%s: %s" % (type(e).__name__, e)})


class ServeHTTPServer(httpbase.DaemonHTTPServer):
    def __init__(self, addr, app: ServeApp) -> None:
        super().__init__(addr, _Handler)
        self.app = app


def make_server(
    host: str = "127.0.0.1", port: int = 8080, app: Optional[ServeApp] = None,
    **app_kwargs,
) -> ServeHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free port
    (``server.server_address[1]`` tells which)."""
    return ServeHTTPServer((host, port), app or ServeApp(**app_kwargs))
