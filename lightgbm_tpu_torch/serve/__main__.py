"""``python -m lightgbm_tpu_torch.serve`` — run the inference server.

    python -m lightgbm_tpu_torch.serve model.txt
    python -m lightgbm_tpu_torch.serve main=model.txt --device cuda
    python -m lightgbm_tpu_torch.serve prod=model_a.txt canary=model_b.txt \
        --port 8080 --max-batch-rows 4096 --max-delay-ms 2 --warmup-rows 1024

Each positional argument is ``name=path`` (bare paths get the file stem as
name). The flags are lightgbm_tpu/serve/__main__.py's, plus ``--device``
(default ``cuda``; the server refuses to start when that device is absent).
``--drift`` and ``--drift-threshold`` raise NotImplementedError: the drift
monitor is not ported.

Shutdown: SIGTERM (or SIGINT) triggers a graceful drain — new predicts shed
503 ``reason=draining`` while every in-flight request completes and
``/healthz`` keeps reporting ``{"status": "draining", "ready": false}``,
then the listener closes, the batcher flushes, final metrics are reported
and the tracer (if armed) writes its file — then the process exits 0.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from typing import List, Optional

from ..obs import trace as trace_mod
from ..utils import log
from .server import (
    DEFAULT_DEADLINE_S,
    DEFAULT_MAX_QUEUE_DEPTH,
    ServeApp,
    drift_not_ported,
    make_server,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.serve",
        description="LightGBM inference server on a CUDA card (stdlib HTTP/JSON)",
    )
    p.add_argument("models", nargs="+", metavar="NAME=PATH",
                   help="model-text files to serve (bare PATH uses the stem)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--mode", choices=("exact", "fused"), default="exact",
                   help="exact: bit-identical to Booster.predict; fused: "
                        "all-device f32 fast path")
    p.add_argument("--device", default="cuda",
                   help="the serving device (cuda, cuda:N or cpu); the server "
                        "refuses to start when it is absent")
    p.add_argument("--max-batch-rows", type=int, default=4096)
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--min-bucket-rows", type=int, default=16)
    p.add_argument("--no-batch", action="store_true",
                   help="dispatch each request directly (debugging)")
    p.add_argument("--warmup-rows", type=int, default=0,
                   help="dispatch every row bucket up to this size at startup, "
                        "then arm the retrace watchdog")
    p.add_argument("--deadline-s", type=float, default=DEFAULT_DEADLINE_S,
                   help="default per-request deadline, must be > 0; requests "
                        "may override with a deadline_ms body field (504 on "
                        "expiry)")
    p.add_argument("--max-queue-depth", type=int,
                   default=DEFAULT_MAX_QUEUE_DEPTH,
                   help="queued requests beyond this are shed with 503 + "
                        "Retry-After before any work is enqueued (0 disables)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="max seconds the SIGTERM drain waits for in-flight "
                        "requests before force-failing the remainder")
    p.add_argument("--drift", action="store_true",
                   help="the feature-drift monitor: not ported (raises)")
    p.add_argument("--drift-threshold", type=float, default=None,
                   help="the drift monitor's PSI threshold: not ported (raises)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.drift:
        raise drift_not_ported("--drift")
    if args.drift_threshold is not None:
        raise drift_not_ported("--drift-threshold")
    app = ServeApp(
        mode=args.mode,
        batch=not args.no_batch,
        max_batch_rows=args.max_batch_rows,
        max_delay_ms=args.max_delay_ms,
        min_bucket_rows=args.min_bucket_rows,
        warmup_rows=args.warmup_rows,  # loads (and hot swaps) pre-warm
        default_deadline_s=args.deadline_s,
        max_queue_depth=args.max_queue_depth,
        device=args.device,
    )
    for spec in args.models:
        if "=" in spec:
            name, path = spec.split("=", 1)
        else:
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        app.registry.load(name, path)
    if args.warmup_rows > 0:
        # every bucket is warm: from here on a new shape is a retrace
        # (warned once; LIGHTGBM_TPU_RETRACE=fail hard-fails — obs/retrace.py);
        # hot swaps stay safe: ModelRegistry.load warms the incoming model
        # and re-arms with its counts before it goes live
        app.arm_retrace_watchdog()
    httpd = make_server(args.host, args.port, app)
    host, port = httpd.server_address[:2]

    # SIGTERM/SIGINT -> graceful drain. The drain runs BEFORE the listener
    # stops: new predicts shed 503 reason=draining while /healthz keeps
    # answering {"status": "draining", "ready": false} — so load balancers
    # de-pool the instance instead of seeing hard connection failures. Both
    # run OFF the signal frame (shutdown() blocks until serve_forever's
    # loop — the main thread here — exits).
    drain_box: dict = {}
    drain_started = threading.Event()

    def _drain_then_stop():
        # shutdown() in a finally: if the drain itself raises, the listener
        # must STILL stop — serve_forever would otherwise spin on with
        # drain_started already set, making every later SIGTERM a no-op and
        # leaving the pod to hang until the orchestrator's SIGKILL
        try:
            drain_box["drained"] = app.drain(timeout_s=args.drain_timeout_s)
        except BaseException as e:
            drain_box["error"] = e
            raise
        finally:
            httpd.shutdown()

    def _graceful(signum, frame):
        # idempotent: a repeated SIGTERM (orchestrator retry) must not spawn
        # a second concurrent drain (double-counted serve_drains, drained
        # flag overwritten mid-flush)
        if drain_started.is_set():
            return
        drain_started.set()
        log.info("serve: signal %d received; draining" % signum)
        # once a drain starts, restore the default SIGINT handler: a SECOND
        # Ctrl-C must be able to break out of a wedged drain (it raises
        # KeyboardInterrupt in the main thread) instead of re-running this
        # handler as a no-op
        signal.signal(signal.SIGINT, signal.default_int_handler)
        threading.Thread(
            target=_drain_then_stop, name="lgbtpu-serve-shutdown", daemon=True
        ).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    print(
        json.dumps(
            {
                "serving": True,
                "host": host,
                "port": port,
                "backend": app.backend,
                "device": str(app.device),
                "mode": app.mode,
                "models": [str(i["name"]) for i in app.registry.list()],
            }
        ),
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass  # second Ctrl-C landed before the drain began; still drain below
    finally:
        httpd.server_close()  # no new accepts from here on
        if "drained" in drain_box:
            drained = drain_box["drained"]  # signal-path drain completed
        elif "error" in drain_box:
            # the drain thread itself died — report the real cause, not a
            # phantom second Ctrl-C the operator never pressed
            log.warning("serve: drain failed: %r" % (drain_box["error"],))
            drained = False
        elif drain_started.is_set():
            # signal-path drain still in progress but serve_forever exited
            # anyway — the operator broke out with a second Ctrl-C. Gate on
            # the handler-local event, NOT app.draining: a second Ctrl-C can
            # land before the drain thread has set app.draining, and falling
            # into the else branch would start a second concurrent drain
            # (double-counted serve_drains, racing final report)
            log.warning("serve: drain aborted by operator (second Ctrl-C)")
            drained = False
        else:
            # serve_forever exited without a signal (error path): drain now
            try:
                drained = app.drain(timeout_s=args.drain_timeout_s)
            except KeyboardInterrupt:
                log.warning("serve: drain aborted by operator (second Ctrl-C)")
                drained = False
        trace_path = trace_mod.stop()  # final trace flush (None when unarmed)
        # the final-metrics line: orchestrator logs get the close-out state
        # even when no scraper caught the last /metrics
        print(
            json.dumps(
                {
                    "serving": False,
                    "drained": bool(drained),
                    "counters": app.metrics.counters(),
                    "trace": trace_path,
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
