"""Micro-batcher: coalesce concurrent requests into one device dispatch.

The port's copy of lightgbm_tpu/serve/batcher.py. A dispatch to the card
has a fixed host and launch cost that dwarfs the marginal cost of extra
rows; serving one 8-row request a dispatch wastes almost the whole launch.
The batcher runs one worker thread draining a queue: it opens a batch with
the first waiting request, then keeps accepting compatible requests until
``max_batch_rows`` rows are gathered or the oldest request has waited
``max_delay_ms`` — then concatenates rows, dispatches once, and fans the
results back out through per-request futures. The one worker also
serializes the card's use: its kernels run on the default stream of the
serving device in that thread (serve/server.py enters the device).

Requests are grouped by an opaque ``key`` (model entry + output kind,
serve/server.py); a key change flushes the open batch so results can never
mix models. Occupancy (batch rows / max_batch_rows) is recorded per
dispatch.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional

import numpy as np

from ..obs import sanitize as sanitize_mod
from ..obs import trace as trace_mod
from ..resil import faults
from ..utils import log
from ..utils.log import LightGBMError
from .metrics import ServeMetrics


class _Request:
    __slots__ = ("key", "rows", "future", "t_enqueue", "t_trace_us")

    def __init__(self, key, rows: np.ndarray) -> None:
        self.key = key
        self.rows = rows
        self.future: Future = Future()
        # perf_counter: enqueue stamps only ever feed DELTAS (delay-window
        # deadlines), and wall-clock deltas break under NTP steps
        self.t_enqueue = time.perf_counter()
        # trace-clock enqueue stamp, so the worker can emit the request's
        # queue-wait span with its true start (obs/trace.py complete_at)
        self.t_trace_us = trace_mod.now_us() if trace_mod.enabled() else None


_CLOSE = object()


def _try_resolve(fut: Future, value=None, exc: Optional[BaseException] = None) -> bool:
    """Resolve ``fut`` unless it already is; returns whether this call won.
    A wedged worker's gathered requests can be force-failed by close() and
    THEN resolved by the worker if it un-wedges — the loser of that race
    must be a no-op, not an InvalidStateError that kills the worker loop."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
        return True
    except InvalidStateError:
        return False


class BatcherClosed(LightGBMError):
    """Shutdown-side abandonment: raised to submitters when the batcher is
    closed (or a wedged worker's pending requests are force-failed). A
    retryable SERVER condition, not a client fault — the HTTP layer maps it
    to 503 + Retry-After so clients fail over to another replica instead of
    dropping the request as a 400."""


class MicroBatcher:
    """Queue + worker thread. ``dispatch(key, X)`` does the actual predict."""

    def __init__(
        self,
        dispatch: Callable[[object, np.ndarray], np.ndarray],
        max_batch_rows: int = 4096,
        max_delay_ms: float = 2.0,
        metrics: Optional[ServeMetrics] = None,
    ) -> None:
        self.dispatch = dispatch
        self.max_batch_rows = max_batch_rows
        self.max_delay_s = max_delay_ms / 1e3
        self.metrics = metrics or ServeMetrics()
        self._q: "queue.Queue" = queue.Queue()
        self.metrics.queue_depth_fn = self._q.qsize
        self._closed = False
        # the batch the worker has gathered but not yet fanned out — held on
        # self so close()'s force-fail can reach requests a wedged dispatch
        # is sitting on, not just the ones still in the queue (GIL-atomic
        # list rebind; only the worker writes it)
        self._inflight_batch: List[_Request] = []
        # orders submits against close(): without it a submitter could pass
        # the _closed check, be descheduled, and enqueue AFTER close() put
        # the sentinel and drained — leaving a future nothing ever resolves
        self._submit_lock = sanitize_mod.make_lock("serve.batcher.submit")
        self._worker = threading.Thread(
            target=self._loop, name="lgbtpu-torch-serve-batcher", daemon=True
        )
        self._worker.start()

    # -- producer side ----------------------------------------------------

    def queue_depth(self) -> int:
        """Requests currently waiting (the admission-control signal)."""
        return self._q.qsize()

    def submit(self, key, rows: np.ndarray) -> Future:
        """Enqueue one request; resolve the returned Future with its slice of
        the batched result (row-leading), or the dispatch exception."""
        with self._submit_lock:
            if self._closed:
                raise BatcherClosed("batcher is closed (server shutting down)")
            req = _Request(key, rows)
            self._q.put(req)
        return req.future

    def close(self, timeout: float = 5.0) -> None:
        """Flush-and-stop: everything queued BEFORE close drains in FIFO
        order, then the worker exits. The submit lock guarantees the _CLOSE
        sentinel is the queue's LAST entry, so a clean exit leaves nothing
        unresolved. If the worker is wedged (hung device call) and misses
        the join window, pending requests are force-FAILED so their
        submitters' ``future.result()`` calls return instead of hanging
        until their full deadlines — a wedged worker must never silently
        leak in-flight futures."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_CLOSE)
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            failed = self._fail_pending(
                "batcher worker wedged at shutdown; request abandoned"
            )
            log.warning(
                "serve: batcher worker did not exit within %.1fs; "
                "force-failed %d pending request(s)" % (timeout, failed)
            )
            self.metrics.incr("batcher_wedged")

    def _fail_pending(self, reason: str) -> int:
        failed = 0
        saw_close = False
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is _CLOSE:
                saw_close = True
                continue
            req.future.set_exception(BatcherClosed(reason))
            failed += 1
        # the wedged worker's GATHERED batch too: those requests left the
        # queue but never fanned out, and their submitters would otherwise
        # block in future.result() until their full deadlines
        for req in self._inflight_batch:
            if _try_resolve(req.future, exc=BatcherClosed(reason)):
                failed += 1
        if saw_close:
            # re-queue the exit sentinel (AFTER the drain, or get_nowait
            # would pull it right back): a worker that un-wedges later must
            # still find it and exit, or every wedge permanently leaks the
            # thread plus whatever its frames capture
            self._q.put(_CLOSE)
        return failed

    # -- worker side ------------------------------------------------------

    def _loop(self) -> None:
        while True:
            req = self._q.get()
            if req is _CLOSE:
                return
            if self._gather_and_dispatch(req) is _CLOSE:
                return

    def _gather_and_dispatch(self, first: _Request):
        """Collect compatible requests behind ``first``, dispatch, fan out.
        Returns _CLOSE if the shutdown sentinel was swallowed mid-gather."""
        while True:
            batch: List[_Request] = [first]
            rows = first.rows.shape[0]
            deadline = first.t_enqueue + self.max_delay_s  # perf_counter base
            closing = None
            carry = None
            while rows < self.max_batch_rows:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    closing = _CLOSE
                    break
                if nxt.key != first.key:
                    # incompatible request: flush what we have, then open a
                    # new batch for it (strict FIFO across keys keeps tail
                    # latency bounded under interleaved-model traffic)
                    carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.rows.shape[0]
            # the carried next-batch opener rides along in _inflight_batch:
            # it lives only in this frame's locals, so a dispatch that wedges
            # here must let close() force-fail it WITH the gathered batch —
            # and it stays covered through the next gather until it lands in
            # a batch of its own
            self._inflight_batch = batch if carry is None else batch + [carry]  # unlocked: single-writer GIL-atomic rebind (only the worker writes; close() only reads)
            try:
                self._dispatch(batch, rows)
            finally:
                self._inflight_batch = [] if carry is None else [carry]  # unlocked: single-writer GIL-atomic rebind (only the worker writes; close() only reads)
            if carry is None:
                return closing
            first = carry

    def _dispatch(self, batch: List[_Request], rows: int) -> None:
        if trace_mod.enabled():
            # queue-wait spans: enqueue -> the moment the batch dispatches
            t_now = trace_mod.now_us()
            for r in batch:
                if r.t_trace_us is not None:
                    trace_mod.complete_at(
                        "serve.queue_wait", "serve", r.t_trace_us, t_now,
                        rows=int(r.rows.shape[0]),
                    )
        t0 = time.perf_counter()
        try:
            # named fault site (resil/faults.py): a `hang` here is the
            # wedged device call close()'s force-fail path exists for; a
            # `raise` exercises the fan-out-and-survive path below
            faults.maybe_fire("serve.batcher")
            # the concat is INSIDE the try: two same-key requests with
            # mismatched widths must fail their own futures, not kill the
            # (only) worker thread and hang every request after them
            X = (
                batch[0].rows
                if len(batch) == 1
                else np.concatenate([r.rows for r in batch], axis=0)
            )
            with trace_mod.span(
                "serve.batch_dispatch", cat="serve", rows=int(rows),
                requests=len(batch),
            ):
                out = self.dispatch(batch[0].key, X)
        except BaseException as e:  # fan the failure out, keep the worker up
            for r in batch:
                _try_resolve(r.future, exc=e)
            self.metrics.incr("batch_errors")
            return
        dt = time.perf_counter() - t0
        m = self.metrics
        m.dispatch_latency.record(dt)
        m.batch_occupancy.record(min(rows / self.max_batch_rows, 1.0))
        m.incr("batches")
        m.incr("batched_requests", len(batch))
        m.rows_per_sec.record(rows)
        off = 0
        for r in batch:
            n = r.rows.shape[0]
            _try_resolve(r.future, out[off : off + n])
            off += n
