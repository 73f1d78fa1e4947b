"""The port's HTTP serving stack on the CPU, against the JAX package
(tests/test_serve_server.py case for case, and the HTTP cases of
tests/test_serve_resil.py).

The real ThreadingHTTPServer runs on an ephemeral port with
``device="cpu"``; rows go over JSON, whose float repr round-trips f64, so
the exact path is held bit for bit to the port's ``Booster.predict`` and to
the JAX package's ``Booster.predict`` on the same model text. Every HTTP
call has a timeout, every server and batcher is shut down in ``finally``,
and every thread is a daemon.
"""
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models.model_text import model_fingerprint
from lightgbm_tpu_torch.obs import retrace
from lightgbm_tpu_torch.resil import faults
from lightgbm_tpu_torch.resil.faults import ENV_FAULTS
from lightgbm_tpu_torch.serve import __main__ as serve_main
from lightgbm_tpu_torch.serve.server import (
    DeadlineExceeded, ServeApp, ServeOverloaded, make_server,
)
from lightgbm_tpu_torch.utils.log import LightGBMError


def _train(params, X, y, rounds):
    return tlgb.train({"verbosity": -1, **params}, tlgb.Dataset(X, label=y), rounds, device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(ENV_FAULTS, raising=False)
    faults.reset()
    yield
    faults.reset()


def _serve(app):
    srv = make_server("127.0.0.1", 0, app)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _stop(srv, app):
    srv.shutdown()
    srv.server_close()
    app.close()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(server, port, app, boosters by name, extras) running for the module."""
    rng = np.random.RandomState(11)
    X = rng.randn(800, 5)
    X[rng.rand(800, 5) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) > 0).astype(float)
    y3 = rng.randint(0, 3, 800).astype(float)
    tmp = tmp_path_factory.mktemp("serve")
    bin_bst = _train({"objective": "binary", "num_leaves": 15}, X, y, 4)
    mc_bst = _train({"objective": "multiclass", "num_class": 3, "num_leaves": 7}, X, y3, 3)
    bin_path, mc_path = str(tmp / "bin.txt"), str(tmp / "mc.txt")
    bin_bst.save_model(bin_path)
    mc_bst.save_model(mc_path)
    app = ServeApp(max_delay_ms=1.0, min_bucket_rows=8, device="cpu")
    srv = None
    try:
        app.registry.load("bin", bin_path)
        app.registry.load("mc", mc_path)
        srv, port = _serve(app)
        Xt = rng.randn(9, 5)
        Xt[0, 2] = np.nan
        jax_boosters = {"bin": jlgb.Booster(model_file=bin_path),
                        "mc": jlgb.Booster(model_file=mc_path)}
        yield srv, port, app, {"bin": bin_bst, "mc": mc_bst}, {
            "tmp": tmp, "Xt": Xt, "jax": jax_boosters}
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        app.close()


def _call(port, method, path, body=None, headers=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read().decode("utf-8")
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = raw
        if headers:
            return r.status, dict(r.getheaders()), payload
        return r.status, payload
    finally:
        conn.close()


def test_healthz(served):
    _, port, app, _, _ = served
    status, body = _call(port, "GET", "/healthz")
    assert status == 200
    assert body["status"] == "ok" and body["ready"]
    assert set(body["models"]) == {"bin", "mc"}
    assert body["backend"] == app.backend == "cpu"
    assert set(body) == {"status", "backend", "mode", "batching", "ready", "models", "uptime_s"}


@pytest.mark.parametrize("model,kw", [
    ("bin", {}), ("bin", {"raw_score": True}), ("bin", {"pred_leaf": True}),
    ("mc", {}), ("mc", {"raw_score": True}), ("mc", {"pred_leaf": True}),
])
def test_predict_round_trip_bit_exact(served, model, kw):
    """JSON float repr round-trips f64: the HTTP answer is predict()'s, the
    port's and the JAX package's."""
    _, port, app, boosters, extra = served
    Xt = extra["Xt"]
    status, body = _call(port, "POST", "/predict", {"rows": Xt.tolist(), "model": model, **kw})
    assert status == 200
    assert body["n"] == Xt.shape[0]
    assert body["version"] == app.registry.get(model).version
    got = np.asarray(body["predictions"])
    assert np.array_equal(boosters[model].predict(Xt, **kw), got)
    assert np.array_equal(extra["jax"][model].predict(Xt, **kw), got)
    assert set(body) == {"model", "version", "fingerprint", "parent_fingerprint",
                         "manifest_digest", "n", "predictions"}


def test_predict_single_row(served):
    _, port, _, boosters, extra = served
    status, body = _call(port, "POST", "/predict", {"rows": extra["Xt"][0].tolist(),
                                                    "model": "bin"})
    assert status == 200 and body["n"] == 1  # a bare vector is one row
    assert np.array_equal(boosters["bin"].predict(extra["Xt"][:1]), np.asarray(body["predictions"]))


@pytest.mark.parametrize("model", ["bin", "mc"])
def test_predict_fused_close(served, model):
    _, port, app, boosters, extra = served
    Xt = extra["Xt"]
    _, body = _call(port, "POST", "/predict", {"rows": Xt.tolist(), "model": model, "fused": True})
    got = np.asarray(body["predictions"])
    assert np.allclose(boosters[model].predict(Xt), got, rtol=1e-4, atol=1e-5)
    # the JAX package's fused path on the same model: within the f32 bound
    _, raw = _call(port, "POST", "/predict", {"rows": Xt.tolist(), "model": model, "fused": True,
                                              "raw_score": True})
    jpk = extra["jax"][model].to_packed()
    want = jpk.predict_fused(Xt, raw_score=True)
    pk = app.registry.get(model).ensemble
    leaves = pk.predict_leaves(Xt)
    K = pk.num_tree_per_iteration
    absum = np.zeros((Xt.shape[0], K))
    for i in range(pk.num_trees):
        absum[:, i % K] += np.abs(pk.leaf_value64[i][leaves[:, i]])
    bound = 2.0 * pk.num_trees * 2.0 ** -24 * absum
    assert np.all(np.abs(np.asarray(raw["predictions"]).reshape(Xt.shape[0], -1)
                         - want.reshape(Xt.shape[0], -1)) <= bound)


def test_metrics_and_models_endpoints(served):
    _, port, _, boosters, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type", "").startswith("text/plain")
        text = r.read().decode("utf-8")
    finally:
        conn.close()
    assert "# TYPE lgbtpu_requests_total counter" in text
    assert 'lgbtpu_request_latency_seconds{quantile="0.5"}' in text
    assert "lgbtpu_qps" in text
    assert 'lgbtpu_model_buckets{kind="exact",model="bin"}' in text
    status, m = _call(port, "GET", "/metrics.json")
    assert status == 200
    assert m["counters"].get("requests", 0) >= 1
    assert "request_latency" in m and "buckets" in m
    assert set(m["buckets"]["bin"]) == {"exact", "fused"}
    status, models = _call(port, "GET", "/models")
    by_name = {i["name"]: i for i in models["models"]}
    assert by_name["bin"]["num_trees"] == 4
    assert by_name["mc"]["num_class"] == 3
    assert len(by_name["bin"]["fingerprint"]) == 40
    assert by_name["bin"]["fingerprint"] == boosters["bin"].to_packed().fingerprint
    assert by_name["bin"]["objective"] == boosters["bin"]._gbdt.objective.to_string()
    assert set(by_name["bin"]) == {
        "name", "path", "version", "fingerprint", "file_sha", "num_trees", "num_features",
        "num_class", "objective", "average_output", "loaded_at", "parent_fingerprint",
        "manifest_digest", "published_cycle"}


def test_lineage_surfaced_in_models_and_predict(served):
    _, port, _, boosters, extra = served
    path = str(extra["tmp"] / "lin.txt")
    boosters["bin"].save_model(path)
    with open(path) as fh:
        sha = model_fingerprint(fh.read())
    lineage = {"version": 1, "fingerprint": sha, "parent_fingerprint": "a" * 40,
               "manifest_digest": "b" * 40, "cycle": 3}
    with open(path + ".lineage.json", "w") as fh:
        json.dump(lineage, fh)
    status, body = _call(port, "POST", "/models", {"name": "lin", "path": path})
    assert status == 200
    assert body["loaded"]["parent_fingerprint"] == "a" * 40
    assert body["loaded"]["manifest_digest"] == "b" * 40
    assert body["loaded"]["published_cycle"] == 3
    status, models = _call(port, "GET", "/models")
    assert {i["name"]: i for i in models["models"]}["lin"]["parent_fingerprint"] == "a" * 40
    status, body = _call(port, "POST", "/predict", {"rows": extra["Xt"].tolist(), "model": "lin"})
    assert status == 200
    assert body["parent_fingerprint"] == "a" * 40 and body["manifest_digest"] == "b" * 40
    status, body = _call(port, "POST", "/predict", {"rows": extra["Xt"].tolist(), "model": "bin"})
    assert body["parent_fingerprint"] is None and body["manifest_digest"] is None
    lineage["fingerprint"] = "f" * 40  # foreign lineage must not be attributed
    with open(path + ".lineage.json", "w") as fh:
        json.dump(lineage, fh)
    status, body = _call(port, "POST", "/models", {"name": "lin", "path": path})
    assert status == 200 and body["loaded"]["parent_fingerprint"] is None


def test_hot_swap_atomic(served):
    _, port, app, boosters, extra = served
    Xt = extra["Xt"]
    rng = np.random.RandomState(5)
    X = rng.randn(400, 5)
    y = (X[:, 1] > 0).astype(float)
    swapped = _train({"objective": "binary", "num_leaves": 7}, X, y, 6)
    path = str(extra["tmp"] / "swap.txt")
    swapped.save_model(path)
    v0 = app.registry.get("bin").version
    old = app.registry.get("bin")
    status, body = _call(port, "POST", "/models", {"name": "bin", "path": path})
    assert status == 200
    assert body["loaded"]["version"] == v0 + 1 and body["loaded"]["num_trees"] == 6
    _, body = _call(port, "POST", "/predict", {"rows": Xt.tolist(), "model": "bin"})
    assert body["version"] == v0 + 1
    assert np.array_equal(swapped.predict(Xt), np.asarray(body["predictions"]))
    # the replaced entry is untouched: whoever holds it still serves the old model
    assert np.array_equal(old.run("value", Xt), boosters["bin"].predict(Xt))
    orig = str(extra["tmp"] / "bin.txt")
    boosters["bin"].save_model(orig)
    _call(port, "POST", "/models", {"name": "bin", "path": orig})


def test_hot_swap_under_load(served):
    """Concurrent clients see either model whole, never a mixture."""
    _, port, app, boosters, extra = served
    Xt = extra["Xt"]
    rng = np.random.RandomState(6)
    X = rng.randn(400, 5)
    other = _train({"objective": "binary", "num_leaves": 7}, X, (X[:, 2] > 0) * 1.0, 3)
    other_path = str(extra["tmp"] / "other.txt")
    other.save_model(other_path)
    answers = {boosters["bin"].predict(Xt).tobytes(), other.predict(Xt).tobytes()}
    bad, done = [], []

    def client():
        for _ in range(15):
            status, body = _call(port, "POST", "/predict", {"rows": Xt.tolist(), "model": "bin"})
            if status != 200 or np.asarray(body["predictions"]).tobytes() not in answers:
                bad.append((status, body))
        done.append(1)

    threads = [threading.Thread(target=client, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        _call(port, "POST", "/models", {"name": "bin", "path": other_path})
    finally:
        for t in threads:
            t.join(timeout=60)
        _call(port, "POST", "/models", {"name": "bin", "path": str(extra["tmp"] / "bin.txt")})
    assert len(done) == 4 and not bad


def test_error_surfaces(served):
    _, port, _, _, extra = served
    Xt = extra["Xt"]
    status, body = _call(port, "POST", "/predict", {"rows": Xt.tolist(), "model": "nope"})
    assert status == 400 and "Unknown model" in body["error"]
    status, body = _call(port, "POST", "/predict", {"model": "bin"})
    assert status == 400 and "rows" in body["error"]
    status, body = _call(port, "POST", "/predict", {"rows": [[1.0, 2.0]], "model": "bin"})
    assert status == 400 and "number of features" in body["error"]  # wrong width
    status, body = _call(port, "POST", "/predict", {"rows": [[None, 1, 2, 3, 4]], "model": "bin"})
    assert status == 200  # JSON null = missing value (NaN), like NaN inputs
    status, body = _call(port, "POST", "/predict", {"rows": [["x", 1, 2, 3, 4]], "model": "bin"})
    assert status == 400  # genuinely non-numeric rows are a client fault
    status, body = _call(port, "POST", "/models", {"name": "x"})
    assert status == 400
    status, _ = _call(port, "GET", "/nope")
    assert status == 404
    status, body = _call(port, "GET", "/drift")
    assert status == 501 and "/drift" in body["error"]


def test_unbatched_app_direct(tmp_path):
    rng = np.random.RandomState(3)
    X = rng.randn(300, 4)
    bst = _train({"objective": "binary", "num_leaves": 7}, X, (X[:, 0] > 0).astype(float), 3)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    app = ServeApp(batch=False, device="cpu")
    try:
        app.registry.load("m", path)
        Xt = rng.randn(5, 4)
        out, served_model = app.predict(Xt)
        assert served_model.name == "m"
        assert np.array_equal(bst.predict(Xt), out)
    finally:
        app.close()


# ---------------------------------------------------------------------------
# resilience: retry, failure, deadlines, shedding, drain, warm-up
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    rng = np.random.RandomState(3)
    X = rng.randn(300, 4)
    bst = _train({"objective": "binary", "num_leaves": 7}, X, (X[:, 0] > 0).astype(float), 3)
    p = str(tmp_path_factory.mktemp("serve_resil") / "m.txt")
    bst.save_model(p)
    return p, bst


def _app(model_path, **kw):
    app = ServeApp(max_delay_ms=1.0, min_bucket_rows=8, device="cpu", **kw)
    app.registry.load("m", model_path[0])
    return app


def _rows(n=5):
    return np.random.RandomState(0).randn(n, 4)


def test_dispatch_retry_once_recovers(model_path, monkeypatch):
    monkeypatch.setenv(ENV_FAULTS, "serve.dispatch:1")
    faults.reset()
    app = _app(model_path, batch=False)
    try:
        out, _ = app.predict(_rows())
        assert np.array_equal(out, model_path[1].predict(_rows()))
        reg = app.metrics.registry
        assert reg.counter("serve_dispatch_retries").value() == 1
        assert reg.counter("serve_dispatch_failures").value() == 0
    finally:
        app.close()


def test_second_dispatch_failure_is_a_500(model_path, monkeypatch):
    """No CPU re-dispatch in the port: a second failure fails the request
    (HTTP 500), counted as serve_dispatch_failures."""
    monkeypatch.setenv(ENV_FAULTS, "serve.dispatch:1,serve.dispatch:2")
    faults.reset()
    app = _app(model_path, batch=True)
    srv, port = _serve(app)
    try:
        status, body = _call(port, "POST", "/predict", {"rows": _rows().tolist()})
        assert status == 500 and "injected fault" in body["error"]
        reg = app.metrics.registry
        assert reg.counter("serve_dispatch_retries").value() == 1
        assert reg.counter("serve_dispatch_failures").value() == 1
        assert "lgbtpu_serve_dispatch_failures_total" in app.prometheus_metrics()
        status, body = _call(port, "POST", "/predict", {"rows": _rows().tolist()})
        assert status == 200  # the third dispatch, no fault planned: served
        assert np.array_equal(np.asarray(body["predictions"]), model_path[1].predict(_rows()))
    finally:
        _stop(srv, app)


def test_client_faults_are_not_retried(model_path):
    app = _app(model_path, batch=False)
    try:
        with pytest.raises(LightGBMError):
            app.predict(np.zeros((2, 9)))  # wrong width -> client fault
        assert app.metrics.registry.counter("serve_dispatch_retries").value() == 0
    finally:
        app.close()


def test_deadline_exceeded_maps_to_counter(model_path, monkeypatch):
    monkeypatch.setenv(ENV_FAULTS, "serve.batcher:1:hang:1.0")
    faults.reset()
    app = _app(model_path, batch=True)
    try:
        with pytest.raises(DeadlineExceeded):
            app.predict(_rows(), deadline_s=0.1)
        assert app.metrics.registry.counter("serve_deadline_exceeded").value() == 1
    finally:
        app.close()


@pytest.mark.parametrize("bad", [float("inf"), 0.0, -1.0, float("nan"), 1e19])
def test_invalid_deadline_is_client_fault(model_path, bad):
    app = _app(model_path, batch=False)
    try:
        with pytest.raises(LightGBMError, match="deadline"):
            app.predict(_rows(), deadline_s=bad)
        with pytest.raises(LightGBMError, match="deadline"):
            ServeApp(batch=False, default_deadline_s=bad, device="cpu")
    finally:
        app.close()


def test_no_batch_deadline_enforced(model_path, monkeypatch):
    monkeypatch.setenv(ENV_FAULTS, "serve.dispatch:1:hang:1.5")
    faults.reset()
    app = _app(model_path, batch=False)
    t0 = time.perf_counter()
    try:
        with pytest.raises(DeadlineExceeded):
            app.predict(_rows(), deadline_s=0.1)
        assert time.perf_counter() - t0 < 1.2  # did not wait out the hang
    finally:
        app.close()
        # let the abandoned dispatch's thread finish its hang before the test ends
        time.sleep(max(0.0, t0 + 1.7 - time.perf_counter()))


def test_http_shed_sets_retry_after(model_path, monkeypatch):
    """Queue saturation over real HTTP: 503 + Retry-After before any work
    is enqueued, and both admitted requests complete."""
    monkeypatch.setenv(ENV_FAULTS, "serve.batcher:1:hang:2.0")
    faults.reset()
    app = _app(model_path, batch=True, max_queue_depth=1)
    srv, port = _serve(app)
    Xt = _rows(3)
    results = []

    def wait_for(cond):
        deadline = time.perf_counter() + 10.0
        while not cond():
            assert time.perf_counter() < deadline
            time.sleep(0.01)

    try:
        ts = [threading.Thread(target=lambda: results.append(
            _call(port, "POST", "/predict", {"rows": Xt.tolist()})), daemon=True) for _ in range(2)]
        ts[0].start()
        wait_for(lambda: faults.fire_count("serve.batcher") == 1)  # the worker holds it
        ts[1].start()
        wait_for(lambda: app.batcher.queue_depth() == 1)  # the second waits in the queue
        status, headers, body = _call(port, "POST", "/predict", {"rows": Xt.tolist()},
                                      headers=True)
        assert status == 503
        assert headers.get("Retry-After") == "1"
        assert body["reason"] == "queue_full"
        for th in ts:
            th.join(timeout=10)
        assert len(results) == 2 and all(r[0] == 200 for r in results)
        assert app.metrics.registry.counter("serve_shed").value(reason="queue_full") == 1
        assert "lgbtpu_serve_shed_total" in app.prometheus_metrics()
    finally:
        _stop(srv, app)


def test_http_deadline_maps_to_504(model_path, monkeypatch):
    monkeypatch.setenv(ENV_FAULTS, "serve.batcher:1:hang:1.0")
    faults.reset()
    app = _app(model_path, batch=True)
    srv, port = _serve(app)
    try:
        status, body = _call(port, "POST", "/predict", {"rows": _rows(3).tolist(), "deadline_ms": 80})
        assert status == 504 and "deadline" in body["error"]
    finally:
        _stop(srv, app)


def test_draining_rejects_new_requests(model_path):
    app = _app(model_path, batch=True)
    try:
        assert app.drain(timeout_s=5.0) is True  # an idle server drains clean
        with pytest.raises(ServeOverloaded):
            app.predict(_rows())
        assert app.metrics.registry.counter("serve_shed").value(reason="draining") == 1
    finally:
        app.close()


def test_warmup_then_zero_retraces(model_path):
    """``warmup_rows`` dispatches every bucket of both paths at load; armed
    after it, mixed traffic meets no new shape (a batch past the warmed
    ladder is split into chunks of its top bucket), and a hot swap's own
    warm-up does not count as a retrace."""
    app = _app(model_path, batch=True, warmup_rows=64)
    try:
        app.arm_retrace_watchdog()
        rng = np.random.RandomState(1)
        for n in (1, 7, 8, 9, 33, 64, 100, 300):
            for fused in (False, True):
                rows = rng.randn(n, 4)
                out, _ = app.predict(rows, fused=fused)
                if not fused:
                    assert np.array_equal(out, model_path[1].predict(rows))
        app.registry.load("m", model_path[0])  # hot swap under an armed watchdog
        app.predict(rng.randn(20, 4))
        assert retrace.retraces_after_warmup() == {}
        stats = app.dispatcher_stats()["m"]
        assert set(stats["exact"]["buckets"]) == {8, 16, 32, 64}
        assert set(stats["fused"]["buckets"]) == {8, 16, 32, 64}
    finally:
        retrace.disarm()
        app.close()


def test_drift_options_refused(model_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="drift"):
        ServeApp(drift=True, device="cpu")
    monkeypatch.setenv("LIGHTGBM_TPU_DRIFT", "1")
    with pytest.raises(NotImplementedError, match="LIGHTGBM_TPU_DRIFT"):
        ServeApp(device="cpu")
    monkeypatch.delenv("LIGHTGBM_TPU_DRIFT")
    for flag in (["--drift"], ["--drift-threshold", "0.3"]):
        with pytest.raises(NotImplementedError, match=flag[0]):
            serve_main.main(["m=" + model_path[0], "--device", "cpu", *flag])


def test_cli_parser_takes_the_jax_flags_and_device():
    args = serve_main.build_parser().parse_args(
        ["a=m.txt", "--port", "0", "--mode", "fused", "--max-batch-rows", "64",
         "--max-delay-ms", "1", "--min-bucket-rows", "8", "--no-batch", "--warmup-rows", "32",
         "--deadline-s", "5", "--max-queue-depth", "4", "--drain-timeout-s", "2",
         "--device", "cpu"])
    assert (args.device, args.mode, args.warmup_rows, args.no_batch) == ("cpu", "fused", 32, True)
    assert serve_main.build_parser().parse_args(["m.txt"]).device == "cuda"


def test_sigterm_drains_the_server_process(model_path, tmp_path):
    """``python -m lightgbm_tpu_torch.serve --device cpu`` answers, then
    drains on SIGTERM and exits 0 with its final report."""
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch.serve", "m=" + model_path[0], "--port", "0",
         "--device", "cpu", "--warmup-rows", "16"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    box = {}

    def read():
        box["line"] = proc.stdout.readline()

    try:
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(120)
        start = json.loads(box["line"])
        assert start["serving"] and start["device"] == "cpu" and start["models"] == ["m"]
        status, body = _call(start["port"], "POST", "/predict", {"rows": _rows().tolist()})
        assert status == 200
        assert np.array_equal(np.asarray(body["predictions"]), model_path[1].predict(_rows()))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        final = json.loads(out.strip().splitlines()[-1])
        assert proc.returncode == 0 and final["serving"] is False and final["drained"] is True
        assert final["counters"]["requests"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)


# ---------------------------------------------------------------------------
# the host modules the serving path brought along, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"attempts": 5}, {"attempts": 4, "base_s": 0.05, "factor": 3.0, "max_s": 0.5},
    {"attempts": 6, "jitter": 0.3, "seed": 7}, {"attempts": 9, "max_elapsed_s": 10.0},
])
def test_backoff_schedule_equals_jax(kw):
    from lightgbm_tpu.resil import backoff as jbackoff

    from lightgbm_tpu_torch.resil import backoff

    assert list(backoff.delays(**kw)) == list(jbackoff.delays(**kw))
    a, b = backoff.decorrelated(seed=3), jbackoff.decorrelated(seed=3)
    assert [next(a) for _ in range(8)] == [next(b) for _ in range(8)]


def test_fault_plan_fires_at_its_occurrence(monkeypatch):
    monkeypatch.setenv(ENV_FAULTS, "site.a:2,site.b:1:raise")
    faults.reset()
    faults.maybe_fire("site.a")
    with pytest.raises(faults.InjectedFault, match="site.a #2"):
        faults.maybe_fire("site.a")
    faults.maybe_fire("site.a")  # fires once
    assert faults.fire_count("site.a") == 3
    with pytest.raises(faults.InjectedFault):
        faults.maybe_fire("site.b")
    monkeypatch.setenv(ENV_FAULTS, "site.a:zero")
    with pytest.raises(faults.FaultPlanError, match="not an int"):
        faults.maybe_fire("site.a")
    monkeypatch.setenv(ENV_FAULTS, "site.a:1:explode")
    with pytest.raises(faults.FaultPlanError, match="unknown action"):
        faults.maybe_fire("site.a")


def test_sanitizer_locks_mode_and_unported_modes(monkeypatch):
    from lightgbm_tpu_torch.obs import sanitize

    try:
        for mode in ("transfer", "nan", "locks,transfer"):
            monkeypatch.setenv(sanitize.ENV_SAN, mode)
            with pytest.raises(NotImplementedError, match="LIGHTGBM_TPU_SAN="):
                sanitize.refresh()
        monkeypatch.setenv(sanitize.ENV_SAN, "typo")
        with pytest.raises(LightGBMError, match="unknown sanitizer mode"):
            sanitize.refresh()
        monkeypatch.setenv(sanitize.ENV_SAN, "all")
        assert sanitize.refresh() == frozenset({"locks"})
        a, b = sanitize.make_lock("a"), sanitize.make_lock("b")
        with a:
            with b:
                pass
        with pytest.raises(sanitize.SanitizerError, match="inversion"):
            with b:
                with a:
                    pass
        assert ("a", "b") in sanitize.lock_edges()
        assert sanitize.transfer_scope("serve.dispatch") is sanitize.transfer_scope("x")
    finally:
        monkeypatch.delenv(sanitize.ENV_SAN, raising=False)
        sanitize.refresh()
        sanitize.reset_lock_graph()


def test_trace_records_a_request_s_spans(model_path, tmp_path):
    from lightgbm_tpu_torch.obs import trace

    path = str(tmp_path / "trace.json")
    trace.start(path)
    app = _app(model_path, batch=True)
    try:
        app.predict(_rows(3))
    finally:
        app.close()
        assert trace.stop() == path
    events = json.load(open(path))["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"serve.request", "serve.queue_wait", "serve.batch_dispatch"} <= names
    merged = str(tmp_path / "merged.json")
    assert trace.merge_traces(merged, [path, path])["pids"] == 2


def test_registry_exposition_equals_jax():
    """The port's registry renders the JAX registry's Prometheus text for the
    same instruments."""
    from lightgbm_tpu.obs.registry import MetricsRegistry as JaxRegistry

    from lightgbm_tpu_torch.obs.registry import MetricsRegistry

    texts = []
    for reg in (MetricsRegistry(), JaxRegistry()):
        reg.counter("requests", "served requests").inc(3)
        reg.counter("serve_shed").inc(reason="queue_full")
        reg.gauge("model_buckets").set(4, model="m", kind="exact")
        reg.gauge("queue_depth").set_fn(lambda: 2.0)
        h = reg.histogram("latency_seconds", 8)
        for v in (0.5, 0.25, 1.0, 2.0):
            h.record(v)
        texts.append(reg.prometheus_text())
        assert reg.counters() == {"requests": 3, "serve_shed": 1}
    assert texts[0] == texts[1]


def test_vopen_reads_local_paths_and_names_remote_ones(tmp_path):
    from lightgbm_tpu_torch.utils import vfile

    p = tmp_path / "m.txt"
    p.write_text("tree")
    with vfile.vopen(str(p)) as fh:
        assert fh.read() == "tree"
    assert vfile.vexists(str(p)) and not vfile.vexists(str(tmp_path / "no.txt"))
    assert vfile.is_remote("s3://bucket/m.txt") and not vfile.is_remote(str(p))
    with pytest.raises(LightGBMError, match="nosuchscheme"):
        vfile.vopen("nosuchscheme://bucket/m.txt")
