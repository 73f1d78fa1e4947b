"""Training throughput of the port on the ``bench.py`` shape, its boosting
loops paired in one process.

    python -m lightgbm_tpu_torch.bench [--rows 1000000] [--iters 10]
        [--pairs 2] [--warmup 3] [--chunk 10] [--device cuda] [--out results.json]

Trains binary GBDT on ``make_higgs_like(rows, 28)`` (helpers/bench_data.py,
the data of ``bench.py``) with num_leaves=255, max_bin=255,
learning_rate=0.1, in four boosters:

 * ``graph``: the device-resident split loop with each iteration one replay
   of the captured CUDA graph (models/gbdt.py), what training takes by
   default on this shape;
 * ``chunk``: the same with ``device_chunk_size`` = ``chunk``, ``chunk``
   replays a call and one readback (``Booster.update_chunk``);
 * ``device``: the device loop's eager launches (``iteration_graph`` off);
 * ``host``: the host split loop (ops/grow.py ``grow_tree``).

On the CPU the graph and chunk boosters run their iterations eagerly.
After ``warmup`` iterations each (which build and load the kernels and
capture the graph), they take turns of ``iters`` iterations, graph, chunk,
device, host, host, device, chunk, graph, ``pairs`` times, each turn timed
on the host clock from a synchronise to a synchronise: iterations per
second spread 30-50% inside one process, so only turns of one call compare.
Binning is set-up and not timed.

Prints ONE JSON line, the line of ``bench.py``: ``metric``, ``value`` (the
median over the graph booster's turns), ``unit``, ``vs_baseline`` (value
over LightGBM on the CPU, below), plus the other boosters' medians, every
turn, each booster's training AUC, the card's name and power limit, and the
settings. Exits 2 with the line's value 0.0 and an ``error`` when the device
asked for is not there.

The module also holds the tables of the objective cells (PERF.md section
4): ``year_like_rows`` (regression, YearPredictionMSD's shape) and
``covertype_like_rows`` (multiclass, Covertype's shape), with their
training params, which chip_smoke.py's phases 4e and 4f and
``obs/pair.py --kernel histogram_grid`` read, and
``covertype_compact_rows`` (the same rows with the two one-hot groups as
two categorical columns), which phase 4g reads, and ``flight_like_rows``
(a Flight-Delay-shaped sparse one-hot table, scipy CSR), which phase 4i
reads, and ``letor_like_rows`` (a ranking table of MSLR-WEB30K's shape,
with its query sizes), which phase 4k reads; phase 4l trains the
leaf-renewing objectives on ``year_like_rows``.

Baseline: LightGBM on the CPU trains the 10.5M-row Higgs set at 2.096
iterations/s on 16 Xeon threads (the reference's docs/Experiments.rst);
training is linear in rows, so 22.0 iterations/s at 1M rows (``bench.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List

BASELINE_ITERS_PER_SEC_1M = 2.096 * 10.5
METRIC_NAME = "higgs1m_boost_iters_per_sec"
UNIT = "iters/s (binary, 1M x 28, 255 leaves, 255 bins)"
FEATURES = 28
PARAMS = {
    "objective": "binary", "metric": "auc", "num_leaves": 255, "max_bin": 255,
    "learning_rate": 0.1, "verbose": -1,
}
LOOPS = ("graph", "chunk", "device", "host")
TURNS = ("graph", "chunk", "device", "host", "host", "device", "chunk", "graph")


#: the cells of chip_smoke.py's phases 4e and 4f (PERF.md section 4)
YEAR_ROWS, YEAR_VALID_ROWS, YEAR_FEATURES = 463_715, 51_630, 90  # UCI YearPredictionMSD splits
YEAR_PARAMS = {"objective": "regression", "metric": "l2", "max_bin": 255, "num_leaves": 255,
               "learning_rate": 0.1, "verbose": -1}
COVER_ROWS, COVER_VALID_ROWS = 581_012, 100_000  # UCI Covertype
#: Covertype's class shares (211,840 / 283,301 / 35,754 / 2,747 / 9,493 / 17,367 / 20,510)
COVER_SHARES = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
COVER_PARAMS = {"objective": "multiclass", "num_class": 7, "metric": ["multi_logloss", "multi_error"],
                "enable_bundle": False, "max_bin": 255, "num_leaves": 255, "learning_rate": 0.1,
                "verbose": -1}


def year_like_rows(n, seed, model_seed=11):
    """``n`` rows shaped like YearPredictionMSD (gbm-bench's ``year``): 90
    dense f32 columns, 12 timbre means and 78 timbre covariances (products
    of pairs of means plus noise), and a label of about 1998 +- 10 years, a
    smooth function of the means plus noise. The function comes from
    ``model_seed``, the rows from ``seed``; synthetic values."""
    import numpy as np

    rng = np.random.RandomState(model_seed)
    pairs = [rng.choice(12, 2, replace=False) for _ in range(78)]
    w1, w2 = rng.randn(12) / np.sqrt(12), rng.randn(12) / np.sqrt(12)
    rng = np.random.RandomState(seed)
    X = np.empty((n, YEAR_FEATURES), np.float32)
    X[:, :12] = rng.randn(n, 12).astype(np.float32) * 20.0
    for j, (a, b) in enumerate(pairs, 12):
        X[:, j] = X[:, a] * X[:, b] / 20.0 + rng.randn(n).astype(np.float32) * 5.0
    t = X[:, :12].astype(np.float64) / 20.0
    y = 1998.0 + 8.0 * np.tanh(t @ w1) + 5.0 * np.sin(t @ w2) + rng.randn(n) * 2.0
    return X, y


#: the ranking cell of chip_smoke.py's phase 4k: MSLR-WEB30K's width and
#: query sizes (1 to 1,251 rows, mean near 120) at the LightGBM paper's
#: LETOR row count (Ke et al., NIPS 2017, Table 1: 2M x 136)
LETOR_ROWS, LETOR_VALID_ROWS, LETOR_FEATURES, LETOR_MAX_QUERY = 2_000_000, 200_000, 136, 1251
LETOR_SHARES = (0.514, 0.325, 0.134, 0.019, 0.008)  # MSLR-WEB30K's label shares, 0 to 4
LETOR_PARAMS = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [1, 3, 5, 10],
                "max_bin": 255, "num_leaves": 255, "learning_rate": 0.1, "verbose": -1}
#: the leaf-renewing cells of phase 4l, on YearPredictionMSD's shape
RENEW_PARAMS = {
    "regression_l1": dict(YEAR_PARAMS, objective="regression_l1", metric="l1"),
    "quantile": dict(YEAR_PARAMS, objective="quantile", metric="quantile", alpha=0.9,
                     bagging_fraction=0.8, bagging_freq=1),
    "mape": dict(YEAR_PARAMS, objective="mape", metric="mape"),
}


def letor_like_rows(n, seed, model_seed=17):
    """``n`` rows shaped like MSLR-WEB30K: 136 dense f32 columns, query sizes
    drawn log-normally (mean near 120) and cut to 1..1,251, the last query
    trimmed to end at ``n``; labels 0-4 with MSLR-WEB30K's shares, cut from
    a relevance that is a function of 20 of the columns (from
    ``model_seed``) plus a query effect and noise. Synthetic values, rows
    from ``seed``. Returns (X, label, query sizes)."""
    import numpy as np

    w = np.random.RandomState(model_seed).randn(LETOR_FEATURES) * (
        np.arange(LETOR_FEATURES) < 20)
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(rng.lognormal(np.log(90.0), 0.8, n // 40 + 1000)), 1,
                    LETOR_MAX_QUERY).astype(np.int64)
    sizes = sizes[:int(np.searchsorted(np.cumsum(sizes), n)) + 1]
    sizes[-1] -= int(sizes.sum()) - n
    X = rng.standard_normal((n, LETOR_FEATURES), dtype=np.float32)
    rel = X @ w.astype(np.float32) + np.repeat(rng.standard_normal(len(sizes)), sizes) \
        + rng.standard_normal(n, dtype=np.float32)
    cuts = np.quantile(rel, np.cumsum(LETOR_SHARES)[:-1])
    return X, np.searchsorted(cuts, rel).astype(np.float64), sizes


def covertype_like_rows(n, seed, model_seed=13):
    """``n`` rows shaped like Covertype: 10 continuous columns, then 4
    wilderness-area and 40 soil-type one-hot columns (44 binary columns), and
    7 classes drawn with Covertype's skewed shares; each class moves the
    continuous columns' means and the one-hot groups' odds (from
    ``model_seed``). Synthetic values, rows from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(model_seed)
    mu = rng.randn(7, 10) * 0.6
    wild = rng.dirichlet(np.ones(4) * 0.7, 7)
    soil = rng.dirichlet(np.ones(40) * 0.3, 7)
    rng = np.random.RandomState(seed)
    y = rng.choice(7, n, p=np.asarray(COVER_SHARES) / sum(COVER_SHARES))
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = (rng.randn(n, 10) * 1.5 + mu[y]).astype(np.float32)
    for off, probs in ((10, wild), (14, soil)):
        u = rng.rand(n, 1)
        pick = (u > np.cumsum(probs[y], 1)).sum(1)
        X[np.arange(n), off + np.minimum(pick, probs.shape[1] - 1)] = 1.0
    return X, y.astype(np.float64)


#: the compact Covertype's categorical columns: Wilderness_Area (4 values)
#: and Soil_Type (40 values), UCI covtype.info's published form
COVER_CATEGORICAL = [10, 11]


def covertype_compact_rows(n, seed, model_seed=13):
    """The rows of :func:`covertype_like_rows` in Covertype's published form:
    the 10 continuous columns, then Wilderness_Area and Soil_Type as two
    integer-valued columns holding the index that ``covertype_like_rows``
    one-hot encodes (12 columns; categorical: :data:`COVER_CATEGORICAL`)."""
    import numpy as np

    X, y = covertype_like_rows(n, seed, model_seed)
    out = np.empty((n, 12), np.float32)
    out[:, :10] = X[:, :10]
    out[:, 10] = np.argmax(X[:, 10:14], axis=1)
    out[:, 11] = np.argmax(X[:, 14:54], axis=1)
    return out, y


#: the Flight-Delay-shaped table (Ke et al., NIPS 2017, Table 1: about 700
#: sparse one-hot features, binary): one-hot Month, DayofMonth, DayOfWeek,
#: UniqueCarrier, Origin and Dest, then DepTime and Distance
FLIGHT_FIELDS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7), ("UniqueCarrier", 22),
                 ("Origin", 300), ("Dest", 300))
FLIGHT_COLUMNS = sum(k for _, k in FLIGHT_FIELDS) + 2  # 674
FLIGHT_ROWS, FLIGHT_VALID_ROWS = 1_000_000, 100_000
FLIGHT_PARAMS = {"objective": "binary", "metric": ["auc", "binary_logloss"], "max_bin": 255,
                 "num_leaves": 255, "learning_rate": 0.1, "verbose": -1}


def flight_like_rows(n, seed, model_seed=17):
    """``n`` rows shaped like the Flight Delay set, as a scipy CSR matrix of
    :data:`FLIGHT_COLUMNS` columns (eight non-zeros a row): each field of
    :data:`FLIGHT_FIELDS` one-hot (value 1.0), Origin, Dest and
    UniqueCarrier drawn with Zipf-like popularity, then DepTime (hhmm,
    100-2359) and Distance (miles, 30-4000, longer between less popular
    airports). The label (delayed or not, about a quarter delayed) is drawn
    from a logistic model of the fields: an effect a category (from
    ``model_seed``), later departures and longer flights delayed more.
    Synthetic values, rows from ``seed``."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.RandomState(model_seed)
    effects = [rng.randn(k) * w for (_, k), w in zip(FLIGHT_FIELDS, (0.4, 0.2, 0.3, 0.7, 0.8, 0.8))]
    popularity = [None, None, None] + [1.0 / np.arange(1, k + 1) ** 0.9 for _, k in FLIGHT_FIELDS[3:]]
    rng = np.random.RandomState(seed)
    picks = []
    for (_, k), pop in zip(FLIGHT_FIELDS, popularity):
        picks.append(rng.randint(0, k, n) if pop is None else rng.choice(k, n, p=pop / pop.sum()))
    hour = np.clip(rng.normal(13.5, 4.5, n), 1.0, 23.98)
    dep = np.floor(hour) * 100 + np.floor((hour % 1) * 60)
    dist = np.clip(rng.lognormal(6.3, 0.6, n) + 3.0 * (picks[4] + picks[5]), 30, 4000).round()
    z = -2.0 + sum(e[p] for e, p in zip(effects, picks)) + 0.17 * (hour - 13.5) \
        + 0.25 * np.log(dist / 500.0)
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    cols = np.empty((n, 8), np.int32)
    start = 0
    for j, ((_, k), p) in enumerate(zip(FLIGHT_FIELDS, picks)):
        cols[:, j] = start + p
        start += k
    cols[:, 6], cols[:, 7] = start, start + 1
    data = np.ones((n, 8))
    data[:, 6], data[:, 7] = dep, dist
    X = sp.csr_matrix((data.ravel(), cols.ravel(), np.arange(0, 8 * n + 1, 8)),
                      shape=(n, FLIGHT_COLUMNS))
    return X, y


def _line(value: float, **extra) -> str:
    line = {"metric": METRIC_NAME, "value": value, "unit": UNIT,
            "vs_baseline": value / BASELINE_ITERS_PER_SEC_1M}
    line.update(extra)
    return json.dumps(line)


def card_name_and_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi unavailable (%s)" % exc
    return out[0] if out else "nvidia-smi unavailable"


def train_iterations(booster, n: int, chunk: int) -> int:
    """``n`` iterations of ``booster``, by ``update_chunk`` calls of up to
    ``chunk`` (``update`` at 1); fewer when training stops. Returns how many
    ran."""
    done = 0
    while done < n:
        ran, stopped = booster.update_chunk(min(chunk, n - done))
        done += ran
        if stopped:
            break
    return done


def paired_turns(train_set, iters: int, pairs: int, warmup: int, device: str,
                 chunk: int = 10) -> Dict:
    """The four boosters of ``LOOPS`` on ``train_set`` in turns of ``iters``
    timed iterations (``TURNS`` per pair) after ``warmup`` each. Returns
    every turn's iterations/s by booster, the boosters and each one's
    median."""
    import torch

    import lightgbm_tpu_torch as lgb

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    boosters, chunks = {}, {}
    for loop in LOOPS:
        chunks[loop] = chunk if loop == "chunk" else 1
        b = lgb.Booster(dict(PARAMS, device_chunk_size=chunks[loop]), train_set, device=device)
        b._gbdt.grow_loop = "host" if loop == "host" else "device"
        b._gbdt.iteration_graph = device == "cuda" and loop in ("graph", "chunk")
        train_iterations(b, warmup, chunks[loop])
        boosters[loop] = b
    turns: Dict[str, List[float]] = {loop: [] for loop in LOOPS}
    for _ in range(pairs):
        for loop in TURNS:
            sync()
            t0 = time.perf_counter()
            ran = train_iterations(boosters[loop], iters, chunks[loop])
            sync()
            turns[loop].append(ran / (time.perf_counter() - t0))
    return {"turns": turns, "boosters": boosters,
            "median": {loop: statistics.median(v) for loop, v in turns.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=10, help="timed iterations a turn")
    ap.add_argument("--pairs", type=int, default=2, help="device, host, host, device turns")
    ap.add_argument("--warmup", type=int, default=3, help="untimed iterations a booster")
    ap.add_argument("--chunk", type=int, default=10, help="device_chunk_size of the chunk booster")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="", help="also write the line and the turns here")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(_line(0.0, error="torch.cuda.is_available() is False; pass --device cpu"))
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from helpers.bench_data import make_higgs_like

    import lightgbm_tpu_torch as lgb

    X, y = make_higgs_like(args.rows, FEATURES)
    train_set = lgb.Dataset(X, label=y)
    run = paired_turns(train_set, args.iters, args.pairs, args.warmup, args.device, args.chunk)
    aucs = {}
    for loop, b in run["boosters"].items():
        (_, _, aucs[loop], _), = b.eval_train()
    card = card_name_and_limit() if args.device == "cuda" else "cpu"
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    med = run["median"]
    line = _line(
        med["graph"], chunk_iters_per_sec=med["chunk"], eager_device_loop_iters_per_sec=med["device"],
        host_loop_iters_per_sec=med["host"], graph_over_eager=med["graph"] / med["device"],
        device_over_host=med["device"] / med["host"], turns=run["turns"], auc=aucs,
        rows=args.rows, iters_per_turn=args.iters, pairs=args.pairs, chunk=args.chunk,
        device=kind, card=card,
    )
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
