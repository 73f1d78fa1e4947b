"""Shape-aware histogram tune sweep and its routing tables.

Counterpart of lightgbm_tpu/obs/tune.py. A training emits histogram calls
at a distribution of row counts (the row classes of the bucket lattice,
ops/hist_kernel.py ``bucket_sizes``), and which kernel is fastest depends on the call's shape.
:func:`sweep` times every kernel that the capability table allows at each
row class, bin width and operand type on the card, and writes the winners
into a table:

 * ``save_table`` publishes it atomically (resil/atomic.py); ``load_table``
   refuses a torn file, a stale schema or a digest that does not match the
   entries. The schema and the digest are the JAX package's, so a table
   written by either package loads in the other; the table's ``backend``
   (``cuda`` here) keeps it from routing the other package's runs.
 * ``active_table`` is what ``GBDT._setup_train`` freezes for a run: the
   ``hist_tune`` param, else the LIGHTGBM_TPU_HIST_TUNE env var, ``"off"``
   disabling both.

The CLI, on a machine with a CUDA card::

    python -m lightgbm_tpu_torch.obs.tune --out TUNE_HIST.json \\
        --rows 1048576 --bins 15,63,255 --features 28 --dtypes float32,bfloat16

Every contender is a hand-written kernel; a build or launch failure raises
and the sweep fails. Times are CUDA-event medians of ``repeats`` calls after
one warm-up, with the 50 MB L2 flushed before each, at the grower's call
form: the [F, N] view of an [N, F] bin copy (and at B <= 16 the nibble-packed
copy ``cuda_packed4`` reads), the largest class whole and every smaller
class as a ``rows`` segment. The per-feature-grid kernel
(``hist_v1``, not routable) is timed beside the contenders at each shape as
the baseline, under ``baseline_ms``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import log
from ..utils.log import LightGBMError

SCHEMA = 1

ENV_PATH = "LIGHTGBM_TPU_HIST_TUNE"


# ---------------------------------------------------------------------------
# table build / digest / persistence
# ---------------------------------------------------------------------------

def entries_digest(entries: Sequence[Dict]) -> str:
    """Content digest over the routing fields of the entries (the JAX
    package's, so tables are checked alike in both)."""
    canon = sorted(
        (int(e["B"]), int(e["K"]), str(e["hist_dtype"]), int(e["rows_bucket"]), str(e["impl"]))
        for e in entries
    )
    return hashlib.sha256(repr(canon).encode("utf-8")).hexdigest()[:16]


def build_table(
    entries: Sequence[Dict],
    backend: str = "cuda",
    device_kind: str = "",
    device_family: Optional[str] = None,
    sweep_meta: Optional[Dict] = None,
) -> Dict:
    """A schema-stamped, digest-sealed table from entries (each
    ``{B, K, hist_dtype, rows_bucket, impl[, times_ms]}``)."""
    import torch

    from .costs import normalize_device_kind

    ents = [dict(e) for e in entries]
    return {
        "schema": SCHEMA,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "backend": backend,
        "device_kind": device_kind,
        "device_family": device_family or normalize_device_kind(device_kind) or backend,
        "torch": torch.__version__,
        "digest": entries_digest(ents),
        "entries": ents,
        "sweep": dict(sweep_meta or {}),
    }


def save_table(table: Dict, path: str) -> str:
    """Publish ``table`` at ``path`` atomically; returns ``path``."""
    from ..resil.atomic import atomic_write_text

    return atomic_write_text(path, json.dumps(table, indent=1, sort_keys=True) + "\n")


def load_table(path: str) -> Dict:
    """Load and check a tune table. Raises LightGBMError on a missing or torn
    file, another schema, or a digest mismatch."""
    try:
        with open(path) as fh:
            table = json.load(fh)
    except (OSError, ValueError) as e:
        raise LightGBMError("histogram tune cache %s is unreadable: %s" % (path, e))
    if not isinstance(table, dict) or table.get("schema") != SCHEMA:
        raise LightGBMError(
            "histogram tune cache %s has schema %r but this build expects %d; refusing "
            "stale routing: regenerate it with `python -m lightgbm_tpu_torch.obs.tune --out %s`"
            % (path, table.get("schema") if isinstance(table, dict) else None, SCHEMA, path)
        )
    entries = table.get("entries")
    if not isinstance(entries, list):
        raise LightGBMError("histogram tune cache %s carries no entries list" % path)
    want = table.get("digest")
    got = entries_digest(entries)
    if want != got:
        raise LightGBMError(
            "histogram tune cache %s failed its digest check (%s != %s): a hand-edited or "
            "corrupted table must not route kernels; regenerate it" % (path, want, got)
        )
    return table


def active_table(param: str = "") -> Tuple[Optional[Dict], str]:
    """The tune table a training run freezes, or (None, "").

    ``param`` is the ``hist_tune`` value: a path (load failures raise),
    ``"off"`` (disables the env var too), or ``""`` (consult
    LIGHTGBM_TPU_HIST_TUNE; failures there warn once and fall back to
    default routing)."""
    param = (param or "").strip()
    if param.lower() == "off":
        return None, ""
    explicit = bool(param)
    path = param or os.environ.get(ENV_PATH, "").strip()
    if not path or path.lower() == "off":
        return None, ""
    try:
        return load_table(path), path
    except LightGBMError:
        if explicit:
            raise
        log.warn_once(
            "hist-tune-env-load:%s" % path,
            "%s=%s could not be loaded; continuing with default histogram routing" % (ENV_PATH, path),
        )
        return None, ""


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def sweep_shapes(
    n_rows: int,
    bins_list: Sequence[int],
    num_features: int,
    dtypes: Sequence[str] = ("float32",),
) -> List[Dict]:
    """One shape per (row class of the grower's lattice at ``n_rows``, B,
    dtype), with the K=3 value channels the kernels take; each swept row
    count is its own route key."""
    from ..ops.hist_kernel import bucket_sizes, rows_bucket

    rows = sorted({rows_bucket(s) for s in bucket_sizes(int(n_rows))})
    return [
        {"rows": r, "B": int(b), "K": 3, "F": int(num_features), "hist_dtype": str(d)}
        for d in dtypes
        for b in bins_list
        for r in rows
    ]


def candidate_impls(num_bins: int, backend: str = "cuda") -> List[str]:
    """The impls the router can take at this width on ``backend``."""
    from ..ops import hist_kernel

    return [i for i in hist_kernel.IMPLS if hist_kernel.impl_supported(i, num_bins, backend)]


class CudaTimer:
    """Median device time of a callable between two CUDA events.

    Before each timed call a 64 MB buffer is zeroed (more than the 50 MB L2,
    so inputs come from device memory as in the grower) and a ~1 ms spin
    kernel keeps the card busy while the host enqueues the call, so launch
    overhead stays out of the time. ``setup``, when given, runs before each
    call and before the flush, untimed: it restores what a call that
    changes its own inputs changed."""

    def __init__(self, device) -> None:
        import torch

        self._flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn: Callable[[], object], reps: int = 10,
                 setup: Optional[Callable[[], object]] = None) -> float:
        import torch

        if setup is not None:
            setup()
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(max(int(reps), 1)):
            if setup is not None:
                setup()
            self._flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def sweep(shapes: Sequence[Dict], repeats: int = 3, seed: int = 0) -> Dict:
    """Race every candidate kernel at every shape on the current CUDA card;
    returns the table (save it with :func:`save_table`). Each entry keeps
    the winner, every contender's median (``times_ms``) and the unrouted
    baseline kernel's (``baseline_ms``)."""
    import torch

    from ..ops import hist_kernel

    if not torch.cuda.is_available():
        raise RuntimeError("the tune sweep times kernels on a CUDA card; none is available")
    dev = torch.device("cuda")
    timer = CudaTimer(dev)
    gen = torch.Generator().manual_seed(int(seed))
    if not shapes:
        raise ValueError("no shapes to sweep")
    top = max(int(s["rows"]) for s in shapes)
    F = max(int(s["F"]) for s in shapes)
    # inputs made once at the largest class and sliced per shape
    raw = torch.randint(0, 1 << 15, (top, F), generator=gen, dtype=torch.int32)
    vals = torch.randn((top, 3), generator=gen).to(dev)
    order = torch.randperm(top, generator=gen).to(torch.int32)
    by_width: Dict[int, torch.Tensor] = {}
    packed: Dict[int, torch.Tensor] = {}  # the grower's set-up copy at B <= 16
    entries: List[Dict] = []
    for sh in shapes:
        rows, B, K, f = int(sh["rows"]), int(sh["B"]), int(sh["K"]), int(sh["F"])
        dt = str(sh["hist_dtype"])
        if K != 3:
            raise ValueError("the kernels take K=3 value channels, got %d" % K)
        if B not in by_width:
            by_width[B] = (raw % B).to(torch.uint8).to(dev)  # [top, F], the [N, F] copy
            if B <= 16:
                packed[B] = hist_kernel.pack_bins(by_width[B])
        bins = by_width[B][:, :f].t()
        bins_p = packed[B][:, :f].t() if B in packed else None
        seg = None if rows == top else torch.sort(order[:rows])[0].to(dev)

        def run(impl):
            return lambda: hist_kernel.routed_histogram(
                bins, vals, B, rows=seg, impl=impl, hist_dtype=dt, bins_packed=bins_p
            )

        times = {impl: timer(run(impl), repeats) for impl in candidate_impls(B)}
        baseline = timer(lambda: hist_kernel.hist_v1(bins, vals, B, seg, dt), repeats)
        entries.append({
            "B": B, "K": K, "hist_dtype": dt, "rows_bucket": hist_kernel.rows_bucket(rows),
            "rows": rows, "F": f, "impl": min(times, key=times.get),
            "times_ms": {k: round(v, 4) for k, v in times.items()},
            "baseline_ms": {"hist_v1": round(baseline, 4)},
        })
    meta = {"repeats": int(repeats), "seed": int(seed), "n_shapes": len(shapes),
            "timer": "cuda events, median after one warm-up, L2 flushed"}
    return build_table(entries, device_kind=torch.cuda.get_device_name(dev), sweep_meta=meta)


# ---------------------------------------------------------------------------
# CLI: python -m lightgbm_tpu_torch.obs.tune
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs.tune",
        description="Time the histogram kernels at the grower's row classes on the CUDA "
        "card and write the routing table.",
    )
    ap.add_argument("--out", required=True, help="table path (atomic write)")
    ap.add_argument("--rows", type=int, default=1048576,
                    help="training row count whose bucket lattice to sweep")
    ap.add_argument("--bins", default="15,63,255",
                    help="comma-separated histogram widths B: the max_num_bin the "
                    "trainings really emit (route keys match exactly)")
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--dtypes", default="float32",
                    help="comma-separated hist_dtype list (float32[,bfloat16])")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    bins_list = [int(b) for b in args.bins.split(",") if b]
    dtypes = [d for d in args.dtypes.split(",") if d]
    shapes = sweep_shapes(args.rows, bins_list, args.features, dtypes=dtypes)
    t0 = time.perf_counter()
    table = sweep(shapes, repeats=args.repeats, seed=args.seed)
    save_table(table, args.out)
    winners = {
        "B=%d,dt=%s,rows=%d" % (e["B"], e["hist_dtype"], e["rows_bucket"]): e["impl"]
        for e in table["entries"]
    }
    print(json.dumps({
        "ok": bool(table["entries"]),
        "path": args.out,
        "digest": table["digest"],
        "backend": table["backend"],
        "device_family": table["device_family"],
        "entries": len(table["entries"]),
        "sweep_s": time.perf_counter() - t0,
        "winners": winners,
    }), flush=True)
    return 0 if table["entries"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
