"""Wrapper of the hand-written CUDA two-child split scan (csrc/split_pair.cu).

``find_best_split_pair`` takes the kernel for CUDA tensors and the plain
PyTorch version (ops/split.py) for CPU tensors; any other device, and
anything the kernel does not take, raises. ``split_pair_step`` is the
device-resident split loop's entry (``lgbt_split_pair_dev``): it reads the
leaves, their sums, windows and depth from a
:class:`~.grow_state.GrowState` in device memory and writes the records
into its ``best_f`` / ``best_i``. ``split_pair_fold`` is that entry as a
step of the loop runs it: the histogram subtraction folded into the scan,
the scratch buffers alternating by step parity. ``fold_mirror`` replays
its block decomposition on the host (which block reads and writes which
rows), so that the CPU tests hold it to the plain version.

The kernel's rows are staged in shared memory up to
``hist_kernel.MAX_BYTE_BINS`` (336) bins; past that, to 1024, its
``rows1024`` instantiations run (whatever the bins' type: the scan reads
histograms only). A state with a histogram pool takes the folded entry's
pool instantiation, which reads the rows by slot. ``launches`` counts the
calls that launched the kernel, by instantiation (:data:`KERNELS`):
``split_pair``, ``split_pair_step``, ``split_pair_fold`` and CEGB's
``split_pair_all``, with ``_rows1024`` past 336 bins, ``_pool`` for the
pool's and ``_cegb`` for the penalised ones; each launch counts under one
key.

With categorical features (``is_categorical`` in the meta) the kernel's
categorical instantiations run: each feature of that kind takes the
reference's categorical candidates, and every record carries its
membership words ([C, W] int32, ops/split.py); a numerical-only table runs
the numerical instantiations, with W = 0.

The kernel reads the children's rows out of the grower's ``[M, F, B, 3]``
histograms by leaf index (``leaves``), and picks each child's feature in the
same launch through a ticket counter per child: an int32 [2] tensor per
device, allocated zeroed once and kept, which every launch leaves at 0.
Calls on one device must therefore run in order on one stream, as every
caller in the port does (the device's current stream).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import cuda_build, grow_state as gs, split
from . import grow_step as plain_step
from .hist_kernel import MAX_BYTE_BINS, MAX_WIDE_BINS as MAX_BINS
from .split import SplitParams

KERNELS = ("split_pair", "split_pair_rows1024", "split_pair_step", "split_pair_step_rows1024",
           "split_pair_fold", "split_pair_fold_rows1024", "split_pair_fold_pool",
           "split_pair_fold_rows1024_pool", "split_pair_step_cegb", "split_pair_step_rows1024_cegb",
           "split_pair_fold_cegb", "split_pair_fold_rows1024_cegb", "split_pair_all",
           "split_pair_all_rows1024", "split_pair_all_pool", "split_pair_all_rows1024_pool",
           "forced_record")
launches: Dict[str, int] = {}


def reset_launches() -> None:
    """Every launch count of this module to 0."""
    launches.update(dict.fromkeys(KERNELS, 0))


reset_launches()


def _count(name: str, B: int, pooled: bool = False, cegb: bool = False) -> None:
    launches[name + ("_rows1024" if B > MAX_BYTE_BINS else "") + ("_pool" if pooled else "")
             + ("_cegb" if cegb else "")] += 1
_META_KEYS = ("num_bin", "missing_type", "default_bin", "monotone")
#: the categorical arguments of both entries: is_cat, feat_b, outb; W,
#: max_cat_to_onehot; cat_smooth, lambda_l2 + cat_l2; max_cat_threshold;
#: min_data_per_group
_CAT_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int]
    + [ctypes.c_float]
)
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [ctypes.c_int] + _CAT_ARGTYPES
    + [ctypes.c_void_p]
)
_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_counter(dev: torch.device) -> torch.Tensor:
    count = _tickets.get(dev)
    if count is None:
        count = _tickets[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return count


def _cat_args(is_cat: Optional[torch.Tensor], feat_b: torch.Tensor, outb: torch.Tensor,
              W: int, p: SplitParams) -> tuple:
    """The categorical arguments of both C entries (null buffers without
    categorical features)."""
    return (
        None if is_cat is None else is_cat.data_ptr(),
        None if is_cat is None else feat_b.data_ptr(),
        None if is_cat is None else outb.data_ptr(),
        W, int(p.max_cat_to_onehot), float(p.cat_smooth), p.lambda_l2 + p.cat_l2,
        int(p.max_cat_threshold), float(p.min_data_per_group),
    )


def find_best_split_pair(
    hist: torch.Tensor,
    sums: torch.Tensor,
    cons: torch.Tensor,
    feature_meta: Dict[str, torch.Tensor],
    feature_mask: torch.Tensor,
    params: SplitParams,
    two_way: bool = True,
    leaves: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best split of each of C leaves, with its membership words; see
    ops/split.py.

    ``hist`` is [C, F, B, 3], or with ``leaves`` (C leaf indices) the
    grower's [M, F, B, 3], of which the scan reads rows ``leaves``. On CUDA:
    ``hist`` contiguous f32 with B <= 1024 and C 1 or 2, ``sums`` [C, 3] and
    ``cons`` [C, 2] contiguous f32, the meta arrays contiguous int32 [F],
    ``is_categorical`` (when present) and ``feature_mask`` bool [F], all on
    one device."""
    dev = hist.device
    if dev.type == "cpu":
        return split.find_best_split_pair(
            hist, sums, cons, feature_meta, feature_mask, params, two_way, leaves
        )
    if dev.type != "cuda":
        raise ValueError("find_best_split_pair: unsupported device %s" % dev)
    if hist.dim() != 4 or hist.shape[-1] != 3:
        raise ValueError("find_best_split_pair: hist must be [C, F, B, 3] or [M, F, B, 3]")
    M, F, B, _ = hist.shape
    leaves = list(range(M)) if leaves is None else [int(v) for v in leaves]
    C = len(leaves)
    if not 1 <= C <= 2 or not all(0 <= v < M for v in leaves):
        raise ValueError(
            "find_best_split_pair: the kernel scans 1 or 2 leaves of the %d given, not %s"
            % (M, leaves)
        )
    if B > MAX_BINS:
        raise ValueError("find_best_split_pair: the kernel takes B <= %d, not %d" % (MAX_BINS, B))
    for name, t, shape, dtype in (
        ("hist", hist, (M, F, B, 3), torch.float32),
        ("sums", sums, (C, 3), torch.float32),
        ("cons", cons, (C, 2), torch.float32),
        ("feature_mask", feature_mask, (F,), torch.bool),
        *((k, feature_meta[k], (F,), torch.int32) for k in _META_KEYS),
        *((k, feature_meta[k], (F,), torch.bool) for k in ("is_categorical",)
          if k in feature_meta),
    ):
        if (
            t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()
        ):
            raise ValueError(
                "find_best_split_pair: %s must be a contiguous %s %s tensor on %s"
                % (name, dtype, shape, dev)
            )
    is_cat = feature_meta.get("is_categorical")
    W = split.num_words(B, is_cat is not None)
    feat_f = torch.empty((C, F, 4), dtype=torch.float32, device=dev)
    feat_i = torch.empty((C, F, 2), dtype=torch.int32, device=dev)
    feat_b = torch.empty((C, F, W), dtype=torch.int32, device=dev)
    outf = torch.empty((C, 9), dtype=torch.float32, device=dev)
    outi = torch.empty((C, 4), dtype=torch.int32, device=dev)
    outb = torch.empty((C, W), dtype=torch.int32, device=dev)
    p = params
    code = cuda_build.entry("split_pair", "lgbt_split_pair", _ARGTYPES)(
        hist.data_ptr(), leaves[0], leaves[-1], sums.data_ptr(), cons.data_ptr(),
        *(feature_meta[k].data_ptr() for k in _META_KEYS),
        feature_mask.data_ptr(), feat_f.data_ptr(), feat_i.data_ptr(),
        outf.data_ptr(), outi.data_ptr(), _ticket_counter(dev).data_ptr(), C, F, B,
        p.lambda_l1, p.lambda_l2, p.max_delta_step, float(p.min_data_in_leaf),
        p.min_sum_hessian_in_leaf, p.min_gain_to_split, int(bool(two_way)),
        *_cat_args(is_cat, feat_b, outb, W, p), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(code, "split_pair kernel")
    _count("split_pair", B)
    return outf, outi, outb


_ARGTYPES_STEP = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 6 + [ctypes.c_int] + _CAT_ARGTYPES + [ctypes.c_void_p]
)


def _step_args(s: gs.GrowState, C: int, parity: Optional[int]) -> tuple:
    """``lgbt_split_pair_dev``'s arguments for the CUDA state ``s``: the
    plain entry (``parity`` None) or the folded one, which reads
    ``s.small[parity]`` and clears ``s.small[1 - parity]`` (and with a
    pool reads its slots and ``s.large[parity]``, and clears
    ``s.large[1 - parity]``)."""
    if s.B > MAX_BINS:
        raise ValueError("split_pair_step: the kernel takes B <= %d, not %d" % (MAX_BINS, s.B))
    p, m = s.params, s.feature_meta
    small, zero = (0, 0) if parity is None else (
        s.small[parity].data_ptr(), s.small[1 - parity].data_ptr())
    pool, large, large_zero = (s.pool.data_ptr(), s.large[parity].data_ptr(),
                               s.large[1 - parity].data_ptr()) \
        if s.P and parity is not None else (None, None, None)
    return (
        s.hist.data_ptr(), s.ctl.data_ptr(), s.laux.data_ptr(), s.leaf_i.data_ptr(), small, zero,
        pool, large, large_zero, s.max_depth, *(m[k].data_ptr() for k in _META_KEYS), s.feature_mask.data_ptr(),
        s.feat_f.data_ptr(), s.feat_i.data_ptr(), s.best_f.data_ptr(), s.best_i.data_ptr(),
        _ticket_counter(s.device).data_ptr(), C, s.F, s.B, p.lambda_l1, p.lambda_l2,
        p.max_delta_step, float(p.min_data_in_leaf), p.min_sum_hessian_in_leaf,
        p.min_gain_to_split, int(s.two_way), *_cat_args(s.is_cat, s.feat_b, s.best_b, s.W, p),
        s.stream,
    )


_ARGTYPES_CEGB = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 6 + [ctypes.c_int] + _CAT_ARGTYPES + [ctypes.c_void_p] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2
)


def _cegb_args(s: gs.GrowState, C: int, parity: Optional[int], all_leaves: bool) -> tuple:
    """``lgbt_split_pair_cegb``'s arguments for the CUDA state ``s``: the
    root's entry (``parity`` None), the folded one, or the all-leaves one
    (a pooled state's reads its slots; its root's reads slot 0, the
    root's, as the unpooled entry does)."""
    if s.B > MAX_BINS:
        raise ValueError("split_pair_step: the kernel takes B <= %d, not %d" % (MAX_BINS, s.B))
    p, m, c = s.params, s.feature_meta, s.cegb
    small, zero = (0, 0) if parity is None else (
        s.small[parity].data_ptr(), s.small[1 - parity].data_ptr())
    feat_f, feat_i, feat_b, count = (s.feat_f_all, s.feat_i_all, s.feat_b_all, s.tickets_all) \
        if all_leaves else (s.feat_f, s.feat_i, s.feat_b, _ticket_counter(s.device))
    coupled = c.coupled_t is not None
    lazy = c.lazy_t is not None
    pooled = s.P and all_leaves
    return (
        s.hist.data_ptr(), s.ctl.data_ptr(), s.laux.data_ptr(), s.leaf_i.data_ptr(), small, zero,
        s.max_depth, *(m[k].data_ptr() for k in _META_KEYS), s.feature_mask.data_ptr(),
        feat_f.data_ptr(), feat_i.data_ptr(), s.best_f.data_ptr(), s.best_i.data_ptr(),
        count.data_ptr(), C, s.F, s.B, p.lambda_l1, p.lambda_l2, p.max_delta_step,
        float(p.min_data_in_leaf), p.min_sum_hessian_in_leaf, p.min_gain_to_split, int(s.two_way),
        *_cat_args(s.is_cat, feat_b, s.best_b, s.W, p),
        c.feature_used.data_ptr() if coupled else None,
        s.unused_cnt.data_ptr() if lazy else None,
        c.coupled_t.data_ptr() if coupled else None, c.lazy_t.data_ptr() if lazy else None,
        c.split, int(all_leaves), s.pool.data_ptr() if pooled else None, s.M, s.P,
        s.node_i.data_ptr(), s.stream,
    )


def _penalised(s: gs.GrowState, parity: Optional[int]) -> bool:
    """Does this scan of the state take the penalised instantiations? Under
    CEGB, but for a pooled step's folded scan (``GrowState.pooled_rescan``)."""
    return s.cegb is not None and not (parity is not None and s.pooled_rescan)


def _launch_step(s: gs.GrowState, key: str, C: int, parity: Optional[int]) -> None:
    args = s.args.get(key)
    if _penalised(s, parity):
        if args is None:
            args = s.args[key] = _cegb_args(s, C, parity, False)
        fn = cuda_build.entry("split_pair", "lgbt_split_pair_cegb", _ARGTYPES_CEGB)
    else:
        if args is None:
            args = s.args[key] = _step_args(s, C, parity)
        fn = cuda_build.entry("split_pair", "lgbt_split_pair_dev", _ARGTYPES_STEP)
    cuda_build.check(fn(*args), key + " kernel")


def _cuda_state(s: gs.GrowState, what: str) -> bool:
    """True for a CUDA state, False for a CPU one; raises otherwise."""
    if s.device.type == "cuda":
        return True
    if s.device.type != "cpu":
        raise ValueError("%s: unsupported device %s" % (what, s.device))
    return False


def split_pair_step(s: gs.GrowState, C: int) -> None:
    """Best split of leaf ``ctl[BEST]`` (C = 1, the root) or of the children
    ``ctl[BEST]`` and ``ctl[NEW]`` (C = 2) of the state ``s``, written to
    their rows of ``s.best_f`` / ``s.best_i``, the gain -inf at a depth >=
    ``s.max_depth`` (> 0); nothing once ``ctl[ACTIVE]`` is 0. The kernel on
    a CUDA state (its inputs checked once a tree by ``GrowState.bind``), the
    plain version (ops/split.py ``split_pair_step``) on a CPU one."""
    if C not in (1, 2):
        raise ValueError("split_pair_step: C must be 1 or 2, not %r" % (C,))
    if not _cuda_state(s, "split_pair_step"):
        split.split_pair_step(s, C)
        return
    _launch_step(s, "split_pair_step%d" % C, C, None)
    _count("split_pair_step", s.B, cegb=s.cegb is not None)


def split_pair_fold(s: gs.GrowState, parity: int) -> None:
    """A step's histogram subtraction and both children's split scan, one
    launch: ``hist[LARGE] = hist[BEST] - small[parity]``, ``hist[SMALL] =
    small[parity]``, ``small[1 - parity]`` cleared for the next step, then
    :func:`split_pair_step` with C = 2 on those rows; nothing once
    ``ctl[ACTIVE]`` is 0. With a pool the rows are the slots the step's
    pick chose, and on a miss the larger child's row is its own histogram
    ``large[parity]`` (ops/grow_step.py ``subtract``). The folded kernel on
    a CUDA state, the plain version (ops/grow_step.py ``split_pair_fold``)
    on a CPU one; see csrc/split_pair.cu."""
    if parity not in (0, 1):
        raise ValueError("split_pair_fold: parity must be 0 or 1, not %r" % (parity,))
    if not _cuda_state(s, "split_pair_fold"):
        plain_step.split_pair_fold(s, parity)
        return
    _launch_step(s, "split_pair_fold%d" % parity, 2, parity)
    _count("split_pair_fold", s.B, s.P > 0, cegb=_penalised(s, parity))


def split_pair_all(s: gs.GrowState) -> None:
    """CEGB's rescan of every leaf but the step's two children after a step
    that paid a coupled feature first (``ctl[NEWLY]``): csrc/split_pair.cu's
    all-leaves entry, grid (F, M), on a CUDA state (it returns at once on
    every other step); under a pool its pooled entry, grid (F, P): the
    step's children every step, with or without coupled penalties (the
    pooled fold's records are not penalised) and, after a first payment,
    the other resident leaves from their slots, the evicted ones' records
    patched. The plain version
    (ops/split.py ``split_pair_all``) on a CPU state. Needs a state bound
    with CEGB."""
    if s.cegb is None:
        raise ValueError("split_pair_all: a state bound with CEGB")
    if not _cuda_state(s, "split_pair_all"):
        split.split_pair_all(s)
        return
    args = s.args.get("split_pair_all")
    if args is None:
        args = s.args["split_pair_all"] = _cegb_args(s, s.P or s.M, None, True)
    fn = cuda_build.entry("split_pair", "lgbt_split_pair_cegb", _ARGTYPES_CEGB)
    cuda_build.check(fn(*args), "split_pair_all kernel")
    _count("split_pair_all", s.B, s.P > 0)


_ARGTYPES_FORCED = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4
)


def forced_record(s: gs.GrowState, k: int) -> None:
    """The record of step ``k`` of the forced-split preamble (the state's
    forced table's row k) into ``s.frec_*`` and ``ctl[FLEAF]``, or
    ``ctl[ABORT]`` set: csrc/split_pair.cu's forced record, one block, on a
    CUDA state; the plain version (ops/split.py ``forced_record``) on a CPU
    one. Needs a state bound with a forced table of more than ``k`` rows."""
    if s.forced is None or not 0 <= k < s.forced.shape[0]:
        raise ValueError("forced_record: step %d of a forced table of %s rows"
                         % (k, None if s.forced is None else s.forced.shape[0]))
    if not _cuda_state(s, "forced_record"):
        split.forced_record(s, k)
        return
    key = "forced_record%d" % k
    args = s.args.get(key)
    if args is None:
        if s.B > MAX_BINS:
            raise ValueError("forced_record: the kernel takes B <= %d, not %d" % (MAX_BINS, s.B))
        p, m = s.params, s.feature_meta
        args = s.args[key] = (
            s.hist.data_ptr(), s.ctl.data_ptr(), s.laux.data_ptr(), s.leaf_i.data_ptr(),
            s.slot_of.data_ptr() if s.P else None, s.forced.data_ptr(), k,
            m["num_bin"].data_ptr(), m["missing_type"].data_ptr(), m["default_bin"].data_ptr(),
            s.is_cat.data_ptr() if s.is_cat is not None else None, s.F, s.B, s.W, s.max_depth,
            p.lambda_l1, p.lambda_l2, p.max_delta_step, p.min_gain_to_split,
            s.frec_f.data_ptr(), s.frec_i.data_ptr(), s.frec_b.data_ptr(), s.stream,
        )
    fn = cuda_build.entry("split_pair", "lgbt_forced_record", _ARGTYPES_FORCED)
    cuda_build.check(fn(*args), "forced_record kernel")
    launches["forced_record"] += 1


def fold_mirror(s: gs.GrowState, parity: int, order: str = "large_first") -> Dict:
    """csrc/split_pair.cu's folded entry on a CPU state, block by block.
    Block (f, c) scans feature f of leaf ``(ctl[BEST], ctl[NEW])[c]``. The
    larger child's block reads ``hist[BEST][f]`` and ``small[parity][f]``,
    writes ``hist[LARGE][f]`` (their difference) and ``hist[SMALL][f]``, and
    scans the difference; the smaller child's block reads
    ``small[parity][f]``, clears ``small[1 - parity][f]`` and scans what it
    read. The blocks run one after another in ``order`` (``large_first``,
    ``small_first``, or ``by_feature``), each reading all its cells before
    it writes any, as each thread of the kernel does; then each child's
    rows are scanned as the kernel's blocks and last block do (the plain
    scan of the rows the blocks read, with the depth gate). Raises when a
    cell one block writes is read or written by another block (a race the
    launch's order would decide). Returns the blocks' reads and writes:
    ``{(f, c): (reads, writes)}``, each a set of (buffer, index, f)."""
    if s.device.type != "cpu" or s.P:
        raise ValueError("fold_mirror: a CPU state without a pool")
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return {}
    best, new = int(ctl[gs.BEST]), int(ctl[gs.NEW])
    small, large = int(ctl[gs.SMALL]), int(ctl[gs.LARGE])
    assert {small, large} == {best, new}, (best, new, small, large)
    leaves = (best, new)
    blocks = [(f, c) for f in range(s.F) for c in (0, 1)]
    is_large = {c: leaves[c] == large for c in (0, 1)}
    if order == "large_first":
        blocks.sort(key=lambda b: not is_large[b[1]])
    elif order == "small_first":
        blocks.sort(key=lambda b: is_large[b[1]])
    elif order != "by_feature":
        raise ValueError("fold_mirror: unknown order %r" % (order,))
    rows = torch.empty((2, s.F, s.B, 3), dtype=torch.float32)
    access = {}
    for f, c in blocks:
        if is_large[c]:
            reads = {("hist", best, f), ("small", parity, f)}
            writes = {("hist", large, f), ("hist", small, f)}
            pv, sv = s.hist[best, f].clone(), s.small[parity, f].clone()
            v = pv - sv
            s.hist[large, f] = v
            s.hist[small, f] = sv
        else:
            reads = {("small", parity, f)}
            writes = {("small", 1 - parity, f)}
            v = s.small[parity, f].clone()
            s.small[1 - parity, f] = 0.0
        rows[c, f] = v
        access[(f, c)] = (reads, writes)
    for a, (_, wa) in access.items():
        for b, (rb, wb) in access.items():
            if a != b and wa & (rb | wb):
                raise AssertionError("fold_mirror: block %s writes what block %s touches: %s"
                                     % (a, b, sorted(wa & (rb | wb))))
    aux = s.laux[list(leaves)]
    outf, outi, outb = split.find_best_split_pair(
        rows, aux[:, :3].contiguous(), aux[:, 3:].contiguous(), s.feature_meta, s.feature_mask,
        s.params, s.two_way)
    if s.max_depth > 0:
        outf[s.leaf_i[list(leaves), 1] >= s.max_depth, 0] = split.K_MIN_SCORE
    s.best_f[list(leaves)] = outf
    s.best_i[list(leaves)] = outi
    s.best_b[list(leaves)] = outb
    return access
