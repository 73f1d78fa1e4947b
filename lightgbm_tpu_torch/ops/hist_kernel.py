"""The hand-written CUDA histogram kernels, their capability table, and the
measured routing that picks one per call.

Counterpart of lightgbm_tpu/ops/hist_pallas.py (the kernels, ``KERNEL_CAPS``,
``pack4``, ``bitplane_split``) and of the routing half of
lightgbm_tpu/ops/histogram.py (``IMPLS``, the env override, ``default_impl``,
``impl_supported``, ``rows_bucket``, ``HistRoute``, ``resolve_route``,
``device_family``, the cap fallback and the dispatch in ``leaf_histogram``).

Kernels (csrc/), each with a wrapper here and its own launch count in
``launches`` (a ``_bf16`` key for bf16 operands):

==============  ========================  ===================================
impl            wrapper, source           JAX kernel it replaces
==============  ========================  ===================================
``cuda``        ``histogram``             ``histogram_pallas`` (radix, fb)
                csrc/histogram.cu
(device loop)   ``histogram_segment``     the same, its rows, leaf and
                csrc/histogram.cu         bounds read from device memory
``cuda_onehot`` ``hist_onehot``           ``histogram_pallas_onehot``
                csrc/hist_onehot.cu
``cuda_bitplane`` ``hist_bitplane``       ``histogram_pallas_bitplane``
                csrc/hist_bitplane.cu
``cuda_packed4`` ``hist_packed4_rows``    ``histogram_pallas_packed4``
                (``hist_packed4``)
                csrc/hist_packed4.cu
(int16 bins)    ``histogram``,            the same at 256 < B <= 1024
                ``histogram_segment``     (kWide; B <= 336 in the JAX
                csrc/histogram.cu         kernel, XLA code past it)
(not routed)    ``hist_v1``               ``histogram_pallas_v1``, the
                csrc/hist_v1.cu           differential oracle of ``cuda``:
                                          fixed order, no atomics
==============  ========================  ===================================

The name map from the JAX vocabulary is :data:`JAX_NAMES` (``pallas`` ->
``cuda``, ``pallas_onehot`` -> ``cuda_onehot``, ``pallas_bitplane`` ->
``cuda_bitplane``, ``pallas_packed4`` -> ``cuda_packed4``, ``scatter`` ->
``scatter``). ``scatter`` is the plain PyTorch version and serves CPU tensors
only; JAX's ``xla``, ``xla_onehot`` and ``xla_radix`` are XLA programs and
have no counterpart: on CUDA the port routes only to hand-written kernels.

A wrapper launches its kernel for CUDA tensors and runs its plain version
(ops/histogram.py) for CPU tensors; any other device, and any input the
kernel does not take, raises. There is no fallback from one to the other.

``cuda_packed4`` reads bins two rows to a byte. A caller that holds the
nibble-packed copy of :func:`pack_bins` (the grower, from set-up, and the
tune sweep) passes it to :func:`routed_histogram`, which then reads a leaf
segment out of it by row; without one, the segment is gathered and packed
by :func:`pack4` on every call.

:func:`routed_histogram` takes the impl :func:`pick_impl` names for one
call, in precedence order:
an explicit ``impl``, then ``LIGHTGBM_TPU_HIST_IMPL`` (frozen at import; a
value outside :data:`IMPLS` warns and is ignored), then the run's frozen
:class:`HistRoute` (a tune table from obs/tune.py), then
:func:`default_impl` for the tensors' device. An impl that the capability
table refuses for the call's B warns once, counts
``hist_impl_fallback_total{requested}`` and takes the default for the
device: on CUDA the ``cuda`` kernel, never the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..obs.costs import normalize_device_kind
from ..obs.registry import REGISTRY
from ..utils import log
from ..utils.env import env_choice
from ..utils.log import LightGBMError
from . import cuda_build
from .histogram import (
    HIST_DTYPES, leaf_histogram, leaf_histogram_packed4_rows, operands, segment_histogram,
)

# ---------------------------------------------------------------------------
# vocabulary, capabilities, packing
# ---------------------------------------------------------------------------

#: csrc/histogram.cu's caps: uint8 bins (static cells) and int16 bins
#: (the kWide instantiations, dynamic cells sized by B)
MAX_BYTE_BINS = 336
MAX_WIDE_BINS = 1024

IMPLS = ("scatter", "cuda", "cuda_onehot", "cuda_bitplane", "cuda_packed4")

JAX_NAMES = {
    "scatter": "scatter", "pallas": "cuda", "pallas_onehot": "cuda_onehot",
    "pallas_bitplane": "cuda_bitplane", "pallas_packed4": "cuda_packed4",
}

# Which bin widths each kernel serves. The bounds are the JAX table's, so a
# shape is routable to a kernel in one package exactly when it is to its
# counterpart in the other, but for ``cuda`` past 336 bins.
KERNEL_CAPS = {
    # shared-memory atomics: uint8 bins up to the JAX radix kernel's B <= 336,
    # int16 bins up to 1024, where the JAX package runs XLA code (its
    # ``pallas`` cap stops at 336), so that a wide run takes the device loop
    "cuda": lambda b: b <= MAX_WIDE_BINS,
    # two 4-bit bins per byte
    "cuda_packed4": lambda b: b <= 16,
    # one-hot A operand of at most 16 tiles of 16 bins
    "cuda_onehot": lambda b: 2 <= b <= 256,
    # bit-plane factors of at most 16 x 16
    "cuda_bitplane": lambda b: 2 <= b <= 256,
}

# Resolved once at import so the routing of a process is fixed.
_ENV_IMPL = env_choice("LIGHTGBM_TPU_HIST_IMPL", IMPLS)


def env_impl() -> Optional[str]:
    """The impl ``LIGHTGBM_TPU_HIST_IMPL`` forces (frozen at import), or None."""
    return _ENV_IMPL or None


def impl_supported(
    impl: str, num_bins: int, backend: str, ignore_backend: bool = False
) -> bool:
    """Can ``impl`` serve a ``num_bins``-wide histogram on ``backend``? The
    one vocabulary the router, the tune sweep and :func:`resolve_route`
    share: ``scatter`` serves the CPU, a kernel the widths its cap allows on
    CUDA. ``ignore_backend`` checks the width alone: the gate for an impl
    forced on tensors of the other device (a kernel forced on CPU tensors
    runs its plain version). Unknown impls are unsupported."""
    if impl == "scatter":
        return ignore_backend or backend == "cpu"
    cap = KERNEL_CAPS.get(impl)
    if cap is None or not cap(num_bins):
        return False
    return ignore_backend or backend == "cuda"


def default_impl(backend: str) -> str:
    """The impl a call falls to with no explicit impl, env override or
    route entry: the plain version on the CPU, the ``cuda`` kernel on CUDA."""
    return "cuda" if backend == "cuda" else "scatter"


def bitplane_split(num_bins: int) -> Tuple[int, int]:
    """(lob, hib): power-of-two factor widths with ``bin = hi * lob + lo``,
    an even split of ``max(ceil(log2(B)), 2)`` bit planes (16 x 16 at
    B=255, 8 x 8 at B=63). ``lob * hib >= num_bins``."""
    p = max((num_bins - 1).bit_length(), 2)
    return 1 << (p // 2), 1 << (p - p // 2)


def pack4(bins: torch.Tensor, values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack ``[F, N]`` u8 bins (all < 16) and ``[N, K]`` values into the
    nibble layout :func:`hist_packed4` takes: ``[F, N2]`` u8 with row 2j in
    the low and row 2j+1 in the high nibble, and ``[N2, 2K]`` f32 holding
    the two rows' values side by side. Odd N pads one row of bin 0 and
    value 0."""
    F, N = bins.shape
    if N % 2:
        bins = torch.cat([bins, bins.new_zeros((F, 1))], dim=1)
        values = torch.cat([values, values.new_zeros((1, values.shape[1]))], dim=0)
    packed = (bins[:, 0::2] | (bins[:, 1::2] << 4)).contiguous()
    return packed, torch.cat([values[0::2], values[1::2]], dim=1).contiguous()


def pack_bins(bins_nf: torch.Tensor) -> torch.Tensor:
    """Pack ``[N, F]`` u8 bins (all < 16) into the ``[ceil(N/2), F]`` u8
    copy the grower keeps from set-up: byte ``[j, f]`` is ``bins[2j, f] |
    bins[2j+1, f] << 4``, and the high nibble of an odd N's last byte is 0.
    Its ``.t()`` is an ``[F, N2]`` view equal to ``pack4(bins_nf.t(), ...)[0]``
    that :func:`hist_packed4_rows` reads a 32-bit word a row pair."""
    if bins_nf.shape[0] % 2:
        bins_nf = torch.cat([bins_nf, bins_nf.new_zeros((1, bins_nf.shape[1]))])
    return (bins_nf[0::2] | (bins_nf[1::2] << 4)).contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

launches: Dict[str, int] = {}

# ``histogram_wide`` and ``histogram_segment_wide``: csrc/histogram.cu's
# int16 instantiations, counted apart from the byte ones
KERNELS = ("histogram", "histogram_segment", "histogram_wide", "histogram_segment_wide",
           "hist_onehot", "hist_bitplane", "hist_packed4", "hist_v1")


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
        launches[name + "_bf16"] = 0


reset_launches()

_ARGS_ROWS = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
]
# lgbt_histogram: the [F, N] arguments plus the grid's rows_per_block
_ARGS_HIST = _ARGS_ROWS[:9] + [ctypes.c_longlong] + _ARGS_ROWS[9:]
# lgbt_hist_v1: those of lgbt_histogram plus the chunks' scratch ahead of out
_ARGS_V1 = _ARGS_HIST[:10] + [ctypes.c_void_p] + _ARGS_HIST[10:]


def _entry(source: str, symbol: str, argtypes):
    return cuda_build.entry(source, symbol, argtypes)


def _check_dtype(hist_dtype: str) -> None:
    if hist_dtype not in HIST_DTYPES:
        raise ValueError("hist_dtype must be one of %s, got %r" % (HIST_DTYPES, hist_dtype))


def _check_bins(what: str, bins: torch.Tensor, num_bins: int, max_bins: int,
                wide: bool = False) -> None:
    """uint8 bins up to ``max_bins``; with ``wide`` also int16 bins up to
    :data:`MAX_WIDE_BINS` (csrc/histogram.cu's kWide instantiations)."""
    if bins.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, bins.device))
    if bins.dim() != 2 or not (bins.dtype == torch.uint8 or (wide and bins.dtype == torch.int16)):
        raise ValueError("%s: bins must be a 2-D uint8 tensor%s" % (what, " or int16" if wide else ""))
    if bins.dtype == torch.int16:
        max_bins = MAX_WIDE_BINS
    if not 1 <= num_bins <= max_bins:
        raise ValueError("%s: num_bins must be in [1, %d], got %d" % (what, max_bins, num_bins))


def bin_flags(bins: torch.Tensor, hist_dtype: str) -> int:
    """csrc/histogram.cu's flags: bit 0 bf16 operands, bit 1 int16 bins."""
    return int(hist_dtype == "bfloat16") | (2 if bins.dtype == torch.int16 else 0)


def _rows_n(name: str, bins, values, num_bins, rows, hist_dtype, max_bins, wide=False) -> int:
    """Validate the arguments of an ``[F, N]`` wrapper; return the row count."""
    _check_dtype(hist_dtype)
    _check_bins(name, bins, num_bins, max_bins, wide)
    N = bins.shape[1]
    if (
        values.device != bins.device
        or values.dtype != torch.float32
        or values.shape != (N, 3)
        or not values.is_contiguous()
    ):
        raise ValueError("%s: values must be a contiguous [N, 3] f32 tensor on the bins' device" % name)
    return N if rows is None else _rows_count(name, rows, bins.device)


def _rows_output(name: str, bins, values, num_bins, rows, hist_dtype, max_bins, wide=False):
    """:func:`_rows_n` and the zeroed ``[F, B, 3]`` output."""
    n = _rows_n(name, bins, values, num_bins, rows, hist_dtype, max_bins, wide)
    return n, torch.zeros((bins.shape[0], num_bins, 3), dtype=torch.float32, device=bins.device)


def _rows_count(name: str, rows: torch.Tensor, device: torch.device) -> int:
    """Validate a ``rows`` vector; return its length."""
    if rows.device != device or rows.dtype != torch.int32 or rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError("%s: rows must be a contiguous 1-D int32 tensor on the bins' device" % name)
    return rows.numel()


def _launch_rows(
    name: str, symbol: str, bins, values, num_bins, rows, hist_dtype, max_bins
) -> torch.Tensor:
    """Validate, allocate the zeroed ``[F, B, 3]`` output, launch the
    kernel ``symbol`` of ``csrc/<name>.cu`` on the current stream and
    count it."""
    n, out = _rows_output(name, bins, values, num_bins, rows, hist_dtype, max_bins)
    F = bins.shape[0]
    if n == 0 or F == 0:
        return out
    bf16 = hist_dtype == "bfloat16"
    code = _entry(name, symbol, _ARGS_ROWS)(
        bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
        rows.data_ptr() if rows is not None else None, n, F, num_bins, int(bf16),
        out.data_ptr(), torch.cuda.current_stream(bins.device).cuda_stream,
    )
    cuda_build.check(code, "%s kernel" % name)
    launches[name + ("_bf16" if bf16 else "")] += 1
    return out


# csrc/histogram.cu's block: HIST_GROUP features x a chunk of rows, taken
# HIST_STEP rows (256 threads x 4 rows) a step, in a static [HIST_GROUP, 336,
# 3] f32 shared histogram (uint8 bins) or a dynamic [HIST_GROUP, B, 3] one
# (int16 bins)
HIST_GROUP = 4
HIST_STEP = 1024
HIST_MAX_CHUNK = 65536
HIST_BLOCKS_PER_SM = 4


def histogram_grid(n: int, F: int, num_sms: int) -> Tuple[int, int, int]:
    """``(groups, chunks, rows_per_block)`` of csrc/histogram.cu for ``n``
    rows of ``F`` features on a card of ``num_sms`` SMs: ``ceil(F / 4)``
    feature groups, and chunks of a multiple of 1024 rows (1024 to 65536)
    aimed at about four blocks per SM. At F=28 on 132 SMs a 4488-row
    segment gets 5 chunks x 7 groups, the 1M root 76 chunks of 13312 rows."""
    groups = -(-F // HIST_GROUP)
    want = -(-(n * groups) // (HIST_BLOCKS_PER_SM * num_sms))
    rows_per_block = min(max(-(-want // HIST_STEP) * HIST_STEP, HIST_STEP), HIST_MAX_CHUNK)
    return groups, -(-n // rows_per_block), rows_per_block


_sm_counts: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """Multiprocessors of a card, read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def grouped_adds(bins: np.ndarray) -> bool:
    """Does the ``[F, N]`` uint8 bin table take csrc/histogram.cu's grouped
    form? True when some feature's rows crowd into few bins: two rows drawn
    at random share that feature's bin with a chance (the sum of its bins'
    squared shares) of at least 1/4. A feature of at most 4 bins always
    does, and a one-hot column at a share of 0.3-0.97 (the Covertype-shaped
    table's, where the grouped form runs 4-7x faster) is at 0.5-0.94; a
    table of spread bins keeps the plain loop, which pays nothing for the
    grouping (within it, the kernel's probe decides feature by feature)."""
    F, N = bins.shape
    if N == 0:
        return False
    return any(float(np.sum(np.square(np.bincount(bins[f], minlength=1) / N))) >= 0.25
               for f in range(F))


def histogram(bins, values, num_bins, rows=None, hist_dtype="float32", out=None, grouped=False):
    """``[F, B, 3]`` f32 histogram of ``values`` ([N, 3]) over ``bins``
    (csrc/histogram.cu: 4-feature blocks over row chunks of
    :func:`histogram_grid`, shared-memory atomics).

    ``bins`` is an ``[F, N]`` uint8 view with any strides, so the transposed
    ``[N, F]`` copy passes as ``bins_nf.t()``; or int16 at up to 1024 bins
    (the kernel's kWide instantiations, counted as ``histogram_wide``). ``rows`` is an optional int32
    vector of row indices (a leaf segment) into both inputs. The other
    ``[F, N]`` wrappers take the same arguments. ``out``, a zeroed
    contiguous ``[F, B, 3]`` f32 tensor on the bins' device, receives the
    histogram instead of a new tensor (the grower's root row). ``grouped``
    launches the kernel's grouped form (:func:`grouped_adds`): the same
    function, faster on features of few bins."""
    if bins.device.type == "cpu":
        got = leaf_histogram(bins, values, num_bins, rows, hist_dtype)
        return got if out is None else out.copy_(got)
    if out is None:
        n, out = _rows_output("histogram", bins, values, num_bins, rows, hist_dtype,
                              MAX_BYTE_BINS, wide=True)
    else:
        n = _rows_n("histogram", bins, values, num_bins, rows, hist_dtype, MAX_BYTE_BINS,
                    wide=True)
        if (out.device != bins.device or out.dtype != torch.float32 or not out.is_contiguous()
                or tuple(out.shape) != (bins.shape[0], num_bins, 3)):
            raise ValueError("histogram: out must be a contiguous [F, B, 3] f32 tensor on the bins' device")
    F = bins.shape[0]
    if n == 0 or F == 0:
        return out
    flags = bin_flags(bins, hist_dtype)
    code = _entry("histogram", "lgbt_histogram_grouped" if grouped else "lgbt_histogram",
                  _ARGS_HIST)(
        bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
        rows.data_ptr() if rows is not None else None, n, F, num_bins, flags,
        histogram_grid(n, F, _sm_count(bins.device))[2],
        out.data_ptr(), torch.cuda.current_stream(bins.device).cuda_stream,
    )
    cuda_build.check(code, "histogram kernel")
    launches[_count_key("histogram", flags)] += 1
    return out


def _count_key(name: str, flags: int) -> str:
    """The launch count of a csrc/histogram.cu entry for its :func:`bin_flags`."""
    return name + ("_wide" if flags & 2 else "") + ("_bf16" if flags & 1 else "")


def segment_max_chunks(N: int, F: int, num_sms: int) -> int:
    """The most chunks :func:`histogram_grid` gives any segment of at most
    ``N`` rows: chunks of at least ``want`` rows number at most ``ceil(4
    num_sms / groups)``, and capped chunks of 65536 rows ``ceil(N /
    65536)``. The segment entry's grid is ``groups`` times this."""
    groups = -(-F // HIST_GROUP)
    return max(-(-(HIST_BLOCKS_PER_SM * num_sms) // groups), -(-N // HIST_MAX_CHUNK), 1)


_ARGS_SEGMENT = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
)


def histogram_segment(s, parity: int = 0, large: bool = False) -> None:
    """The split loop's histogram of the smaller child (csrc/histogram.cu
    ``lgbt_histogram_segment``) on a :class:`~.grow_state.GrowState`: rows
    ``order[leaf_begin[l] : + leaf_count[l]]`` of leaf ``l = ctl[SMALL]``,
    all read from device memory, into ``s.hist_out(parity)`` (which the
    step before leaves zeroed: a segment of more than one chunk adds into
    it; a bundled state's group-space ``small_g[parity]`` at its group
    width), in the state's ``hist_dtype``; nothing once ``ctl[ACTIVE]``
    is 0. The grid is fixed once a tree (:func:`segment_max_chunks`); the
    state's ``grouped`` picks the grouped form, its bins' type (uint8 or
    int16) the byte or the wide instantiation.

    ``large`` (a state with a histogram pool): the same entry reads the
    pool's control vector ``s.pool_ctl`` instead, so it builds the larger
    child (leaf ``pool_ctl[LEAF]``) into ``s.large[parity]`` (a bundled
    state's group-space ``s.large_g[parity]``) when the
    step's pick found its parent evicted (``pool_ctl[RUN]``), and returns
    at once otherwise. On a CPU state the plain version, ops/histogram.py
    ``segment_histogram``."""
    dev = s.device
    if large and not s.P:
        raise ValueError("histogram_segment: the larger child's histogram needs a pool")
    if dev.type == "cpu":
        segment_histogram(s, parity, large)
        return
    if dev.type != "cuda":
        raise ValueError("histogram_segment: unsupported device %s" % dev)
    key = "histogram_segment%d%s" % (parity, "_large" if large else "")
    args = s.args.get(key)
    if args is None:
        _check_dtype(s.hist_dtype)
        R, B = s.hist_rows, s.hist_width
        b = s.hist_bins
        cap = MAX_WIDE_BINS if b.dtype == torch.int16 else MAX_BYTE_BINS
        if not 1 <= B <= cap:
            raise ValueError("histogram_segment: num_bins must be in [1, %d], got %d" % (cap, B))
        sms = _sm_count(dev)
        ctl, out = (s.pool_ctl if large else s.ctl), s.hist_out(parity, large)
        args = s.args[key] = (
            b.data_ptr(), b.stride(0), b.stride(1), s.values.data_ptr(), s.order.data_ptr(),
            ctl.data_ptr(), s.leaf_begin.data_ptr(), s.leaf_count.data_ptr(), R, B,
            bin_flags(b, s.hist_dtype), sms, segment_max_chunks(s.N, R, sms),
            out.data_ptr(), s.stream,
        )
    symbol = "lgbt_histogram_segment_grouped" if s.grouped else "lgbt_histogram_segment"
    code = _entry("histogram", symbol, _ARGS_SEGMENT)(*args)
    cuda_build.check(code, "histogram segment kernel")
    launches[_count_key("histogram_segment", args[10])] += 1


def hist_onehot(bins, values, num_bins, rows=None, hist_dtype="float32"):
    """One-hot tiles as the A operand of bf16 tensor-core products
    (csrc/hist_onehot.cu); B <= 256."""
    if bins.device.type == "cpu":
        return leaf_histogram(bins, values, num_bins, rows, hist_dtype)
    return _launch_rows("hist_onehot", "lgbt_hist_onehot", bins, values, num_bins, rows, hist_dtype, 256)


def hist_bitplane(bins, values, num_bins, rows=None, hist_dtype="float32"):
    """Bit-plane factored one-hots, ``bin = hi * lob + lo``, on tensor cores
    (csrc/hist_bitplane.cu); B <= 256."""
    if bins.device.type == "cpu":
        return leaf_histogram(bins, values, num_bins, rows, hist_dtype)
    return _launch_rows("hist_bitplane", "lgbt_hist_bitplane", bins, values, num_bins, rows, hist_dtype, 256)


def _one_wave_grid(n, F, num_sms, group, step, blocks_per_sm, max_chunk):
    """``(groups, chunks, rows_per_block)`` of ``ceil(F / group)`` feature
    groups and chunks of a multiple of ``step`` rows (``step`` to
    ``max_chunk``) aimed at one wave of ``blocks_per_sm`` blocks per SM."""
    groups = -(-F // group)
    slots = max(blocks_per_sm * num_sms // groups, 1)
    want = -(-n // slots)
    rows_per_block = min(max(-(-want // step) * step, step), max_chunk)
    return groups, -(-n // rows_per_block), rows_per_block


# csrc/hist_v1.cu's block: V1_GROUP features x a chunk of rows, staged
# V1_TILE rows a tile (bins at a row stride of V1_BIN_WORDS words), two
# blocks an SM
V1_GROUP = 16
V1_TILE = 512
V1_BIN_WORDS = 5
V1_MAX_CHUNK = 65536
V1_BLOCKS_PER_SM = 2


def v1_grid(n: int, F: int, num_sms: int) -> Tuple[int, int, int]:
    """``(groups, chunks, rows_per_block)`` of csrc/hist_v1.cu for ``n``
    rows of ``F`` features on a card of ``num_sms`` SMs: ``ceil(F / 16)``
    feature groups, and chunks of a multiple of 512 rows (512 to 65536)
    aimed at one wave of two blocks per SM. At F=28 on 132 SMs the 1M root
    gets 2 groups x 131 chunks of 7680 rows, a 100k segment 98 of 1024,
    256 rows one chunk of 512."""
    return _one_wave_grid(n, F, num_sms, V1_GROUP, V1_TILE, V1_BLOCKS_PER_SM, V1_MAX_CHUNK)


def hist_v1(bins, values, num_bins, rows=None, hist_dtype="float32"):
    """``[F, B, 3]`` histogram in a fixed order with no atomics
    (csrc/hist_v1.cu: 16-feature blocks over row chunks of :func:`v1_grid`,
    each feature folded in row order by one warp, the chunks' partials
    summed in order), the independent oracle of :func:`histogram`; not
    routed. Its bits depend on (n, F, B, rows, SM count) only:
    :func:`hist_v1_mirror` gives them on the host. Takes the arguments of
    :func:`histogram`."""
    if bins.device.type == "cpu":
        return leaf_histogram(bins, values, num_bins, rows, hist_dtype)
    n = _rows_n("hist_v1", bins, values, num_bins, rows, hist_dtype, 336)
    F = bins.shape[0]
    shape = (F, num_bins, 3)
    if n == 0 or F == 0:
        return torch.zeros(shape, dtype=torch.float32, device=bins.device)
    _, chunks, rows_per_block = v1_grid(n, F, _sm_count(bins.device))
    # every cell of the output, and of each chunk's partial, is stored
    out = torch.empty(shape, dtype=torch.float32, device=bins.device)
    scratch = torch.empty((chunks,) + shape, dtype=torch.float32, device=bins.device) \
        if chunks > 1 else None
    bf16 = hist_dtype == "bfloat16"
    code = _entry("hist_v1", "lgbt_hist_v1", _ARGS_V1)(
        bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
        rows.data_ptr() if rows is not None else None, n, F, num_bins, int(bf16),
        rows_per_block, scratch.data_ptr() if scratch is not None else None,
        out.data_ptr(), torch.cuda.current_stream(bins.device).cuda_stream,
    )
    cuda_build.check(code, "hist_v1 kernel")
    launches["hist_v1_bf16" if bf16 else "hist_v1"] += 1
    return out


def hist_v1_mirror(bins, values, num_bins, rows=None, hist_dtype="float32", num_sms=132):
    """The bits :func:`hist_v1` gives on a card of ``num_sms`` SMs, computed
    in numpy f32 on the host from ``[F, N]`` u8 bins, ``[N, 3]`` f32 values
    and optional int rows (numpy arrays or CPU tensors).

    The kernel folds each cell of a chunk of :func:`v1_grid` as the plain
    left fold of its rows in the order of ``rows``, from 0 (a bin >= B
    adds nothing), and sums the chunks' partials in order, from 0. So does
    this: ``np.add.at`` adds in index order."""
    bins = np.asarray(bins)
    r = np.arange(bins.shape[1]) if rows is None else np.asarray(rows).astype(np.int64)
    vals = operands(torch.as_tensor(np.asarray(values)), hist_dtype).numpy()[r]
    F, n = bins.shape[0], len(r)
    out = np.zeros((F, num_bins, 3), np.float32)
    if n == 0 or F == 0:
        return out
    _, chunks, rows_per_block = v1_grid(n, F, num_sms)
    b = bins[:, r].T.astype(np.int64)  # [n, F], rows in order
    keep = b < num_bins
    chunk = np.arange(n) // rows_per_block
    cell = (chunk[:, None] * F + np.arange(F)) * num_bins + b
    parts = np.zeros((chunks * F * num_bins, 3), np.float32)
    np.add.at(parts, cell[keep], np.broadcast_to(vals[:, None, :], (n, F, 3))[keep])
    for part in parts.reshape(chunks, F, num_bins, 3):
        out += part
    return out


# csrc/hist_packed4.cu's block: P4_GROUP features x a chunk of rows, taken
# P4_STEP rows (128 threads x 4 rows) a step, with per-thread copies in 96 KB
# of shared memory, so two blocks an SM
P4_GROUP = 4
P4_STEP = 512
P4_MAX_CHUNK = 65536
P4_BLOCKS_PER_SM = 2


def packed4_grid(n: int, F: int, num_sms: int) -> Tuple[int, int, int]:
    """``(groups, chunks, rows_per_block)`` of csrc/hist_packed4.cu for ``n``
    rows of ``F`` features on a card of ``num_sms`` SMs: ``ceil(F / 4)``
    feature groups, and chunks of a multiple of 512 rows (512 to 65536)
    aimed at one wave of two blocks per SM. At F=28 on 132 SMs the 1M root
    gets 7 groups x 37 chunks of 27136 rows, a 100k segment 33 of 3072."""
    return _one_wave_grid(n, F, num_sms, P4_GROUP, P4_STEP, P4_BLOCKS_PER_SM, P4_MAX_CHUNK)


def hist_packed4_rows(bins_packed, values, num_bins, rows=None, hist_dtype="float32"):
    """``[F, B, 3]`` histogram read from nibble-packed bins by row
    (csrc/hist_packed4.cu: per-thread sub-histograms, 4-feature blocks over
    row chunks of :func:`packed4_grid`); B <= 16.

    ``bins_packed`` is an ``[F, ceil(N/2)]`` uint8 view with any strides,
    row 2j in the low and row 2j+1 in the high nibble: the set-up copy of
    :func:`pack_bins` passes as ``bins_p4.t()``. ``values`` is the unpacked
    ``[N, 3]`` f32 matrix; ``rows`` an optional int32 vector of row indices
    into both (a leaf segment, read with no gather and no packing)."""
    if bins_packed.device.type == "cpu":
        return leaf_histogram_packed4_rows(bins_packed, values, num_bins, rows, hist_dtype)
    _check_dtype(hist_dtype)
    _check_bins("hist_packed4", bins_packed, num_bins, 16)
    F, N2 = bins_packed.shape
    if (
        values.device != bins_packed.device
        or values.dtype != torch.float32
        or values.dim() != 2
        or values.shape[1] != 3
        or (values.shape[0] + 1) // 2 != N2
        or not values.is_contiguous()
    ):
        raise ValueError(
            "hist_packed4: values must be a contiguous [N, 3] f32 tensor on the bins' device, "
            "with ceil(N / 2) packed bin columns"
        )
    n = values.shape[0] if rows is None else _rows_count("hist_packed4", rows, bins_packed.device)
    shape = (F, num_bins, 3)
    if n == 0 or F == 0:
        return torch.zeros(shape, dtype=torch.float32, device=bins_packed.device)
    _, chunks, rows_per_block = packed4_grid(n, F, _sm_count(bins_packed.device))
    # one chunk stores every cell; more add into a zeroed output
    alloc = torch.empty if chunks == 1 else torch.zeros
    out = alloc(shape, dtype=torch.float32, device=bins_packed.device)
    bf16 = hist_dtype == "bfloat16"
    code = _entry("hist_packed4", "lgbt_hist_packed4", _ARGS_HIST)(
        bins_packed.data_ptr(), bins_packed.stride(0), bins_packed.stride(1), values.data_ptr(),
        rows.data_ptr() if rows is not None else None, n, F, num_bins, int(bf16),
        rows_per_block, out.data_ptr(), torch.cuda.current_stream(bins_packed.device).cuda_stream,
    )
    cuda_build.check(code, "hist_packed4 kernel")
    launches["hist_packed4" + ("_bf16" if bf16 else "")] += 1
    return out


def hist_packed4(bins_packed, values_packed, num_bins, hist_dtype="float32"):
    """``[F, B, 3]`` histogram of :func:`pack4` output, the JAX kernel's own
    input contract: ``[F, N2]`` u8 and ``[N2, 6]`` f32 values. A contiguous
    ``[N2, 6]`` tensor is the ``[2 N2, 3]`` one :func:`hist_packed4_rows`
    reads (an odd N's padding row has value 0 and adds nothing)."""
    if (
        values_packed.device != bins_packed.device
        or values_packed.dtype != torch.float32
        or values_packed.shape != (bins_packed.shape[1], 6)
        or not values_packed.is_contiguous()
    ):
        raise ValueError("hist_packed4: values must be a contiguous [N2, 6] f32 tensor on the bins' device")
    return hist_packed4_rows(bins_packed, values_packed.view(-1, 3), num_bins, None, hist_dtype)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

MIN_BUCKET_LOG2 = 8  # smallest bucket of the lattice (256 rows)


def bucket_sizes(N: int) -> Tuple[int, ...]:
    """The bucket lattice of an ``N``-row dataset: {2^k} U {3 * 2^(k-1)}
    from 256 rows up, capped at N (the JAX package's default lattice,
    lightgbm_tpu/ops/grow.py ``bucket_sizes``). The tune sweep measures the
    row class of each size. The grower pads no segment, so the JAX
    package's LIGHTGBM_TPU_LATTICE knob has no counterpart here."""
    top = max(int(N - 1).bit_length(), 0)
    sizes = {min(1 << b, N) for b in range(MIN_BUCKET_LOG2, top + 1)}
    sizes |= {min(3 << b, N) for b in range(MIN_BUCKET_LOG2 - 1, top + 1)}
    return tuple(sorted(sizes | {N}))


def rows_bucket(n: int) -> int:
    """Row class of a call: ``n`` rounded up to the lattice family
    {2^k} U {3 * 2^(k-1)} (:func:`bucket_sizes`)."""
    n = max(int(n), 1)
    k = (n - 1).bit_length()
    p = 1 << k
    t = 3 << (k - 2) if k >= 2 else p
    return t if t >= n else p


class HistRoute:
    """Frozen shape-class -> impl table for one training run.

    ``entries`` maps ``(B, K, hist_dtype, rows_bucket)`` to an impl name;
    the object compares and hashes by value. ``digest`` is the content
    digest of the entries, computed as the JAX package computes it."""

    __slots__ = ("entries", "digest", "source", "_map")

    def __init__(self, entries, source: str = "") -> None:
        ent = tuple(sorted(
            ((int(b), int(k), str(d), int(r)), str(impl)) for (b, k, d, r), impl in entries
        ))
        self._map = dict(ent)
        if len(self._map) != len(ent):
            dupes = sorted({k for k, v in ent if self._map[k] != v})
            if dupes:
                raise LightGBMError(
                    "histogram route has conflicting impls for shape class(es) %s: "
                    "merge tables by re-sweeping, not by concatenating entries" % (dupes,)
                )
            ent = tuple(sorted(self._map.items()))
        self.entries = ent
        self.source = str(source)
        self.digest = hashlib.sha256(repr(ent).encode("utf-8")).hexdigest()[:16]

    def pick(self, rows: int, num_bins: int, k: int, hist_dtype: str) -> Optional[str]:
        """Impl for this call shape, or None (the default for the device)."""
        return self._map.get((int(num_bins), int(k), str(hist_dtype), rows_bucket(rows)))

    def __eq__(self, other) -> bool:
        return type(other) is HistRoute and other.entries == self.entries

    def __hash__(self) -> int:
        return hash((HistRoute, self.entries))

    def __repr__(self) -> str:
        return "HistRoute(%d entries, digest=%s%s)" % (
            len(self.entries), self.digest, ", source=%r" % self.source if self.source else "",
        )


def device_family(device: torch.device) -> Optional[str]:
    """The family a tune table is keyed by: ``"cpu"``, or the card's name
    normalised (``"h100"``); None when the card's name is unknown."""
    if device.type == "cpu":
        return "cpu"
    return normalize_device_kind(torch.cuda.get_device_name(device))


def resolve_route(table: Optional[dict], device: torch.device, source: str = "") -> Optional[HistRoute]:
    """Tune table (obs/tune.py schema) -> frozen :class:`HistRoute` for a run
    on ``device``. Keeps only a table of this backend and device family, and
    only entries whose impl serves their shape here; None when nothing
    survives (the run then takes the default)."""
    if not table or not table.get("entries"):
        return None
    backend = device.type
    where = source or "<dict>"
    if table.get("backend") != backend:
        log.warn_once(
            "hist-tune-backend-mismatch",
            "histogram tune table %s was measured on backend=%r but this run is on %r; "
            "ignoring it (default routing applies)" % (where, table.get("backend"), backend),
        )
        return None
    fam = device_family(device)
    tfam = table.get("device_family")
    if tfam and fam and tfam != fam:
        log.warn_once(
            "hist-tune-device-mismatch",
            "histogram tune table %s was measured on device family %r but this run is on %r; "
            "ignoring it" % (where, tfam, fam),
        )
        return None
    if tfam and fam is None and tfam != backend:
        log.warn_once(
            "hist-tune-unknown-device",
            "histogram tune table %s was measured on device family %r but this card's family "
            "is unknown; ignoring it (sweep on this card to route)" % (where, tfam),
        )
        return None
    ents = []
    for e in table["entries"]:
        impl = str(e.get("impl", ""))
        b = int(e["B"])
        if impl not in IMPLS or not impl_supported(impl, b, backend):
            log.warn_once(
                "hist-tune-unsupported:%s:%d" % (impl, b),
                "histogram tune entry (B=%d impl=%r) is not supported on this backend/shape; "
                "dropping it from the route" % (b, impl),
            )
            continue
        ents.append(((b, int(e["K"]), str(e["hist_dtype"]), int(e["rows_bucket"])), impl))
    if not ents:
        return None
    return HistRoute(ents, source=source)


def _note_impl_fallback(requested: str, num_bins: int, backend: str) -> None:
    log.warn_once(
        "hist-impl-fallback:%s:%d:%s" % (requested, num_bins, backend),
        "impl=%r requested (explicitly, via LIGHTGBM_TPU_HIST_IMPL, or a tune-table entry) "
        "but it does not serve num_bins=%d on %s; taking %r"
        % (requested, num_bins, backend, default_impl(backend)),
    )
    REGISTRY.counter(
        "hist_impl_fallback_total",
        "histogram impl requests that fell back to the device's default",
    ).inc(requested=requested)


def pick_impl(
    impl: str,
    rows: int,
    num_bins: int,
    k: int,
    hist_dtype: str,
    route: Optional[HistRoute],
    backend: str,
) -> str:
    """The impl a call of ``rows`` rows at (``num_bins``, ``k``,
    ``hist_dtype``) on ``backend`` takes: explicit ``impl`` > the env
    override > ``route`` > :func:`default_impl`; one the capability table
    refuses warns once, counts, and takes the default."""
    chosen, refused = resolve_impl(impl, rows, num_bins, k, hist_dtype, route, backend)
    if refused is not None:
        _note_impl_fallback(refused, num_bins, backend)
    return chosen


def resolve_impl(
    impl: str,
    rows: int,
    num_bins: int,
    k: int,
    hist_dtype: str,
    route: Optional[HistRoute],
    backend: str,
) -> Tuple[str, Optional[str]]:
    """:func:`pick_impl`'s choice with no warning and no count: (the impl
    taken, the refused impl it replaced or None)."""
    if impl == "auto" and _ENV_IMPL:
        impl = _ENV_IMPL
    if impl == "auto" and route is not None:
        impl = route.pick(rows, num_bins, k, hist_dtype) or "auto"
    if impl == "auto":
        impl = default_impl(backend)
    if impl not in IMPLS:
        raise ValueError("impl must be 'auto' or one of %s, got %r" % (IMPLS, impl))
    if not impl_supported(impl, num_bins, backend, ignore_backend=impl != "scatter"):
        return default_impl(backend), impl
    return impl, None


def routed_histogram(
    bins: torch.Tensor,
    values: torch.Tensor,
    num_bins: int,
    rows: Optional[torch.Tensor] = None,
    impl: str = "auto",
    hist_dtype: str = "float32",
    route: Optional[HistRoute] = None,
    bins_packed: Optional[torch.Tensor] = None,
    grouped: bool = False,
) -> torch.Tensor:
    """``[F, B, 3]`` histogram through the impl this call routes to
    (:func:`pick_impl`). ``scatter`` ignores ``hist_dtype``, as the JAX
    package's scatter does; every kernel honours it. ``bins_packed``, the
    ``[F, N2]`` view of a :func:`pack_bins` copy of ``bins``, is what
    ``cuda_packed4`` reads by row; without it that impl gathers the segment
    and packs it on every call. ``grouped`` goes to ``cuda``
    (:func:`histogram`)."""
    n = bins.shape[1] if rows is None else rows.numel()
    impl = pick_impl(impl, n, num_bins, values.shape[1], hist_dtype, route, bins.device.type)
    if impl == "scatter":
        return leaf_histogram(bins, values, num_bins, rows)
    if impl == "cuda":
        return histogram(bins, values, num_bins, rows, hist_dtype, grouped=grouped)
    if impl == "cuda_onehot":
        return hist_onehot(bins, values, num_bins, rows, hist_dtype)
    if impl == "cuda_bitplane":
        return hist_bitplane(bins, values, num_bins, rows, hist_dtype)
    if bins_packed is not None:
        return hist_packed4_rows(bins_packed, values, num_bins, rows, hist_dtype)
    if rows is not None:
        idx = rows.long()
        bins = bins.index_select(1, idx)
        values = values.index_select(0, idx)
    bins_p, vals_p = pack4(bins, values)
    return hist_packed4(bins_p, vals_p, num_bins, hist_dtype)
