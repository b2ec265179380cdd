"""SpMV execution plans (counterpart of
``spmv_vector_cache_tpu/formats/plan.py``).

The plan builders are the JAX package's host-side numpy code, carried
over unchanged so that both packages build byte-equal plans for the same
matrix; the port's kernels are checked against the reference on
identical layouts.  Every plan family the reference planner builds
(SELL, DIA, Hybrid, Chunk, Packed, Cached, CooTail) is ported for
float32, bfloat16, float16, int8, uint8, int16, uint16, int32, uint32,
int64 (stored as int32) and uint64 (stored as uint32) values
(:func:`value_kind`), and the double (``value_dtype=np.float64``) SELL,
DIA and Hybrid plans, whose values are hi/lo float32 pairs.

The layout is a **sliced-ELLPACK (SELL) tile plan** over CSR:

* rows are bound to *lanes* — 128 consecutive (sub)rows form a *slice*,
  and a slice's nonzeros are stored as (8, 128) value/column tiles whose
  sublane axis holds successive nonzero positions of each row.  The row
  reduction is a sublane-axis sum, so the scatter disappears (the
  RAW-hazard interlocks of ``InterleavedReduce.scala:51-57`` and
  ``SpMVFrontendNBCache.scala:26-77`` have no analog to pay for);
* long rows *split* into bounded sub-rows (the load-balance fix the
  reference probes with its ``row64k`` matrix and
  ``permuteLongestRowFirst``, ``matrixutils.py:148-158``);
* sub-rows may be length-sorted within ``sigma`` windows (SELL-sigma) so
  slices hold similar-length rows and padding stays small;
* optionally, rows split at **column-stripe** boundaries so every tile's
  column span is bounded — this is what makes the windowed-x kernel
  (the vector-cache analog) applicable to matrices without natural
  bandwidth; the merge back to y is one segment-sum (the same fixup that
  serves split/sigma).

The irregular access that remains is the *gather* of x[col] — the exact
dual of the reference's y problem (CSC makes x sequential and y scattered;
CSR makes y sequential and x gathered).  TPU hardware can gather only
within a 128-lane window, so the plan computes, per 8-tile kernel step, a
**window base** ``wb`` such that every column the step touches lies in
``[wb*128, wb*128 + K*128)``; K (``window_blocks``) is the static loop
count the kernel pays.  Feasibility and the required K come straight from
the layout — the TPU port of the reference's ``maxColSpan`` analysis
(``SparseMatrix.cpp:110-119``) deciding buffer strategy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .containers import COO, CSC, CSR
from .convert import coo_to_csr, csc_to_csr
from .tables import WorkList, sell_work, table, table_names, with_tables

Array = Any  # numpy array on the host, torch.Tensor once placed

#: x blocks up to which the reference picks its 'resident' SELL strategy
#: for a window-infeasible plan (``spmv_pallas.RESIDENT_MAX_BLOCKS``, a
#: v5e-measured cap kept so that the port picks the reference's plans)
RESIDENT_MAX_BLOCKS = 64
#: the reference's 'deep' strategy cap (``spmv_pallas.DEEP_MAX_BLOCKS``)
DEEP_MAX_BLOCKS = 2048


#: value kinds the plan builders take, by the numpy name of the
#: ``value_dtype`` asked for: float32, float64 (stored as hi/lo float32
#: pairs), bfloat16 and float16 (summed in float32), int32 and uint32
#: (summed exactly, wrapping mod 2^32), int8, uint8, int16 and uint16
#: (stored in their own width, summed in 32 bits, y narrowed once);
#: int64 and uint64 values are stored as int32 and uint32, as the
#: reference's device plan holds them (``to_device`` with x64 off), after
#: a range check the reference does not make (ROADMAP.md queue 3)
_KINDS = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
          "float16": "f16", "int8": "i8", "uint8": "u8", "int16": "i16",
          "uint16": "u16", "int32": "i32", "int64": "i32", "uint32": "u32",
          "uint64": "u32"}
#: the numpy type a builder lays each kind's values out in: bf16 values
#: are rounded to bfloat16 (nearest even) and held exactly in float32
#: until :func:`finish_values` makes them a bfloat16 tensor (numpy has
#: no bfloat16 without ``ml_dtypes``, which the port does not import)
_BUILD = {"f32": np.float32, "f64": np.float64, "bf16": np.float32,
          "f16": np.float16, "i8": np.int8, "u8": np.uint8, "i16": np.int16,
          "u16": np.uint16, "i32": np.int32, "u32": np.uint32}
#: the 64-bit integer types, stored in 32 bits after a range check
_NARROWED = {"int64": np.int32, "uint64": np.uint32}
#: why the types the reference half-takes are refused, by name prefix
_REFUSED = {
    "bool": "the reference's DIA plan returns a wrong y for bool values "
            "and its SELL window plan raises",
    "float8": "the reference sums float8 in float8, off by several units "
              "on small integer draws",
    "complex": "the reference raises NotImplementedError for complex "
               "values",
}


def _dtype_name(value_dtype) -> str:
    """The numpy name of ``value_dtype``: a numpy type or name, a torch
    dtype, or any object numpy reads as a dtype (``jnp.bfloat16`` where
    ``ml_dtypes`` is loaded); "bfloat16" is never handed to numpy."""
    if isinstance(value_dtype, torch.dtype):
        return str(value_dtype).rsplit(".", 1)[-1]
    if isinstance(value_dtype, str) and value_dtype == "bfloat16":
        return value_dtype
    return np.dtype(value_dtype).name


def value_kind(value_dtype) -> str:
    """The kind of plan ``value_dtype`` builds: ``f32``, ``f64``,
    ``bf16``, ``f16``, ``i8``, ``u8``, ``i16``, ``u16``, ``i32`` (int32
    or int64) or ``u32`` (uint32 or uint64).  Every builder calls it; any
    other type (bool, float8, complex, ...) raises
    ``NotImplementedError`` with the reason."""
    name = _dtype_name(value_dtype)
    if name not in _KINDS:
        why = next((w for p, w in _REFUSED.items() if name.startswith(p)),
                   "the reference has no plan of that type")
        raise NotImplementedError(
            f"value_dtype {name}: {why} (ROADMAP.md queue 3); the port "
            f"builds float32, float64, bfloat16, float16, int8, uint8, "
            f"int16, uint16, int32, uint32, int64 and uint64 plans")
    return _KINDS[name]


def build_dtype(value_dtype):
    """The numpy type a builder lays ``value_dtype``'s values out in."""
    return _BUILD[value_kind(value_dtype)]


def host_values(data, value_dtype) -> np.ndarray:
    """``data`` as a builder stores it for ``value_dtype``, value by
    value what the reference's ``astype(value_dtype)`` stores: bfloat16
    rounded to nearest even (held in float32), float16 rounded once,
    straight from ``data``'s type (numpy's cast, the reference's), the
    other integers as numpy casts; int64 and uint64 as int32 and uint32,
    refused when a value does not fit (the reference narrows it on the
    device and wraps it silently)."""
    name = _dtype_name(value_dtype)
    kind = value_kind(value_dtype)
    d = np.asarray(data)
    if kind == "bf16":
        t = torch.from_numpy(np.ascontiguousarray(d))
        return t.to(torch.bfloat16).to(torch.float32).numpy()
    if name in _NARROWED:
        d = d.astype(name)
        info = np.iinfo(_NARROWED[name])
        if d.size and (d.min() < info.min or d.max() > info.max):
            bad = d[(d < info.min) | (d > info.max)][0]
            raise ValueError(
                f"{name} value {bad} does not fit {info.dtype}: {name} "
                f"plans are stored as {info.dtype} (the reference wraps "
                f"such a value silently, ROADMAP.md queue 3)")
    return d.astype(_BUILD[kind])


def finish_values(arr, value_dtype):
    """A builder's value array as the plan holds it on the host: a CPU
    ``torch.bfloat16`` tensor for a bf16 plan (exact: the values were
    rounded by :func:`host_values`), else the numpy array itself."""
    if value_kind(value_dtype) == "bf16":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)
    return arr


def host_numpy(v) -> np.ndarray:
    """A value array of a host or placed plan as numpy: a bfloat16
    tensor as float32 (exact), any other tensor copied to the host."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def check_pad(value_dtype, pad_value: float) -> None:
    """Integer plans take only the semirings whose zero is finite
    (plus_times, max_times, or_and): the reference casts min_plus's +inf
    and max_plus's -inf to INT_MIN and returns a y off by 2^31
    (ROADMAP.md queue 3)."""
    if np.dtype(build_dtype(value_dtype)).kind in "iu" and \
            not np.isfinite(pad_value):
        raise ValueError(
            f"an integer plan has no {pad_value} for its padding: integer "
            f"plans run plus_times, max_times and or_and only (the "
            f"reference casts the infinite zero of min_plus and max_plus "
            f"to INT_MIN, ROADMAP.md queue 3)")


def map_arrays(plan, fn, finish=None):
    """The plan with ``fn`` applied to every numpy-array or tensor field,
    nested plans included (a HybridPlan's parts, a ChunkPlan's bucket
    tuples and residue, a CachedPlan's hot and cold tiers; a field that
    is None stays None), and its tables (``formats/tables.py``) None:
    they were built from the old arrays.  ``finish``, if given, maps
    each plan, nested ones first, once its arrays are mapped (a
    ChunkPlan's buckets only as a bucket tuple: they are not applied
    alone)."""
    tables = table_names(plan)
    changes = dict.fromkeys(tables)
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name in tables:
            continue
        if isinstance(v, (np.ndarray, torch.Tensor)):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = map_arrays(v, fn, finish)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            inner = None if f.metadata.get("bare") else finish
            changes[f.name] = tuple(map_arrays(p, fn, inner) for p in v)
    plan = dataclasses.replace(plan, **changes)
    return finish(plan) if finish else plan


def _to_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    # a read-only array (one read out of a JAX array) is copied: torch
    # tensors are writable
    v = np.ascontiguousarray(v) if v.flags.writeable else v.copy()
    return torch.from_numpy(v).to(device)


def place(plan, device):
    """The plan with every array field as a torch tensor on ``device``
    (nested plans included) — done once, by ``SparseOperator``.  The
    per-plan work of the kernels is done here, once: a ChunkPlan's
    ``perm_idx`` is checked for kernel C, which reads it unchecked on
    every apply, and every plan's tables are built into its fields
    (``formats/tables.py``): the work list of kernels G, H and L of
    every SellPlan in it, a ChunkPlan's light records and heavy slab, a
    PackedPlan's list for kernel F, a TriSolvePlan's sweep."""
    from .chunk import ChunkPlan, check_perm_idx

    if isinstance(plan, ChunkPlan):
        check_perm_idx(plan.perm_idx)
    return map_arrays(plan, lambda v: _to_tensor(v, device), with_tables)


#: tiles per kernel grid step (output block sublane alignment requires 8)
TILES_PER_STEP = 8

#: default tiles sharing one x-window base (overridable per plan via
#: ``window_group_tiles``).  Finer granularity shrinks each window's
#: column span; must divide TILES_PER_STEP.  Kernels concatenate
#: ``8 / group_tiles`` group results per 8-sublane output store.
WINDOW_GROUP_TILES = 4


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Layout-quality counters — the plan-time half of the observability
    story (the runtime half lives in ``utils/stats.py``)."""

    nnz: int
    num_tiles: int          # padded to TILES_PER_STEP
    num_slices: int
    num_subrows: int
    num_splits: int
    num_stripes: int        # column stripes (1 = no striping)
    padded_slots: int
    fill: float             # nnz / (num_tiles * P * R)
    window_blocks: int      # K required by the windowed kernel (0 = infeasible)
    max_window_base: int    # max of window_base (static x padding bound)
    groups_per_step: int    # 8-tile window groups fused per kernel grid step
    pad_value: float = 0.0  # value of padding slots (the semiring's zero)
    uniform_tiles_per_slice: int = 0  # u if every slice spans exactly u
    # tiles and u | 8 (enables the in-kernel slice reduction); 0 otherwise
    group_tiles: int = WINDOW_GROUP_TILES  # tiles per x-window group (wg)
    #: p when every row has exactly p sub-rows in natural (row-major)
    #: order — the epilogue then folds y with one reshape+reduce instead
    #: of a scattered segment sum; 0 otherwise
    uniform_parts: int = 0
    #: all tiles of each wg-group share one slice: the kernel may reduce
    #: whole groups to single output rows (in-kernel slice fold)
    group_fold: bool = False
    #: group g *is* slice g for g < num_slices (uniform tiling): kernel
    #: group rows are y2d directly, no tile segment-sum at all
    group_slice_identity: bool = False
    #: double-float layout: vals is f32 (T, 2*positions, R) with value
    #: highs in [:, :P] and lows in [:, P:] (hi + lo == the f64 value);
    #: cols and cols_win stay (T, P, R)
    double: bool = False
    #: lane granularity of ``window_base`` (128, 64, or 32).  Finer grain
    #: lets a window start mid-block, shaving a whole 128-lane block off
    #: K when group spans straddle block boundaries (a span of 90 needs
    #: K=2 at grain 128 but K=1 at grain 32); the xw prologue gathers
    #: from a (128/grain)-way overlapped x image to pay for it
    window_grain: int = 128

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SellPlan:
    """Tiled SELL layout of one sparse matrix, ready for the kernels.

    ``vals``/``cols``: (T, P, R) — tile t covers R=128 sub-rows (lane axis)
    of slice ``tile_slice[t]`` and P=8 successive nonzero positions of each
    (sublane axis); padding slots carry (0, column 0).  ``tile_slice`` is
    nondecreasing.  ``window_base``: (T/WINDOW_GROUP_TILES,) per-group x
    window base in 128-lane blocks (only meaningful when
    ``stats.window_blocks > 0``).
    ``row_map`` sends sub-row slots back to original rows for the
    split/sigma/stripe fixup; ``identity_map`` means y is simply the first
    ``rows`` entries of the flat sub-row vector.
    """

    vals: Array          # (T, P, R) value dtype
    cols: Array          # (T, P, R) int32 global column ids
    cols_win: Array      # (T, P, R) int16 in-window offsets (empty if K == 0)
    tile_slice: Array    # (T,) int32, nondecreasing
    window_base: Array   # (T/group_tiles,) int32 x window base
    row_map: Array       # (num_slices * R,) int32 → original row, `rows` = pad
    #: (T/group_tiles * K,) int32 x-image row ids of the reference's xw
    #: gather; kept for byte-equal plans (the CUDA kernel reads x
    #: directly at ``window_base * window_grain + cols_win``)
    window_rows: Array
    shape: Tuple[int, int]
    lane_rows: int       # R
    positions: int       # P
    identity_map: bool
    stats: PlanStats
    #: kernels G, H and L's work list, built by placement
    work: Optional[WorkList] = table(sell_work)

    @property
    def num_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_slices(self) -> int:
        return int(self.row_map.shape[0]) // self.lane_rows


def _as_csr(a) -> CSR:
    if isinstance(a, CSC):
        a = csc_to_csr(a)
    elif isinstance(a, COO):
        a = coo_to_csr(a)
    elif not isinstance(a, CSR):
        raise TypeError(f"cannot plan over {type(a)}")
    return _ensure_sorted(a)


def _ensure_sorted(a: CSR) -> CSR:
    """Planning (striping, window spans, DIA detection) assumes
    column-sorted rows; sort lazily when a hand-built CSR is not."""
    indices = np.asarray(a.indices)
    if indices.size < 2:
        return a
    indptr = np.asarray(a.indptr, dtype=np.int64)
    # a column may fall only where a row starts
    falls = indices[1:] < indices[:-1]
    starts = indptr[1:-1]
    falls[starts[(starts > 0) & (starts < indices.size)] - 1] = False
    if not falls.any():
        return a
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     np.diff(indptr))
    order = np.lexsort((indices, rows))
    return CSR(data=np.asarray(a.data)[order], indices=indices[order],
               indptr=a.indptr, shape=a.shape)


def _cdiv(a, b):
    return -(-a // b)


def _round_up(n, m):
    return _cdiv(n, m) * m


def compute_cols_win(live: np.ndarray, cols: np.ndarray,
                     window_base: np.ndarray, window_blocks: int,
                     group_tiles: int = WINDOW_GROUP_TILES,
                     window_grain: int = 128) -> np.ndarray:
    """In-window column offsets, the windowed kernel's streamed index form.

    Live slots (``live`` mask; ``vals != 0`` for plus-times plans) become
    ``col - window_base[group]*128`` — by construction in
    ``[0, window_blocks*128)``, so they fit int16 and the kernel streams
    half the index bytes of the global int32 ``cols`` (the cols channel is
    one of the two hot DMA streams, cf. the reference's per-channel burst
    sizing, ``spmv-common.scala:26-29``).  Padding slots are forced to
    offset 0 (their value is the semiring zero, so the gathered lane never
    contributes).  Returns an empty (0, P, R) array when the windowed
    kernel is infeasible (``window_blocks == 0``).
    """
    T, P, R = cols.shape
    if not window_blocks or not T:
        return np.zeros((0, P, R), np.int16)
    wb_tile = np.repeat(np.asarray(window_base, np.int64), group_tiles)
    off = cols.astype(np.int64) - (wb_tile * window_grain)[:, None, None]
    off = np.where(live != 0, off, 0)
    return off.astype(np.int16)


def window_image_blocks(num_cols: int, max_window_base: int,
                        window_blocks: int, window_grain: int = 128) -> int:
    """Rows (in 128-lane blocks) of the canonical x image the window
    kernels gather from; shared by the plan-time ``window_rows``
    precompute and the runtime prologue so the two always agree."""
    return max(_cdiv(num_cols, 128),
               _cdiv(max_window_base * window_grain +
                     window_blocks * 128, 128)) + 1


def compute_window_rows(window_base: np.ndarray, window_blocks: int,
                        num_cols: int,
                        window_grain: int = 128) -> np.ndarray:
    """Precomputed x-image row ids for the window kernel's xw gather (see
    SellPlan.window_rows); must mirror the runtime's x image geometry
    (``spmv_pallas._spmv_window``).  At grain g < 128 the image is
    (128/g)-way overlapped — its row j covers elements
    [g*j, g*j + 128) — and a window's k-th block is row
    ``wb + (128/g)*k``."""
    if not window_blocks:
        return np.zeros((0,), np.int32)
    wb = np.asarray(window_base, np.int64)
    f = 128 // window_grain
    nb = window_image_blocks(num_cols, int(wb.max(initial=0)),
                             window_blocks, window_grain)
    wr = wb[:, None] + f * np.arange(window_blocks, dtype=np.int64)[None, :]
    return np.clip(wr, 0, f * nb - 1).astype(np.int32).reshape(-1)


def _check_sell_args(value_dtype, pad_value, positions, window_group_tiles,
                     split, stripe_width, uniform_split) -> Tuple[int, bool]:
    """(window group tiles, double) of a SELL plan's arguments, or the
    ``ValueError`` that :func:`build_sell_plan` raises for them."""
    wg = window_group_tiles if window_group_tiles is not None \
        else WINDOW_GROUP_TILES
    if TILES_PER_STEP % wg:
        raise ValueError(f"window_group_tiles ({wg}) must divide "
                         f"TILES_PER_STEP ({TILES_PER_STEP})")
    if uniform_split and (split is None or stripe_width is not None):
        raise ValueError("uniform_split requires split= and no striping")
    double = value_kind(value_dtype) == "f64"
    check_pad(value_dtype, pad_value)
    if double and pad_value != 0.0:
        raise ValueError("double-float plans support plus_times only "
                         "(pad_value must be 0)")
    if double and positions & (positions - 1):
        raise ValueError(
            f"double-float plans need a power-of-two positions (got "
            f"{positions}): the reference's compensated pairwise reduction "
            f"halves the sublane axis")
    return wg, double


@dataclasses.dataclass(frozen=True)
class _SellRows:
    """A SELL plan's sub-rows in lane order and its tiles
    (:func:`_sell_rows`): what :func:`build_sell_plan` fills with values
    and :func:`sell_plan_stats` prices."""

    o_start: np.ndarray        # each sub-row, in plan order: first entry,
    o_len: np.ndarray          # length
    o_row: np.ndarray          # and source row
    slot_src: np.ndarray       # the sub-row of each lane slot, -1 if pad
    slot_valid: np.ndarray     # (num_slices * R,) slots holding a sub-row
    ntiles: np.ndarray         # tiles of each slice, stripes padded to B
    tile_base: np.ndarray      # first tile of each slice, then the total
    num_subrows: int
    num_splits: int
    num_stripes: int
    uniform_parts: int
    sorted_applied: bool

    @property
    def num_slices(self) -> int:
        return int(self.ntiles.shape[0])

    @property
    def num_tiles(self) -> int:
        return int(self.tile_base[-1])

    @property
    def identity_map(self) -> bool:
        return not self.sorted_applied and self.num_splits == 0 and \
            self.num_stripes == 1

    def tile_slice(self, T: int) -> np.ndarray:
        """Each of ``T`` tiles' slice, the grid step's pad tiles in the
        last slice."""
        ts = np.repeat(np.arange(self.num_slices, dtype=np.int32),
                       self.ntiles)
        return np.concatenate(
            [ts, np.full(T - ts.shape[0], self.num_slices - 1, np.int32)])


def _sell_rows(csr: CSR, R: int, P: int, sigma, split, stripe_width,
               uniform_split: bool) -> _SellRows:
    """Steps 1-3 of :func:`build_sell_plan`: the rows cut into (row
    [, stripe]) [, split] sub-rows, ordered stripe-major and then by the
    sigma length sort, laid into slices of ``R`` lanes, and each slice's
    tile count."""
    rows = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    B = TILES_PER_STEP

    # --- 1. sub-row pieces: (row [, stripe]) [, split] ---------------------
    if stripe_width is not None and nnz:
        indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
        nz_row = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
        nz_stripe = indices // stripe_width
        # piece boundary where row or stripe changes (cols sorted per row)
        key_change = np.ones(nnz, dtype=bool)
        key_change[1:] = (nz_row[1:] != nz_row[:-1]) | \
                         (nz_stripe[1:] != nz_stripe[:-1])
        piece_start = np.flatnonzero(key_change).astype(np.int64)
        piece_len = np.diff(np.concatenate([piece_start, [nnz]]))
        piece_row = nz_row[piece_start]
        piece_stripe = nz_stripe[piece_start]
        num_stripes = int(nz_stripe.max()) + 1 if nnz else 1
    else:
        piece_start = indptr[:-1].copy()
        piece_len = np.diff(indptr)
        piece_row = np.arange(rows, dtype=np.int64)
        piece_stripe = np.zeros(rows, dtype=np.int64)
        num_stripes = 1

    uniform_parts = 0
    if split is not None and piece_len.size and \
            (piece_len.max() > split or uniform_split):
        if uniform_split:
            # every row gets exactly p sub-rows (trailing ones possibly
            # empty): slices then tile a fixed rows-per-slice block and
            # the y fixup is one reshape+reduce (see stats.uniform_parts)
            p_parts = max(1, int(_cdiv(int(piece_len.max()), split)))
            if p_parts > R:
                # part-major lane placement needs rows_per_slice = R // p
                # >= 1; more parts than lanes cannot be laid out
                raise ValueError(
                    f"uniform_split: max row length {int(piece_len.max())} "
                    f"needs {p_parts} sub-rows of {split} nnz, more than "
                    f"lane_rows={R}; raise split or use plain split=")
            pieces = np.full(piece_row.shape[0], p_parts, dtype=np.int64)
        else:
            pieces = np.maximum(1, _cdiv(piece_len, split))
        rep = np.repeat(np.arange(piece_row.shape[0], dtype=np.int64), pieces)
        within = np.arange(rep.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(pieces) - pieces, pieces)
        sub_start = np.minimum(piece_start[rep] + within * split,
                               piece_start[rep] + piece_len[rep])
        sub_len = np.clip(piece_len[rep] - within * split, 0, split)
        sub_row = piece_row[rep]
        sub_stripe = piece_stripe[rep]
        num_splits = int((pieces > 1).sum())
        if uniform_split and p_parts > 1 and sigma is None:
            uniform_parts = p_parts
    else:
        sub_start, sub_len = piece_start, piece_len
        sub_row, sub_stripe = piece_row, piece_stripe
        num_splits = 0
    num_subrows = int(sub_row.shape[0])

    # --- 2. ordering: stripe-major, then sigma length sort ------------------
    sorted_applied = False
    if num_subrows:
        if sigma is not None and num_subrows > 1:
            # order by (stripe asc, length desc) within sigma windows of the
            # stripe-sorted sequence
            stripe_order = np.argsort(sub_stripe, kind="stable")
            order = stripe_order.copy()
            lens_s = sub_len[stripe_order]
            stripes_s = sub_stripe[stripe_order]
            max_len = int(sub_len.max()) if sub_len.size else 0
            for w0 in range(0, num_subrows, sigma):
                w1 = min(w0 + sigma, num_subrows)
                # keep stripes contiguous: sort key = (stripe asc, len desc)
                key = stripes_s[w0:w1].astype(np.int64) * (max_len + 1) \
                    - lens_s[w0:w1]
                seg = np.argsort(key, kind="stable")
                order[w0:w1] = stripe_order[w0:w1][seg]
            sorted_applied = True
        elif num_stripes > 1:
            order = np.argsort(sub_stripe, kind="stable")
            sorted_applied = bool((order != np.arange(num_subrows)).any())
        else:
            order = np.arange(num_subrows, dtype=np.int64)
    else:
        order = np.zeros(0, dtype=np.int64)

    o_len = sub_len[order]
    o_start = sub_start[order]
    o_row = sub_row[order]
    o_stripe = sub_stripe[order]

    # pad sub-row sequence so slices are stripe-pure (stripe changes only at
    # slice boundaries)
    if num_stripes > 1 and num_subrows:
        keep_parts = []
        for s in range(num_stripes):
            idx = np.flatnonzero(o_stripe == s)
            if idx.size == 0:
                continue
            keep_parts.append(idx)
            pad = (-idx.size) % R
            if pad:
                keep_parts.append(np.full(pad, -1, dtype=np.int64))
        slot_src = np.concatenate(keep_parts)
    elif uniform_parts and num_subrows:
        # part-major within each slice: a slice covers rows_per_slice =
        # R // p consecutive rows, with part j of row r at lane
        # j*rows_per_slice + (r % rows_per_slice).  The y fixup is then a
        # contiguous-lane fold of y2d — NOT a (rows, p) reshape, which
        # relayouts the whole vector on a TPU
        p_u = uniform_parts
        rps_u = R // p_u
        n_slices_u = _cdiv(rows, rps_u)
        slot_src = np.full(n_slices_u * R, -1, dtype=np.int64)
        k = np.arange(num_subrows, dtype=np.int64)
        k_row = k // p_u
        dest = (k_row // rps_u) * R + (k % p_u) * rps_u + (k_row % rps_u)
        slot_src[dest] = k
    else:
        slot_src = np.arange(num_subrows, dtype=np.int64)

    num_slots = slot_src.shape[0]
    num_slices = max(1, _cdiv(num_slots, R))
    padded_slots_rows = num_slices * R

    slot_len = np.zeros(padded_slots_rows, dtype=np.int64)
    slot_valid = np.zeros(padded_slots_rows, dtype=bool)
    slot_valid[:num_slots] = slot_src >= 0
    slot_len[:num_slots][slot_src >= 0] = o_len[slot_src[slot_src >= 0]]

    # --- 3. slices and tile allocation -------------------------------------
    slice_len = slot_len.reshape(num_slices, R).max(axis=1)
    ntiles = np.maximum(1, _cdiv(slice_len, P))
    if uniform_parts:
        # uniform tiling: every slice gets the same ceil(split/P) tiles so
        # window groups align 1:1 with slices (group_slice_identity)
        ntiles = np.full(num_slices, max(1, _cdiv(split, P)), np.int64)

    # stripe of each slice (slices are stripe-pure by construction; empty
    # slices inherit the previous stripe so contiguity is preserved)
    slice_stripe = np.zeros(num_slices, dtype=np.int64)
    if num_stripes > 1 and num_slots:
        slot_stripe = np.full(padded_slots_rows, -1, dtype=np.int64)
        slot_stripe[:num_slots][slot_src >= 0] = \
            o_stripe[slot_src[slot_src >= 0]]
        for s in range(num_slices):
            seg = slot_stripe[s * R:(s + 1) * R]
            valid = seg[seg >= 0]
            slice_stripe[s] = valid[0] if valid.size else \
                (slice_stripe[s - 1] if s else 0)

    # pad each stripe's tile count to a multiple of B so no kernel step
    # straddles stripes (a step shares one x window across its B tiles);
    # pad tiles attach to the stripe's last slice and hold only zeros
    ntiles_padded = ntiles.copy()
    if num_stripes > 1:
        for stripe_val in np.unique(slice_stripe):
            sel = np.flatnonzero(slice_stripe == stripe_val)
            total = int(ntiles_padded[sel].sum())
            pad = (-total) % B
            if pad:
                ntiles_padded[sel[-1]] += pad
    else:
        total = int(ntiles_padded.sum())
        pad = (-total) % B
        if pad:
            ntiles_padded[-1] += pad
    tile_base = np.concatenate(([0], np.cumsum(ntiles_padded)))
    return _SellRows(o_start=o_start, o_len=o_len, o_row=o_row,
                     slot_src=slot_src, slot_valid=slot_valid,
                     ntiles=ntiles_padded, tile_base=tile_base,
                     num_subrows=num_subrows, num_splits=num_splits,
                     num_stripes=num_stripes, uniform_parts=uniform_parts,
                     sorted_applied=sorted_applied)


def _window_bases(cmin, cmax, T: int, window_grain, max_window_blocks: int):
    """(K, grain, each window group's base) from the groups' smallest and
    largest stored column (``cmax`` -1 for a group of padding)."""
    any_valid = cmax >= 0
    # evaluate window-base granularities finest-first and keep the
    # COARSEST grain achieving the minimal K: a span of 90 straddling a
    # block boundary needs K=2 at grain 128 but K=1 at grain <= 32 — one
    # fewer gather+select per value vreg in the kernel, paid for by a
    # (128/grain)-way overlapped x image in the xw prologue
    grains = (128,) if not T else (
        (window_grain,) if window_grain else (32, 64, 128))
    best = None                            # (K, -grain, grain, wb)
    for g in grains:
        wbg = np.where(any_valid, cmin, 0) // g
        span = np.where(any_valid,
                        (cmax - wbg * g) // 128 + 1, 1)
        kg = int(span.max()) if T else 1
        cand = (kg, -g, g, wbg)
        if best is None or cand[:2] < best[:2]:
            best = cand
    window_blocks, _, grain, wb = best
    if window_blocks > max_window_blocks:
        window_blocks = 0                  # windowed kernel infeasible
        grain = 128
        wb = np.where(any_valid, cmin, 0) // 128
    return window_blocks, grain, wb


def _groups_per_step(window_blocks: int, groups_per_step, wg: int) -> int:
    """Window groups of 8 tiles in one kernel grid step."""
    if groups_per_step is not None:
        # round up to a multiple of the window-group size: the kernels'
        # in-place slice fold needs NG = 8*groups/wg divisible by 8
        # (i.e. groups % wg == 0) — a non-multiple would silently demote
        # to per-tile output
        return _cdiv(max(1, groups_per_step), wg) * wg
    return 64 if window_blocks else 8


def _sell_stats(sr: _SellRows, nnz: int, T: int, P: int, R: int,
                tile_slice, wg: int, window_blocks: int,
                max_window_base: int, groups: int, pad_value: float,
                double: bool, grain: int) -> PlanStats:
    """The :class:`PlanStats` of a SELL plan of ``T`` tiles, the grid
    step's padding included."""
    # fold structure: may the kernel reduce whole wg-groups to one row?
    ts_g = tile_slice.reshape(-1, wg)
    group_fold = bool(T) and bool((ts_g == ts_g[:, :1]).all())
    group_slice_identity = group_fold and sr.num_stripes == 1 and \
        bool(np.all(sr.ntiles == wg))
    return PlanStats(
        nnz=nnz, num_tiles=T, num_slices=sr.num_slices,
        num_subrows=sr.num_subrows, num_splits=sr.num_splits,
        num_stripes=sr.num_stripes,
        padded_slots=T * P * R - nnz,
        fill=float(nnz) / float(T * P * R) if T else 0.0,
        window_blocks=window_blocks, max_window_base=max_window_base,
        groups_per_step=groups, pad_value=float(pad_value),
        group_tiles=wg, uniform_parts=sr.uniform_parts,
        group_fold=group_fold, group_slice_identity=group_slice_identity,
        double=double, window_grain=grain)


def build_sell_plan(a, *, lane_rows: int = 128, positions: int = 8,
                    sigma: Optional[int] = None,
                    split: Optional[int] = None,
                    stripe_width: Optional[int] = None,
                    max_window_blocks: int = 16,
                    groups_per_step: Optional[int] = None,
                    value_dtype=np.float32,
                    pad_value: float = 0.0,
                    window_group_tiles: Optional[int] = None,
                    uniform_split: bool = False,
                    window_grain: Optional[int] = None) -> SellPlan:
    """Build a SELL tile plan from any container (host-side, numpy).

    ``split``: max nonzeros per sub-row (None = no splitting).
    ``sigma``: window (in sub-rows) for descending length sort.
    ``stripe_width``: split rows at column boundaries of this width so the
    windowed kernel applies to locality-poor matrices (None = off).
    ``max_window_blocks``: cap on K; if a layout needs more, the plan is
    marked window-infeasible (``stats.window_blocks == 0``).
    ``groups_per_step``: override the kernel grid-step width (in 8-tile
    window groups) — the per-step DMA burst size knob, the analog of the
    reference's per-channel burst-beat configuration
    (``spmv-common.scala:26-29``); None = heuristic.
    ``pad_value``: value of padding slots — the additive identity of the
    semiring the plan will run under (0 for plus-times, +inf for
    min-plus, ...), so padding contributes nothing to any reduction.
    ``window_group_tiles``: tiles sharing one x-window base (must divide
    TILES_PER_STEP); smaller groups shrink the per-window column span.
    ``window_grain``: lane granularity of window bases (None = pick the
    coarsest of 128/64/32 that minimizes K).
    ``uniform_split``: with ``split``, give EVERY row exactly
    ``ceil(max_len/split)`` sub-rows (empty ones padded) and pad every
    slice to the same tile count — a 128-lane slice then covers a fixed
    block of ``128/parts`` rows (shrinking the window span) and the y
    fixup collapses to one reshape+reduce (``stats.uniform_parts``); with
    ``window_group_tiles == ceil(split/positions)`` each window group is
    exactly one slice and the kernel folds it to a single output row
    (``stats.group_slice_identity``).
    """
    csr = _as_csr(a)
    wg, double = _check_sell_args(value_dtype, pad_value, positions,
                                  window_group_tiles, split, stripe_width,
                                  uniform_split)
    kind = value_kind(value_dtype)
    rows, cols_n = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = (np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF)
    data = host_values(csr.data, value_dtype)
    nnz = int(indptr[-1])
    R, P = lane_rows, positions

    # --- 1-3. sub-rows, their order, slices and tiles -----------------------
    sr = _sell_rows(csr, R, P, sigma, split, stripe_width, uniform_split)
    T = sr.num_tiles
    num_slices = sr.num_slices
    vals = np.full((T, P, R), pad_value, dtype=_BUILD[kind])
    cols = np.zeros((T, P, R), dtype=np.int32)
    live = np.zeros((T, P, R), dtype=bool)
    if nnz:
        vsrc = sr.slot_src[sr.slot_src >= 0]
        k_slot = np.flatnonzero(sr.slot_valid)       # slot index per subrow
        lens = sr.o_len[vsrc]
        k = np.repeat(k_slot, lens)
        q = np.arange(k.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(sr.o_start[vsrc], lens) + q
        s = k // R
        j = k % R
        t = sr.tile_base[s] + q // P
        p = q % P
        vals[t, p, j] = data[src]
        cols[t, p, j] = indices[src].astype(np.int32)
        live[t, p, j] = True

    # --- 4. per-group window base + feasibility ------------------------------
    flat_cols = cols.reshape(T // wg, -1)
    flat_valid = live.reshape(T // wg, -1)
    cmin = np.where(flat_valid, flat_cols, np.iinfo(np.int32).max).min(axis=1)
    cmax = np.where(flat_valid, flat_cols, -1).max(axis=1)
    window_blocks, grain, wb = _window_bases(cmin, cmax, T, window_grain,
                                             max_window_blocks)
    max_window_base = int(wb.max()) if T else 0

    # fuse G groups of 8 tiles per kernel grid step: the reference
    # amortizes its fixed per-step pipeline cost against the
    # double-buffered VMEM budget (the grid step sets the padding of T and
    # the fold rule NG % 8 == 0, so the port keeps it)
    groups = _groups_per_step(window_blocks, groups_per_step, wg)
    step = TILES_PER_STEP * groups
    if T % step:
        pad = step - T % step
        vals = np.concatenate([vals,
                               np.full((pad, P, R), pad_value, vals.dtype)])
        cols = np.concatenate([cols, np.zeros((pad, P, R), cols.dtype)])
        live = np.concatenate([live, np.zeros((pad, P, R), bool)])
        wb = np.concatenate([wb, np.zeros(pad // wg, wb.dtype)])
        T = T + pad
    tile_slice = sr.tile_slice(T)

    # --- 5. fixup map --------------------------------------------------------
    num_slots = sr.slot_src.shape[0]
    row_map = np.full(num_slices * R, rows, dtype=np.int32)
    vmask = sr.slot_valid[:num_slots]
    row_map[:num_slots][vmask] = sr.o_row[
        sr.slot_src[:num_slots][vmask]].astype(np.int32)
    identity_map = sr.identity_map
    stats = _sell_stats(sr, nnz, T, P, R, tile_slice, wg, window_blocks,
                        max_window_base, groups, pad_value, double, grain)

    cols_win = compute_cols_win(live, cols, wb, window_blocks, wg, grain)
    if double:
        # hi/lo f32 channel pairs stacked along the position axis, the
        # reference's layout; the kernels join each pair into a double
        from ..ops.df64 import split_f64

        hi, lo = split_f64(vals)
        vals = np.concatenate([hi, lo], axis=1)        # (T, 2P, R)
    vals = finish_values(vals, value_dtype)
    window_rows = compute_window_rows(wb, window_blocks, cols_n, grain)

    return SellPlan(vals=vals, cols=cols, cols_win=cols_win,
                    tile_slice=tile_slice,
                    window_base=wb.astype(np.int32), row_map=row_map,
                    window_rows=window_rows,
                    shape=(rows, cols_n), lane_rows=R, positions=P,
                    identity_map=identity_map, stats=stats)


@dataclasses.dataclass(frozen=True)
class SellPrice:
    """What the cost model reads of a :class:`SellPlan`, computed without
    laying out its arrays (:func:`sell_plan_stats`): its ``stats``, its
    shape and tile geometry, ``identity_map`` and ``slots_y``, the length
    of its ``row_map``."""

    stats: PlanStats
    shape: Tuple[int, int]
    lane_rows: int
    positions: int
    identity_map: bool
    slots_y: int


def sell_plan_stats(a, *, lane_rows: int = 128, positions: int = 8,
                    sigma: Optional[int] = None,
                    split: Optional[int] = None,
                    max_window_blocks: int = 16,
                    value_dtype=np.float32,
                    pad_value: float = 0.0) -> SellPrice:
    """The :class:`SellPrice` of ``build_sell_plan(a, ...)`` with the
    same arguments (the planner's: no striping, no uniform split, the
    default grid step, window groups and grain), equal to what that plan
    carries: the same sub-rows, slices and tiles (:func:`_sell_rows`),
    with each window group's column range read from the first and last
    entry of each sub-row's share of it (a sub-row is a run of one
    column-sorted row) instead of from the (T, P, R) arrays."""
    csr = _as_csr(a)
    wg, double = _check_sell_args(value_dtype, pad_value, positions, None,
                                  split, None, False)
    rows, cols_n = csr.shape
    nnz = int(np.asarray(csr.indptr)[-1])
    R, P = lane_rows, positions
    sr = _sell_rows(csr, R, P, sigma, split, None, False)
    T = sr.num_tiles

    ngroups = T // wg
    cmin = np.full(ngroups, np.iinfo(np.int32).max, dtype=np.int64)
    cmax = np.full(ngroups, -1, dtype=np.int64)
    k_slot = np.flatnonzero(sr.slot_valid)
    sub = sr.slot_src[k_slot]
    live = sr.o_len[sub] > 0
    k_slot, sub = k_slot[live], sub[live]
    if k_slot.size:
        t0 = sr.tile_base[k_slot // R]
        ln = sr.o_len[sub]
        g0 = t0 // wg
        g1 = (t0 + _cdiv(ln, P) - 1) // wg
        cnt = g1 - g0 + 1
        k = np.repeat(np.arange(k_slot.size, dtype=np.int64), cnt)
        g = g0[k] + np.arange(k.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(cnt) - cnt, cnt)
        q_lo = np.maximum(0, (g * wg - t0[k]) * P)
        q_hi = np.minimum(ln[k], ((g + 1) * wg - t0[k]) * P)
        src = sr.o_start[sub][k]
        col = np.asarray(csr.indices).astype(np.int64, copy=False) & \
            0x3FFFFFFF
        np.minimum.at(cmin, g, col[src + q_lo])
        np.maximum.at(cmax, g, col[src + q_hi - 1])
    window_blocks, grain, wb = _window_bases(cmin, cmax, T, None,
                                             max_window_blocks)
    max_window_base = int(wb.max()) if T else 0
    groups = _groups_per_step(window_blocks, None, wg)
    step = TILES_PER_STEP * groups
    T = _cdiv(T, step) * step
    stats = _sell_stats(sr, nnz, T, P, R, sr.tile_slice(T), wg,
                        window_blocks, max_window_base, groups, pad_value,
                        double, grain)
    return SellPrice(stats=stats, shape=(rows, cols_n), lane_rows=R,
                     positions=P, identity_map=sr.identity_map,
                     slots_y=sr.num_slices * R)


def auto_plan(a, *, value_dtype=np.float32, max_window_blocks: int = 16,
              lane_rows: int = 128, positions: int = 8,
              allow_dia: bool = True, min_diag_fill: float = 0.5,
              min_dia_coverage: float = 0.3, semiring="plus_times",
              stages: Optional[dict] = None):
    """Heuristic plan selection driven by structure analyses.

    Decision features are the TPU ports of the reference's preprocessing
    analyses (maxAlive / maxColSpan / row-length histogram,
    ``SparseMatrix.cpp:92-119``), extended with diagonal-structure
    detection.  Returns the best plan *type* for the matrix — the role the
    reference assigns to choosing which accelerator bitfile to flash
    (``HWSpMVFactory.cpp:20-38``):

    0. nonzeros concentrated on dense diagonals -> :class:`~.dia.DiaPlan`
       (gather-free shift kernel, 4 B/nnz) or a :class:`~.dia.HybridPlan`
       with the SELL residual;
    1. skewed row lengths -> split + sigma sort;
    2. plain layout window-feasible -> done (banded / narrow matrices);
    3. else, if rows touch few column stripes on average -> stripe the
       columns so the windowed kernel applies;
    4. else leave window-infeasible (the stream strategy handles it).

    Planning runs in two stages, spans of ``utils/stats.py``:
    ``spmv.plan.detect`` (the CSR check and, for a plus-times plan, the
    diagonal detection) and ``spmv.plan.build`` (the rest); given a dict
    ``stages``, each adds its host seconds there under its name.  Inside
    the build, each candidate plan the heuristic builds or prices is a
    span ``spmv.plan.build.<family>`` (``sell``, ``chunk``, ``cached``,
    ``packed``, ``coo``); the host seconds of those not kept in the
    returned plan go to ``stages["spmv.plan.discarded_build"]``.  The
    counters ``plan.nnz`` and ``plan.slots`` add the returned plan's
    stored entries and streamed slots (:func:`stored_and_streamed`).
    """
    from ..ops import semiring as sr
    from ..utils.stats import counters, span

    s = sr.get(semiring)
    check_pad(value_dtype, s.zero)
    with span("spmv.plan.detect", stages):
        csr = _as_csr(a)
        if s.requires_nonnegative and csr.nnz:
            vmin = np.asarray(csr.data).min()
            if vmin < 0:
                raise ValueError(
                    f"semiring {s.name!r} is only a semiring on the "
                    f"non-negative domain (its zero={s.zero} must "
                    f"annihilate under mul), but the matrix has a negative "
                    f"value ({vmin}); padding slots would out-reduce true "
                    f"negative products.  x must be non-negative too.")
        # the DIA container encodes absence as 0, which is only the
        # additive identity of plus-times; other semirings run the SELL
        # path with padding set to their own zero
        split = None
        if allow_dia and csr.nnz and s.name == "plus_times":
            from .dia import split_diagonal

            split = split_diagonal(csr, min_diag_fill=min_diag_fill)
    log = _CANDIDATES.log = []
    try:
        with span("spmv.plan.build", stages):
            plan = _plan_csr(csr, split, s, value_dtype=value_dtype,
                             max_window_blocks=max_window_blocks,
                             lane_rows=lane_rows, positions=positions,
                             min_dia_coverage=min_dia_coverage)
    finally:
        _CANDIDATES.log = None
    kept = _plan_parts(plan)
    if stages is not None:
        stages["spmv.plan.discarded_build"] = sum(
            r["seconds"] for r in log
            if r["plan"] is None or id(r["plan"]) not in kept)
    nnz, slots = stored_and_streamed(plan)
    counters["plan.nnz"] += nnz
    counters["plan.slots"] += slots
    return plan


def _plan_csr(csr: CSR, split, s, *, value_dtype, max_window_blocks,
              lane_rows, positions, min_dia_coverage):
    """:func:`auto_plan`'s choice for a checked CSR, given its diagonal
    split (``split_diagonal``'s result, or None where DIA is not
    tried) and the semiring ``s``."""
    if split is not None:
        plan = _try_dia_plan(csr, split, value_dtype=value_dtype,
                             max_window_blocks=max_window_blocks,
                             lane_rows=lane_rows, positions=positions,
                             min_dia_coverage=min_dia_coverage)
        if plan is not None:
            from .dia import HybridPlan

            if isinstance(plan, HybridPlan):
                # diagonal coverage alone must not commit the choice (a
                # HybridPlan whose residual plan collapses loses to the
                # pure windowed path it never considered) — cost-compare
                # against the pure SELL plan
                from .costmodel import estimate_seconds

                alt = _auto_sell_plan(
                    csr, value_dtype=value_dtype,
                    max_window_blocks=max_window_blocks,
                    lane_rows=lane_rows, positions=positions,
                    pad_value=float(s.zero),
                    allow_packed=s.name == "plus_times")
                # the model is ±2x-coarse by design: veto only decisive
                # losses, don't re-litigate ties (tiny matrices price
                # every plan within noise of each other)
                if estimate_seconds(alt) < 0.7 * estimate_seconds(plan):
                    plan = alt
            return plan
    plan = _auto_sell_plan(csr, value_dtype=value_dtype,
                           max_window_blocks=max_window_blocks,
                           lane_rows=lane_rows, positions=positions,
                           pad_value=float(s.zero),
                           allow_packed=s.name == "plus_times")
    if s.name == "plus_times":
        # tiny-regime backstop: if the structured choice's fixed
        # machinery prices out worse than the gather+scatter COO path,
        # take the COO path (fires only for tiny windowless layouts)
        plan = _coo_backstop(csr, plan, value_dtype)
    return plan


def _try_dia_plan(csr: CSR, split, *, value_dtype, max_window_blocks,
                  lane_rows, positions, min_dia_coverage):
    """DiaPlan / HybridPlan if the diagonal structure pays for it, else
    None (the reference's feasibility rules, kept so that both packages
    pick the same plans); ``split`` is ``split_diagonal(csr)``."""
    from .dia import HybridPlan, build_dia_plan

    dia, rest, coverage = split
    if dia is None or coverage < min_dia_coverage:
        return None
    # the shift kernel streams sliding x blocks when x exceeds VMEM, but
    # each step's window must stay a few blocks wide: bound the diagonal
    # span (wider structure belongs to the SELL window/stripe machinery)
    offs = np.asarray(dia.offsets)
    if offs.size and int(offs.max() - offs.min()) > 12 * 64 * 128:
        return None
    if rest is not None and coverage < 0.98:
        # hybrid only worth a second pass over x/y when the dia part
        # carries real volume
        if dia.nnz < 4 * rest.nnz:
            return None
    dia_plan = build_dia_plan(dia, value_dtype=value_dtype)
    if rest is None:
        return dia_plan
    rest_plan = _auto_sell_plan(rest, value_dtype=value_dtype,
                                max_window_blocks=max_window_blocks,
                                lane_rows=lane_rows, positions=positions)
    rest_plan = _coo_backstop(rest, rest_plan, value_dtype)
    return HybridPlan(dia=dia_plan, rest=rest_plan)


def _coo_backstop(csr: CSR, plan, value_dtype):
    """Prefer the COO gather+scatter path when it prices below the
    structured plan (plus-times f32 only; fires mostly on tiny
    scatter-epilogue layouts like hybrid residues)."""
    if csr.nnz == 0 or value_kind(value_dtype) == "f64":
        return plan
    from .cached import COO_TAIL_MAX, CooTail, coo_tail_from_csr
    from .costmodel import estimate_seconds

    if isinstance(plan, CooTail) or csr.nnz > COO_TAIL_MAX:
        return plan
    with _candidate("coo") as rec:
        coo = rec["plan"] = coo_tail_from_csr(csr, value_dtype=value_dtype)
    return coo if estimate_seconds(coo) < estimate_seconds(plan) else plan


# -- candidates: the plans the heuristic builds or prices ---------------------

#: ``log``: the outermost candidates of the running ``auto_plan`` (None
#: outside one); ``depth``: candidates open on this thread
_CANDIDATES = threading.local()


@contextlib.contextmanager
def _candidate(family: str):
    """One candidate plan of ``family`` (``sell``, ``chunk``, ``cached``,
    ``packed`` or ``coo``) that the heuristic builds or prices: the span
    ``spmv.plan.build.<family>`` around it, and a record of its host
    seconds in the running ``auto_plan``'s log (outermost candidates
    only: a candidate built inside another, such as a CachedPlan's hot
    SELL plan, is part of its parent's time).  The body stores the plan
    it built under ``rec["plan"]`` (None where it only priced one or
    found none)."""
    from ..utils.stats import span

    log = getattr(_CANDIDATES, "log", None)
    depth = getattr(_CANDIDATES, "depth", 0)
    rec = {"family": family, "plan": None, "seconds": 0.0}
    _CANDIDATES.depth = depth + 1
    t0 = time.perf_counter()
    try:
        with span(f"spmv.plan.build.{family}"):
            yield rec
    finally:
        _CANDIDATES.depth = depth
        rec["seconds"] = time.perf_counter() - t0
        if log is not None and depth == 0:
            log.append(rec)


def _plan_parts(plan) -> set:
    """ids of ``plan`` and of every plan inside it (a HybridPlan's rest,
    a CachedPlan's tiers, a ChunkPlan's residue)."""
    ids = {id(plan)}
    for name in ("rest", "hot", "cold", "residue"):
        part = getattr(plan, name, None)
        if part is not None:
            ids |= _plan_parts(part)
    return ids


def stored_and_streamed(plan) -> Tuple[int, int]:
    """(entries the plan stores, value slots an apply streams, padding
    included) of a host or placed plan of any family; a PackedPlan
    streams its overflow entries a second time."""
    name = type(plan).__name__
    if name == "SellPlan":
        st = plan.stats
        return st.nnz, st.num_tiles * plan.positions * plan.lane_rows
    if name == "DiaPlan":
        slots = int(np.prod(tuple(plan.vals.shape)))
        return plan.stats.nnz, slots // (2 if plan.double else 1)
    if name == "CooTail":
        return plan.nnz, plan.nnz
    if name == "PackedPlan":
        st = plan.stats
        return st.nnz, st.num_tiles * 1024 + st.overflow_nnz
    if name == "ChunkPlan":
        slots = sum(int(np.prod(tuple(b.cols.shape))) for b in plan.buckets)
        slots += sum(int(np.prod(tuple(h.cols_win.shape)))
                     for h in plan.hbuckets)
        nnz = int(round(plan.stats.fill * max(1, slots)))
        if plan.residue is not None:
            rn, rs = stored_and_streamed(plan.residue)
            nnz, slots = nnz + rn, slots + rs
        return nnz, slots
    parts = [p for p in (getattr(plan, "dia", None),
                         getattr(plan, "rest", None),
                         getattr(plan, "hot", None),
                         getattr(plan, "cold", None)) if p is not None]
    if not parts:
        raise ValueError(f"no counts for plan type {name}")
    counts = [stored_and_streamed(p) for p in parts]
    return sum(c[0] for c in counts), sum(c[1] for c in counts)


class _PricedSell:
    """A SELL candidate priced from its statistics and laid out only if
    the heuristic returns it."""

    def __init__(self, csr, kw, sigma=None, split=None):
        self.csr, self.kw = csr, kw
        self.sigma, self.split = sigma, split
        with _candidate("sell"):
            self.price = sell_plan_stats(
                csr, sigma=sigma, split=split,
                **{k: kw[k] for k in ("value_dtype", "lane_rows",
                                      "positions", "max_window_blocks",
                                      "pad_value")})
        self.stats = self.price.stats
        self._plan = None

    def plan(self) -> SellPlan:
        if self._plan is None:
            with _candidate("sell") as rec:
                self._plan = rec["plan"] = build_sell_plan(
                    self.csr, sigma=self.sigma, split=self.split, **self.kw)
        return self._plan


def _column_working_set_above(csr: CSR, limit: int) -> bool:
    """Whether ``analysis.column_working_set(csr) > limit``: more than
    ``limit`` columns live at the middle entry of the row-major stream
    (seen at or before it and again after it) settles it in two passes;
    otherwise the analysis decides."""
    from . import analysis

    idx = np.asarray(csr.indices)
    n = idx.shape[0]
    if n:
        mid = n // 2
        cols = csr.shape[1]
        before = np.zeros(cols, dtype=bool)
        before[idx[:mid + 1] & 0x3FFFFFFF] = True
        after = np.zeros(cols, dtype=bool)
        after[idx[mid + 1:] & 0x3FFFFFFF] = True
        if int(np.count_nonzero(before & after)) > limit:
            return True
    return analysis.column_working_set(csr) > limit


def _stripe_pieces(csr: CSR, lens: np.ndarray, sw: int) -> int:
    """Distinct (row, stripe) runs of the row-major stream for stripes of
    ``sw`` columns: the striped plan's sub-row count before splitting."""
    idx = np.asarray(csr.indices)
    n = idx.shape[0]
    if n == 0:
        return 0
    stripe = (idx & 0x3FFFFFFF) // sw
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(stripe[1:], stripe[:-1], out=change[1:])
    starts = np.asarray(csr.indptr, dtype=np.int64)[:-1][lens > 0]
    change[starts] = True
    return int(np.count_nonzero(change))


def _auto_sell_plan(csr: CSR, *, value_dtype, max_window_blocks,
                    lane_rows, positions, pad_value: float = 0.0,
                    allow_cached: bool = True,
                    allow_packed: bool = True):
    lens = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    kw = dict(value_dtype=value_dtype, lane_rows=lane_rows,
              positions=positions, max_window_blocks=max_window_blocks,
              pad_value=pad_value)
    split = None
    sigma = None
    p = None
    if lens.size and lens.max() > 0:
        mean = max(1.0, float(lens.mean()))
        mx = float(lens.max())
        if mx / mean > 8.0:
            split = int(max(positions,
                            _cdiv(int(mean * 4), positions) * positions))
            sigma = lane_rows * 8
            # skewed rows: the chunk plan (formats/chunk.py) removes the
            # split/sigma scatter epilogue; take it when the cost model
            # prices it below the split/sigma plan and the layout stays
            # dtype/shape-compatible
            if value_kind(value_dtype) != "f64" and \
                    lane_rows == 128 and positions == 8:
                from .chunk import (ChunkRows, build_chunk_plan,
                                    chunk_price, chunk_seconds_floor)
                from .costmodel import estimate_seconds

                # both priced from their statistics, the chunk plan first
                # by a floor; it is laid out only where it wins
                p = _PricedSell(csr, kw, sigma=sigma, split=split)
                rival = estimate_seconds(p.price)
                with _candidate("chunk") as rec:
                    # duplicate merging sums values — plus-times only,
                    # and allow_packed is exactly the plus-times flag here
                    merge = allow_packed
                    ck = dict(value_dtype=value_dtype, pad_value=pad_value,
                              merge_duplicates=merge)
                    rows_ = ChunkRows(csr, merge_duplicates=merge)
                    # two floors, each dearer and tighter, then the price:
                    # the first settles a power-law graph of 10^8 entries,
                    # whose heavy rows alone take minutes to price
                    cp = None
                    if all(chunk_seconds_floor(
                            rows_, merge_duplicates=merge,
                            heavy_exact=exact) < rival * (1 + 1e-9)
                            for exact in (False, True)):
                        cp = chunk_price(rows_, **ck)
                    if cp is not None and estimate_seconds(cp) < rival:
                        cp = rec["plan"] = build_chunk_plan(rows_, **ck)
                    del rows_
                if rec["plan"] is not None:
                    return cp
        elif float(lens.std()) > mean:
            sigma = lane_rows * 8
        elif mx >= 1.5 * positions and mx <= 3.0 * mean:
            # regular rows: uniform split to 16-nnz sub-rows shrinks a
            # slice's row extent (128 -> 128/parts rows), which shrinks
            # every window group's column span; fill cost is bounded by
            # the rows' regularity
            usplit = 2 * positions
            if mx > usplit * lane_rows:
                # would need more sub-rows than lanes (build_sell_plan
                # rejects it); very long regular rows take the plain path
                with _candidate("sell") as rec:
                    rec["plan"] = build_sell_plan(csr, **kw)
                return rec["plan"]
            with _candidate("sell") as rec:
                pu = build_sell_plan(csr, split=usplit, uniform_split=True,
                                     window_group_tiles=max(
                                         1, _cdiv(usplit, positions)), **kw)
                # gate on fill over the REAL tiles (grid-step padding
                # would dominate the ratio for small matrices)
                real_slots = pu.stats.num_slices * \
                    _cdiv(usplit, positions) * positions * lane_rows
                if pu.stats.window_blocks and \
                        pu.stats.nnz >= 0.5 * real_slots:
                    rec["plan"] = pu
            if rec["plan"] is not None:
                return pu
    if p is None:                      # not priced for the chunk comparison
        p = _PricedSell(csr, kw, sigma=sigma, split=split)
    if p.stats.window_blocks or p.stats.nnz == 0:
        return p.plan()
    # small x: the resident strategy (x fully on chip, no locality
    # needed) beats a striped window plan, whose sub-row merge is an
    # unsorted segment scatter
    if _cdiv(csr.shape[1], 128) <= RESIDENT_MAX_BLOCKS:
        return p.plan()
    # window-infeasible and wide: the maxAlive / maxColSpan analyses (in
    # their CSR duals: column working set / per-row column span,
    # ``SparseMatrix.cpp:92-119``) drive which variant runs — the
    # reference's core selection thesis
    from . import analysis

    if value_kind(value_dtype) != "f64" and \
            not _column_working_set_above(csr, 2048):
        # bounded x working set: a compact tier keeps every live column
        # resident, beating striping's sub-row merge outright
        from .cached import _compact_full_cover

        with _candidate("cached") as rec:
            fc = rec["plan"] = _compact_full_cover(csr, kw)
        if fc is not None:
            return fc
    # striping width from the span distribution: stripes just wide
    # enough for 95% of rows keep K (and the kernel's select chain)
    # small without exploding the piece count
    spans = analysis.row_spans(csr)
    nz_spans = spans[lens > 0]
    p95 = int(np.percentile(nz_spans, 95)) if nz_spans.size else 0
    sw = max_window_blocks * 128
    if 0 < p95 <= sw // 2:
        sw = max(256, 1 << int(np.ceil(np.log2(max(p95, 1)))))
    # estimate striping overhead: pieces ~= distinct (row, stripe) pairs
    pieces = _stripe_pieces(csr, lens, sw)
    if pieces and p.stats.nnz / pieces >= 4.0:
        with _candidate("sell") as rec:
            ps = build_sell_plan(csr, sigma=sigma, split=split,
                                 stripe_width=sw, **kw)
            # striping must actually pay: stripe-pure slice padding can
            # collapse fill, at which point the locality-free packed
            # floor (the reference's v5e constants below) is cheaper
            # than streaming the padding.  Cost-compare instead of
            # committing on the piece estimate.
            from .costmodel import estimate_seconds

            packed_floor = 30e-6 + 1.64e-9 * ps.stats.nnz
            if ps.stats.window_blocks and \
                    estimate_seconds(ps) < packed_floor:
                rec["plan"] = ps
        if rec["plan"] is not None:
            return ps
    # locality-poor fall-through: a column-popularity hot/cold split
    # (CachedPlan — the vector-cache analog) wins when a small working
    # set covers enough of the nonzeros; otherwise the packed two-pass
    # kernel (the BufferNone analog, ``formats/packed.py``) serves any
    # structure at a bounded per-nnz cost.  The stream path is never
    # chosen silently.
    from .cached import (COO_TAIL_MAX, _compact_full_cover,
                         coo_tail_from_csr)

    if value_kind(value_dtype) != "f64" and csr.nnz <= (1 << 20):
        # windowless but narrow working set: remap the distinct columns
        # into one compact tier (resident/deep kernel, 100% coverage)
        with _candidate("cached") as rec:
            fc = rec["plan"] = _compact_full_cover(csr, kw)
        if fc is not None:
            return fc
    if csr.nnz <= COO_TAIL_MAX and value_kind(value_dtype) != "f64":
        # tiny and windowless: the element gather + segment scatter
        # beats every tiled kernel's fixed machinery
        with _candidate("coo") as rec:
            rec["plan"] = coo_tail_from_csr(csr, value_dtype=value_dtype)
        return rec["plan"]
    if allow_cached and value_kind(value_dtype) != "f64":
        from .cached import build_cached_plan

        with _candidate("cached") as rec:
            cp = rec["plan"] = build_cached_plan(
                csr, value_dtype=value_dtype,
                max_window_blocks=max_window_blocks, lane_rows=lane_rows,
                positions=positions, pad_value=pad_value,
                allow_packed=allow_packed)
        if cp is not None:
            return cp
    if allow_packed and value_kind(value_dtype) != "f64":
        from .packed import build_packed_plan

        with _candidate("packed") as rec:
            rec["plan"] = build_packed_plan(csr, value_dtype=value_dtype)
        return rec["plan"]
    return p.plan()


def validate_plan(plan: SellPlan, a=None) -> None:
    """Debug-mode invariant checks (host-side).

    The reference prevents races by construction and *counts* hazard events
    rather than hiding them (SURVEY.md §5: UniqueQueue/IssueWindow
    interlocks, pending-write counters).  Our layout makes conflicts
    impossible; this validator asserts exactly the invariants the kernels
    rely on, so a corrupted or hand-built plan fails loudly instead of
    producing silent wrong answers:

    * tile_slice nondecreasing, within [0, num_slices);
    * every column index within the matrix and, when the window kernel is
      enabled, within its step's K-block window;
    * row_map entries within [0, rows];
    * every (subrow, position) slot used at most once (no duplicate
      accumulation targets — the no-hazard guarantee);
    * optional: nonzero multiset matches the source container ``a``.
    """
    T, P, R = plan.vals.shape
    if plan.stats.double:
        P = plan.positions
    ts = np.asarray(plan.tile_slice)
    if ts.shape != (T,):
        raise ValueError("tile_slice shape mismatch")
    if (np.diff(ts) < 0).any():
        raise ValueError("tile_slice must be nondecreasing")
    if ts.min() < 0 or ts.max() >= plan.num_slices:
        raise ValueError("tile_slice out of range")

    cols = np.asarray(plan.cols)
    vals = host_numpy(plan.vals)
    if plan.stats.double:      # rejoin the hi/lo channel pairs to f64
        vals = vals[:, :P].astype(np.float64) + vals[:, P:]
    pad = plan.stats.pad_value
    live = (vals != pad) if np.isfinite(pad) else np.isfinite(vals)
    if live.any():
        live_cols = cols[live]
        if live_cols.min() < 0 or live_cols.max() >= plan.shape[1]:
            raise ValueError("column index out of matrix range")
    K = plan.stats.window_blocks
    if K > 0:
        wb = np.asarray(plan.window_base).astype(np.int64)
        step_of_tile = np.arange(T) // plan.stats.group_tiles
        lo = wb[step_of_tile] * plan.stats.window_grain
        ok = ~live | ((cols >= lo[:, None, None]) &
                      (cols < (lo + K * 128)[:, None, None]))
        if not ok.all():
            raise ValueError("nonzero outside its step's x window")
        cw = np.asarray(plan.cols_win).astype(np.int64)
        if cw.shape != (T, P, R):
            raise ValueError("cols_win shape mismatch")
        if cw.min() < 0 or cw.max() >= K * 128:
            raise ValueError("cols_win offset outside window")
        if not np.array_equal(cw[live], (cols - lo[:, None, None])[live]):
            raise ValueError("cols_win inconsistent with cols/window_base")

    rm = np.asarray(plan.row_map)
    if rm.min() < 0 or rm.max() > plan.shape[0]:
        raise ValueError("row_map out of range")

    if a is not None:
        csr = _as_csr(a)
        want = np.sort(np.asarray(csr.data)[np.asarray(csr.data) != 0])
        got = np.sort(vals[live])
        if want.shape != got.shape or not np.allclose(want, got):
            raise ValueError("plan nonzero multiset differs from source")
