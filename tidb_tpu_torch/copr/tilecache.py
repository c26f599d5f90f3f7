"""Region batches and the host half of the device tile codecs (ref:
tidb_tpu/copr/tilecache.py:28 ColumnBatch, :131 encode_valid_lane, :156
encode_data_lane, copied so the port's codec choices — and therefore the
lanes its kernels decode — are bit-for-bit the reference's).

The reference's tile CACHE (version-tagged batches per region, built from
storage) is not ported: the port's callers hand it a ColumnBatch directly
(entry.batch_from_numpy).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..chunk.chunk import Chunk, Column
from ..catalog.schema import TableInfo


_BATCH_UIDS = itertools.count(1)


@dataclass
class ColumnBatch:
    """All rows of one (table, region) decoded into dense numpy columns.
    `uid` tells two batches apart whatever their version (the window
    path's device-input cache keys on it)."""

    table: TableInfo
    handles: np.ndarray  # int64 row handles
    data: list[np.ndarray]  # per table column (offset order)
    valid: list[np.ndarray]
    version: tuple | int
    start: bytes = b""
    end: bytes = b""
    min_valid_ts: int = 0  # last table-commit ts at build time
    uid: int = field(default_factory=lambda: next(_BATCH_UIDS), compare=False)

    @property
    def n_rows(self) -> int:
        return len(self.handles)

    def to_chunk(self, col_offsets: list[int]) -> Chunk:
        cols = []
        for off in col_offsets:
            ft = self.table.columns[off].ft
            cols.append(Column(ft, self.data[off], self.valid[off]))
        return Chunk(cols)


# --- device tile codecs (host-side encode half; decode is fused into the
# --- port's decode_lane kernel, kernels/decode_lane.py) ----------------------
#
# Per-column encodings chosen at batch build so the WIRE/h2d form is the
# compressed form ("GPU Acceleration of SQL Analytics on Compressed Data",
# arXiv:2506.10092 — decompress-in-kernel beats transfer-then-process):
#
#   pack   frame-of-reference downcast for narrow-range int lanes: upload
#          (d - lo) as uint8/16/32 plus a 0-d base scalar in the ORIGINAL
#          dtype; decode is one add (bit-exact, ints only)
#   dict   sorted-unique values + narrow codes for low-NDV lanes (ints AND
#          floats — skipped when the lane holds NaN, which breaks
#          searchsorted, or a negative zero, which np.unique would
#          bit-merge with +0.0); decode is one gather
#   rle    run-length (vals, lens) for sorted/clustered/constant lanes and
#          few-run validity masks; decode expands runs to the static
#          [T, R] shape (pad tail rows are don't-care: every
#          kernel masks with row_valid / the per-lane valid bit first)
#   rv     zero-byte alias for the all-valid mask — it is bit-identical
#          to row_valid, which the kernel already holds
#   dense  the plain padded [T, R] lane — chosen whenever no codec beats
#          it (wide-range high-NDV ints, high-entropy floats)
#
# Invalid rows are normalized to 0 before encoding (kernels never read
# data under a false valid bit), and aux arrays (dict vocab, rle runs) pad
# to power-of-two lengths so compile-cache keys — which carry the codec
# signature — stay bounded.

MIN_TILE_ROWS = 256  # smallest row bucket a DeviceBatch pads to
DICT_MAX_NDV = 4096  # beyond this a dict vocab stops paying for itself
_AUX_MIN = 8  # smallest padded aux-array length (vocab / run buffers)


def pow2_rows(n: int, lo: int = MIN_TILE_ROWS) -> int:
    """Row-bucket for n rows: next power of two, floored at `lo`."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def _pow2_len(n: int, lo: int = _AUX_MIN) -> int:
    return pow2_rows(n, lo)


def _pad2d(a: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    t, r = shape
    out = np.zeros(t * r, dtype=a.dtype)
    out[: len(a)] = a
    return out.reshape(t, r)


def _pad1d(a: np.ndarray, length: int) -> np.ndarray:
    out = np.zeros(length, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _rle_encode(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(run values, run lengths) of x. NaN != NaN splits runs — harmless:
    each NaN becomes its own run and decodes back bit-exact."""
    n = len(x)
    if n == 0:
        return x[:0], np.zeros(0, np.int32)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(x[1:], x[:-1], out=change[1:])
    idx = np.flatnonzero(change)
    return x[idx], np.diff(np.append(idx, n)).astype(np.int32)


def _code_dtype(span: int):
    """Smallest unsigned dtype holding values in [0, span]."""
    if span < (1 << 8):
        return np.uint8
    if span < (1 << 16):
        return np.uint16
    if span < (1 << 32):
        return np.uint32
    return None


def encode_valid_lane(v: np.ndarray, shape: tuple[int, int]):
    """Validity mask codec. The overwhelmingly common all-valid mask is
    EXACTLY row_valid (true for real rows, false for the pad tail), so it
    ships as a zero-byte alias — the kernel reuses the row_valid array it
    already holds, paying neither wire bytes nor a decode expand. Masks
    with few runs take RLE; ragged ones stay dense. Returns
    (payload | None for dense, sig)."""
    if v.all():
        return {}, ("rv",)
    padded = shape[0] * shape[1]
    vals, lens = _rle_encode(v)
    # +1 guarantees a trailing zero-value zero-length pad run: the decode
    # with total_repeat_length clamps the tail gather to the LAST run,
    # so without the pad an exactly-pow2 run count ending in True would
    # decode pad rows as valid
    np_len = _pow2_len(len(vals) + 1)
    rle_bytes = np_len * (vals.dtype.itemsize + 4)
    if rle_bytes < padded // 2:
        return (
            {"rv": _pad1d(vals, np_len), "rl": _pad1d(lens, np_len)},
            ("rle", np_len),
        )
    return None, ("dense",)


def encode_data_lane(d: np.ndarray, v: np.ndarray, shape: tuple[int, int]):
    """Pick + apply the cheapest codec for one numeric data lane.
    Returns (payload | None for dense, sig). `sig` is the static codec
    descriptor that joins the device program's compile-cache key (decode
    is traced into the program, so programs are codec-specific) AND the
    launch-group fuse key (stacked lanes must agree on aux shapes)."""
    padded = shape[0] * shape[1]
    item = d.dtype.itemsize
    dense_bytes = padded * item
    dz = np.where(v, d, np.zeros((), d.dtype)) if not v.all() else d
    any_valid = bool(v.any())
    is_int = np.issubdtype(d.dtype, np.integer)

    # a float lane holding negative zero stays dense/pack-free of value
    # merging: -0.0 == 0.0 under np.unique AND run detection, so dict and
    # rle would canonicalize the sign bit the dense lane preserves
    has_negzero = (not is_int) and bool(np.any((dz == 0.0) & np.signbit(dz)))

    best = (dense_bytes, "dense", None)

    # rle — runs over the normalized lane (+1: always keep a zero pad
    # run so the decode's tail-clamp gathers 0, see encode_valid_lane)
    if not has_negzero:
        rvals, rlens = _rle_encode(dz)
        np_len = _pow2_len(len(rvals) + 1)
        rle_bytes = np_len * (item + 4)
        if rle_bytes < best[0]:
            best = (rle_bytes, "rle", (rvals, rlens, np_len))

    lo = hi = None
    if any_valid and is_int:
        lo, hi = dz[v].min(), dz[v].max()
        cdt = _code_dtype(int(hi) - int(lo))
        if cdt is not None and cdt().itemsize < item:
            pack_bytes = padded * cdt().itemsize + item
            if pack_bytes < best[0]:
                best = (pack_bytes, "pack", (lo, cdt))

    if any_valid and not has_negzero:
        # dict — sample NDV first so np.unique never runs on a lane that
        # obviously won't dictionary-compress; the stride comes from the
        # VALID subset being sampled (a sparse-valid lane would otherwise
        # be under-sampled into a spuriously high NDV estimate)
        pres = dz[v]
        sample = pres[:: max(1, len(pres) // 4096)][:4096]
        if len(np.unique(sample)) <= min(DICT_MAX_NDV, max(len(sample) // 2, 1)):
            if is_int or not np.isnan(pres).any():
                uniq = np.unique(pres)
                ndv = len(uniq)
                cdt = _code_dtype(ndv - 1) if ndv else None
                if ndv and ndv <= DICT_MAX_NDV and cdt is not None \
                        and cdt().itemsize < item:
                    vp = _pow2_len(ndv)
                    dict_bytes = padded * cdt().itemsize + vp * item
                    if dict_bytes < best[0]:
                        best = (dict_bytes, "dict", (uniq, vp, cdt))

    kind = best[1]
    if kind == "dense":
        return None, ("dense",)
    if kind == "rle":
        rvals, rlens, np_len = best[2]
        return (
            {"rv": _pad1d(rvals, np_len), "rl": _pad1d(rlens, np_len)},
            ("rle", np_len, d.dtype.str),
        )
    if kind == "pack":
        lo, cdt = best[2]
        packed = (dz.astype(np.int64) - int(lo)).astype(cdt) if d.dtype.kind == "i" \
            else (dz - lo).astype(cdt)
        return (
            {"p": _pad2d(packed, shape), "b": np.asarray(lo, dtype=d.dtype)},
            ("pack", np.dtype(cdt).str, d.dtype.str),
        )
    uniq, vp, cdt = best[2]
    codes = np.searchsorted(uniq, dz).astype(cdt)
    codes[~v] = 0
    vocab = _pad1d(uniq, vp)
    if vp > len(uniq):
        vocab[len(uniq):] = uniq[-1]  # pad codes stay in-domain
    return (
        {"c": _pad2d(codes, shape), "v": vocab},
        ("dict", np.dtype(cdt).str, vp, d.dtype.str),
    )
