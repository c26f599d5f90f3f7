"""Columnar tile cache — the TiFlash-replica analog (copy of
tidb_tpu/copr/tilecache.py: :28 ColumnBatch, :131 encode_valid_lane, :156
encode_data_lane, :312 decode_rows_to_batch, :347 _gather_columnar, :407
build_batch_from_segments, :584 TileCache; the port's codec choices — and
therefore the lanes its kernels decode — are bit-for-bit the reference's).

The columnar replica is a lazily-built, version-tagged cache of decoded
column batches per (table, region), reused across queries so the scan hot
path never touches row decode: `TileCache.get_batch` takes a snapshot of
the port's store (storage/txn.py) and gathers the region's ingest runs
(storage/segment.py) and the committed transactional rows over them into a
ColumnBatch, which the engines upload and run (copr/gpu_engine.py).
Callers without a store hand the engines a ColumnBatch directly
(entry.batch_from_numpy).

Invalidation: `Storage.bump_version` increments a per-table counter on
every committed write; a batch built at an older version is rebuilt on
next access — unless the region's own key range took no commit since the
batch's snapshot (`MVCCStore.range_written_since`), when the batch, still
exact, is kept under the new version with its device lanes (the
reference's cache rebuilds every region of the table). A rebuilt or
invalidated region's device lanes (`_gpu_mirrors`) go with its batch.
Uncommitted reads (txn membuffer) bypass the cache.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from threading import RLock

import numpy as np

from ..chunk.chunk import Chunk, Column
from ..codec import tablecodec
from ..codec.row import decode_row
from ..catalog.schema import TableInfo
from ..mysqltypes.datum import Datum


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
    read_ts: int = 0  # the snapshot the batch was built at (TileCache)
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


def batch_nbytes(batch: ColumnBatch) -> float:
    """Approximate host bytes of a batch — the RU read-byte term and the
    arbiter's footprint proxy. numpy lanes answer exactly; object lanes
    count their pointer array (a cheap, stable underestimate — the RU
    model needs monotonic, not forensic). Cached: sibling tasks and
    retries re-ask for the same immutable batch."""
    cached = getattr(batch, "_nbytes", None)
    if cached is None:
        n = float(getattr(batch.handles, "nbytes", 0))
        for a in batch.data:
            n += getattr(a, "nbytes", 0)
        for v in batch.valid:
            n += getattr(v, "nbytes", 0)
        batch._nbytes = cached = n
    return cached


# --- batches from the store's runs and rows ---------------------------------


def _decode_handles(keybuf: np.ndarray, n: int) -> np.ndarray:
    """(n, 19) record-key byte matrix → int64 handles (vectorized BE+sign)."""
    enc = np.ascontiguousarray(keybuf[:, 11:19]).view(">u8").reshape(n)
    return (enc.astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)


def _decode_values_into(table, cols, big: np.ndarray, offs: np.ndarray, lens: np.ndarray, rows_idx: np.ndarray, handles: np.ndarray) -> None:
    """Decode row values (at byte offsets `offs`, byte lengths `lens`, in
    buffer `big`) into chunk columns at target positions `rows_idx`; v2
    rows vectorized, v1 rows per-row."""
    from ..codec import rowfast

    n = len(offs)
    if n == 0:
        return
    first = big[offs]
    v2 = first == rowfast.V2_FLAG
    v2_pos = np.nonzero(v2)[0]
    if len(v2_pos):
        # batch-decode header-identical rows; fall back on the rest
        bad = rowfast.decode_v2_batch(big, offs[v2_pos], table, cols, rows_idx[v2_pos])
        for b in bad:  # rare: schema drifted mid-table
            p = v2_pos[int(b)]
            end = int(offs[p]) + int(lens[p])
            _decode_one(table, cols, int(rows_idx[p]), big[offs[p] : end].tobytes(), int(handles[p]))
    for p in np.nonzero(~v2)[0]:
        end = int(offs[p]) + int(lens[p])
        _decode_one(table, cols, int(rows_idx[p]), big[offs[p] : end].tobytes(), int(handles[p]))


def decode_rows_to_batch(table: TableInfo, kvs: list[tuple[bytes, bytes]], version: int) -> ColumnBatch:
    """Row-format KV pairs → dense columnar batch (the once-per-version
    decode; ref: rowcodec ChunkDecoder decoding straight into chunks).

    v2 rows (bulk-loaded, identical headers) decode with vectorized numpy
    gathers; v1 rows (DML path) fall back to per-row decode. A mixed batch
    routes each row down the right path by its version flag.
    """
    n = len(kvs)
    chk = Chunk.empty([c.ft for c in table.columns], n)
    cols = chk.columns

    # handles: record keys are fixed 19 bytes → one vectorized BE decode
    keybuf = np.frombuffer(b"".join(k for k, _ in kvs), dtype=np.uint8)
    if n and len(keybuf) == 19 * n:
        handles = _decode_handles(keybuf.reshape(n, 19), n)
    else:  # ragged keys (shouldn't happen for record scans) — per-row
        handles = np.fromiter((tablecodec.decode_record_handle(k) for k, _ in kvs), np.int64, n)

    vals = [v for _, v in kvs]
    lens = np.fromiter((len(v) for v in vals), np.int64, n)
    big = np.frombuffer(b"".join(vals), dtype=np.uint8)
    offs = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    _decode_values_into(table, cols, big, offs, lens, np.arange(n, dtype=np.int64), handles)

    # hidden rowid column mirrors handles
    for c in table.columns:
        if c.hidden and c.name == "_tidb_rowid":
            cols[c.offset].data[:] = handles
            cols[c.offset].valid[:] = True
    return ColumnBatch(table, handles, [c.data for c in cols], [c.valid for c in cols], version)


def _gather_columnar(table: TableInfo, cols, run, keep: np.ndarray,
                     rows_idx: np.ndarray) -> None:
    """ColumnarRun fast path: copy the run's column arrays straight into
    the chunk columns — no v2 row decode, no byte-matrix gather. Mirrors
    decode_v2_batch's routing exactly (decimal rescale to the table's
    scale, float/uint bit views, ascii/utf8 strings, defaults for table
    columns the run doesn't carry)."""
    from ..mysqltypes.datum import K_DEC, K_STR
    from ..table.table import datum_from_default

    by_id = {c.id: c for c in table.columns}
    contiguous = len(keep) == run.n  # whole-run scans skip the gather copy
    present: set[int] = set()
    for spec in run.cols:
        c = by_id.get(spec.cid)
        if c is None:
            continue
        present.add(spec.cid)
        col = cols[c.offset]
        data = spec.data if contiguous else spec.data[keep]
        if data.dtype.kind == "O":
            # still-object str lane: already the chunk form — no decode
            col.data[rows_idx] = data
        elif data.dtype.kind == "S":
            w = data.dtype.itemsize
            if spec.kind != K_STR:  # K_BYTES lanes keep bytes payloads
                strs = np.array([bytes(x) for x in data], dtype=object)
            elif w == 0:
                strs = np.full(len(rows_idx), "", dtype=object)
            elif (data.view(np.uint8) >= 0x80).any():  # non-ascii → utf8 per row
                strs = np.array([bytes(x).decode("utf8") for x in data], dtype=object)
            else:
                strs = data.astype("U").astype(object)
            col.data[rows_idx] = strs
        else:
            vals = data
            if spec.kind == K_DEC:
                want = max(c.ft.decimal, 0)
                sc = spec.scale
                if want != sc:
                    vals = vals * 10 ** (want - sc) if want > sc else vals // 10 ** (sc - want)
            col.data[rows_idx] = vals.astype(col.data.dtype, copy=False)
        if spec.valid is None:
            col.valid[rows_idx] = True
        else:
            col.valid[rows_idx] = spec.valid if contiguous else spec.valid[keep]
    for c in table.columns:
        if c.id in present:
            continue
        if c.hidden and c.name == "_tidb_rowid":
            continue  # caller fills from handles
        d = datum_from_default(c)
        col = cols[c.offset]
        if d.is_null:
            col.valid[rows_idx] = False
        else:
            for i in rows_idx:
                col.set_datum(int(i), d)


def build_batch_from_segments(table: TableInfo, segs, loose, version) -> ColumnBatch:
    """Segment scan results → columnar batch, gathering key/value bytes
    straight out of run buffers (zero per-row materialization for the
    bulk-loaded fast path; ColumnarRun segments copy their column arrays
    directly — no row decode at all)."""
    from ..storage.segment import ColumnarRun

    keeps = [s.keep_idx() for s in segs]
    n = sum(len(k) for k in keeps) + len(loose)
    chk = Chunk.empty([c.ft for c in table.columns], n)
    cols = chk.columns
    handles = np.zeros(n, dtype=np.int64)
    row0 = 0
    for s, keep in zip(segs, keeps):
        m = len(keep)
        if m == 0:
            continue
        run = s.run
        rows_idx = np.arange(row0, row0 + m, dtype=np.int64)
        if isinstance(run, ColumnarRun):
            seg_handles = run.handles_arr if m == run.n else run.handles_arr[keep]
            handles[row0 : row0 + m] = seg_handles
            _gather_columnar(table, cols, run, keep, rows_idx)
            row0 += m
            continue
        key_mat = run.key_mat[keep]
        if key_mat.shape[1] == 19:
            seg_handles = _decode_handles(key_mat, m)
        else:
            seg_handles = np.fromiter(
                (tablecodec.decode_record_handle(run.key_at(int(i))) for i in keep), np.int64, m
            )
        handles[row0 : row0 + m] = seg_handles
        big = run.value_buffer()
        _decode_values_into(table, cols, big, run.starts[keep], run.lens[keep], rows_idx, seg_handles)
        row0 += m
    for k, v in loose:
        h = tablecodec.decode_record_handle(k)
        handles[row0] = h
        _decode_one(table, cols, row0, v, h)
        row0 += 1
    for c in table.columns:
        if c.hidden and c.name == "_tidb_rowid":
            cols[c.offset].data[:] = handles
            cols[c.offset].valid[:] = True
    return ColumnBatch(table, handles, [c.data for c in cols], [c.valid for c in cols], version)


def _decode_one(table: TableInfo, cols, i: int, val: bytes, handle: int) -> None:
    from ..table.table import datum_from_default

    by_id = decode_row(val)
    for off, c in enumerate(table.columns):
        d = by_id.get(c.id)
        if d is None:
            if c.hidden and c.name == "_tidb_rowid":
                d = Datum.i(handle)
            else:
                d = datum_from_default(c)
        cols[off].set_datum(i, d)


def _drop_mirrors(b: ColumnBatch) -> float:
    """Drop a batch's device lanes (the engine's `_gpu_mirrors`, rebuilt
    at the next use) → the device bytes they held."""
    mirrors = getattr(b, "_gpu_mirrors", None)
    freed = 0.0
    if mirrors:
        for m in mirrors.values():
            for lane in list(m._data.values()) + list(m._valid.values()):
                for t in (lane.values() if isinstance(lane, dict) else (lane,)):
                    freed += float(getattr(t, "nbytes", 0))
    b._gpu_mirrors = None
    return freed


class TileCache:
    def __init__(self, storage):
        self.storage = storage
        self._cache: dict[tuple[int, bytes], ColumnBatch] = {}
        self._lock = RLock()  # cop worker pool shares this cache
        self.hits = 0
        self.misses = 0
        self.revalidated = 0  # hits on a batch kept across a commit elsewhere in its table

    def get_batch(self, table: TableInfo, start: bytes, end: bytes, read_ts: int) -> ColumnBatch:
        """Snapshot-correct cache: a batch built when the table's last
        commit was at `last_commit_ts` is valid for any read_ts ≥ that
        commit while the version counter is unchanged, or while its
        region took no commit since the batch's snapshot. Reads BELOW the
        last commit (historic snapshots) always rebuild, uncached."""
        ver, last_commit_ts = self.storage.data_version(tablecodec.table_prefix(table.id))
        key = (table.id, start)
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None and cached.end == end and read_ts >= cached.min_valid_ts:
                if cached.version == ver:
                    self.hits += 1
                    return cached
                if read_ts >= last_commit_ts and not self.storage.mvcc.range_written_since(
                        start, end, cached.read_ts):
                    cached.version, cached.min_valid_ts = ver, last_commit_ts
                    self.hits += 1
                    self.revalidated += 1
                    return cached
            self.misses += 1
        snap = self.storage.snapshot(read_ts)
        segs, loose = snap.scan_segments(start, end)
        batch = build_batch_from_segments(table, segs, loose, ver)
        batch.start, batch.end = start, end
        batch.min_valid_ts = last_commit_ts
        batch.read_ts = read_ts
        if read_ts >= last_commit_ts:
            with self._lock:
                old = self._cache.get(key)
                self._cache[key] = batch
            if old is not None and old is not batch:
                _drop_mirrors(old)
        return batch

    def invalidate_table(self, table_id: int) -> None:
        with self._lock:
            for key in [k for k in self._cache if k[0] == table_id]:
                _drop_mirrors(self._cache.pop(key))

    def evict_all(self) -> float:
        """Drop every cached column batch AND its device lanes — the
        tile cache and the engine's per-device mirrors hanging off it are
        the store's biggest reclaimable pools. Batches still referenced by
        in-flight tasks keep working (their lanes upload again at the
        next use); only the cache lets go. Returns the bytes whose
        ownership the cache dropped: host lane bytes plus each mirror's
        device (compressed) lane bytes."""
        freed = 0.0
        with self._lock:
            for b in self._cache.values():
                freed += batch_nbytes(b) + _drop_mirrors(b)
            self._cache.clear()
        return freed
