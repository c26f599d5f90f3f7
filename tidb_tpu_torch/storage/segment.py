"""Immutable sorted ingest segments (copy of tidb_tpu/storage/segment.py
without the runs' WAL records, which come with the durable store) — the
LSM-run / TiFlash-columnar-replica analog (ref: br/pkg/lightning local backend builds SSTs and ingests them
without touching the write path; unistore sits on badger's LSM runs).

A `Run` is one bulk-ingested, single-commit-ts sorted segment:
  - fixed-width user keys as a (n, w) uint8 matrix (memcomparable order)
  - values as ONE buffer + (starts, lens) — no per-row bytes objects
  - a whole-run commit_ts: every entry became visible atomically, so MVCC
    visibility is a single comparison per run, not per key

Point/range lookups binary-search the key matrix directly (no per-key
Python objects are ever materialized on the ingest or scan hot paths).
Scans return `SegmentView`s (run slice + optional dropped rows) so the
columnar decode layer (copr/tilecache.py) can gather straight from the
run's buffers.

Two specialized subclasses, which the bulk-ingest path builds, keep the
row-major byte planes from being materialized at load time (the columnar
form IS the ingest wire format — arXiv:2506.10092):

  `ColumnarRun`  record-plane segment holding the COLUMN arrays plus the
                 int64 handles; record keys, the v2 row-byte plane and
                 per-row values synthesize lazily on first demand (scans
                 read the columns directly via copr/tilecache).
  `IntIndexRun`  all-int secondary-index segment holding the sorted key
                 columns + handles; the (n, w) key byte matrix, which
                 only index-path scans need, builds lazily.

Both honor the full Run surface (find/range/value/pairs/kill_range), so
every existing consumer — MVCC merge, snapshots, WAL replay, region
splits — keeps working; they just stop paying for bytes nobody asked for.
"""

from __future__ import annotations

import numpy as np


def sort_key_matrix(key_mat: np.ndarray) -> np.ndarray:
    """Row order that sorts fixed-width byte-string rows lexicographically.
    Views rows as big-endian u64 words (zero-padded) and lexsorts."""
    n, w = key_mat.shape
    pad = (-w) % 8
    if pad:
        m = np.zeros((n, w + pad), dtype=np.uint8)
        m[:, :w] = key_mat
    else:
        m = np.ascontiguousarray(key_mat)
    words = m.view(">u8").reshape(n, (w + pad) // 8)
    return np.lexsort(tuple(words[:, c] for c in range(words.shape[1] - 1, -1, -1)))


class Run:
    """One immutable sorted segment (all keys same width, one commit_ts)."""

    __slots__ = ("key_mat", "vbuf", "starts", "lens", "commit_ts", "alive", "n", "w", "_keybuf")

    def __init__(self, key_mat: np.ndarray, vbuf, starts: np.ndarray, lens: np.ndarray, commit_ts: int):
        self.key_mat = key_mat
        self.vbuf = vbuf  # bytes or 1-D uint8 array
        self.starts = starts
        self.lens = lens
        self.commit_ts = commit_ts
        self.alive: np.ndarray | None = None  # None = all alive
        self.n, self.w = key_mat.shape
        self._keybuf: bytes | None = None  # lazy contiguous key bytes

    @staticmethod
    def build(key_mat: np.ndarray, vbuf, starts: np.ndarray, lens: np.ndarray,
              commit_ts: int, presorted: bool = False) -> "Run":
        key_mat = np.ascontiguousarray(key_mat, dtype=np.uint8)
        if not presorted and key_mat.shape[0] > 1:
            order = sort_key_matrix(key_mat)
            if not np.array_equal(order, np.arange(len(order))):
                key_mat = np.ascontiguousarray(key_mat[order])
                starts = np.asarray(starts)[order]
                lens = np.asarray(lens)[order]
        return Run(key_mat, vbuf, np.asarray(starts, np.int64), np.asarray(lens, np.int64), commit_ts)

    # --- key access -------------------------------------------------------

    def key_at(self, i: int) -> bytes:
        if self._keybuf is None:
            self._keybuf = self.key_mat.tobytes()
        return self._keybuf[i * self.w : (i + 1) * self.w]

    def _bisect(self, key: bytes) -> int:
        """Leftmost row index with key_at(row) >= key (bytes comparison —
        a shorter probe key sorts before any key it prefixes, matching
        python bytes ordering used by MemKV)."""
        lo, hi = 0, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self.key_at(mid) < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    # --- point ops --------------------------------------------------------

    def find(self, key: bytes) -> int:
        """Row index of key, or -1."""
        if len(key) != self.w:
            return -1
        i = self._bisect(key)
        if i < self.n and self.key_at(i) == key and (self.alive is None or self.alive[i]):
            return i
        return -1

    def value(self, i: int) -> bytes:
        s = int(self.starts[i])
        v = self.vbuf[s : s + int(self.lens[i])]
        return v.tobytes() if isinstance(v, np.ndarray) else v

    def value_buffer(self) -> np.ndarray:
        """The whole value plane as a u8 array (decode fast path)."""
        if isinstance(self.vbuf, np.ndarray):
            return self.vbuf
        return np.frombuffer(self.vbuf, dtype=np.uint8)

    def range(self, start: bytes, end: bytes | None) -> tuple[int, int]:
        i = self._bisect(start)
        j = self._bisect(end) if end is not None else self.n
        return i, j

    def kill_range(self, start: bytes, end: bytes | None) -> int:
        """Tombstone all rows in [start, end) (unsafe_destroy_range)."""
        i, j = self.range(start, end)
        if i >= j:
            return 0
        if self.alive is None:
            self.alive = np.ones(self.n, dtype=bool)
        killed = int(self.alive[i:j].sum())
        self.alive[i:j] = False
        return killed


def canonical_str_array(arr: np.ndarray) -> np.ndarray:
    """Object/unicode string column → 'S' bytes array (utf8 per element
    on non-ascii). ColSpec string lanes stay in their INPUT form (object
    arrays of str are the scan-side chunk form already — converting 16M
    of them at load time was the single biggest remaining cost); this is
    the one conversion point for consumers that genuinely need bytes
    (the WAL ingest record, the lazy v2 row plane)."""
    a = np.asarray(arr)
    if a.dtype.kind == "S":
        return a
    try:
        return a.astype("S")
    except UnicodeEncodeError:
        return np.array(
            [v.encode("utf8") if isinstance(v, str) else (v or b"") for v in a],
            dtype="S",
        )


class ColSpec:
    """One column's payload inside a ColumnarRun: canonical numpy arrays
    (int64 for int/time/duration and scaled decimals, uint64 for
    unsigned, float64 for doubles, an 'S<w>' — or still-object str —
    array for strings) plus the v2-row metadata needed to synthesize row
    bytes bit-compatibly."""

    __slots__ = ("cid", "kind", "scale", "data", "valid")

    def __init__(self, cid: int, kind: int, scale: int, data: np.ndarray,
                 valid: np.ndarray | None = None):
        self.cid = cid
        self.kind = kind
        self.scale = scale
        self.data = data
        self.valid = valid  # None = all valid

    def take(self, order: np.ndarray) -> "ColSpec":
        return ColSpec(self.cid, self.kind, self.scale, self.data[order],
                       None if self.valid is None else self.valid[order])


def _decode_be_handle(b: bytes) -> int:
    """8 sign-flipped big-endian bytes → signed int64 handle — the ONE
    memcomparable-int codec (codec/tablecodec), not a local copy."""
    from ..codec.tablecodec import _dint

    return _dint(b)


def _encode_be_handle(h: int) -> bytes:
    from ..codec.tablecodec import _cint

    return _cint(h)


class ColumnarRun(Run):
    """Record-plane segment in columnar form — what the bulk-ingest path
    builds. Keys are `record_prefix(table_id) + BE(handle)` by
    construction, so point/range probes binary-search the int64 handle
    array (no key matrix); the (n, 19) key matrix and the row-major v2
    value plane materialize lazily, only for consumers that genuinely
    need bytes (legacy pair scans, per-row point gets)."""

    # no __slots__: lazily-materialized planes live in the instance dict

    def __init__(self, table_id: int, handles: np.ndarray, cols: list[ColSpec],
                 commit_ts: int):
        from ..codec import tablecodec

        self.table_id = table_id
        self.handles_arr = np.ascontiguousarray(handles, dtype=np.int64)
        self.cols = cols
        self.commit_ts = commit_ts
        self.alive = None
        self.n = len(self.handles_arr)
        self.w = 19
        self._prefix = tablecodec.record_prefix(table_id)
        self._keybuf = None
        self._key_mat = None
        self._rows = None  # (vbuf u8 array, starts, lens) once materialized

    @staticmethod
    def build(table_id: int, handles: np.ndarray, cols: list[ColSpec],
              commit_ts: int, presorted: bool = False) -> "ColumnarRun":
        handles = np.asarray(handles, dtype=np.int64)
        if not presorted and len(handles) > 1 and not (np.diff(handles) > 0).all():
            order = np.argsort(handles, kind="stable")
            handles = handles[order]
            cols = [c.take(order) for c in cols]
        return ColumnarRun(table_id, handles, cols, commit_ts)

    # --- lazy planes -------------------------------------------------------

    @property
    def key_mat(self) -> np.ndarray:
        if self._key_mat is None:
            from ..codec import rowfast

            self._key_mat = rowfast.record_key_matrix(self.table_id, self.handles_arr)
        return self._key_mat

    def _ensure_rows(self):
        if self._rows is None:
            from ..codec import rowfast

            buf, offs = rowfast.encode_rows_v2(
                [c.cid for c in self.cols],
                [c.kind for c in self.cols],
                [c.scale for c in self.cols],
                [c.data for c in self.cols],
                [c.valid for c in self.cols],
            )
            self._rows = (buf, offs[:-1].copy(), np.diff(offs))
        return self._rows

    @property
    def vbuf(self):
        return self._ensure_rows()[0]

    @property
    def starts(self) -> np.ndarray:
        return self._ensure_rows()[1]

    @property
    def lens(self) -> np.ndarray:
        return self._ensure_rows()[2]

    # --- key access without the matrix -------------------------------------

    def key_at(self, i: int) -> bytes:
        return self._prefix + _encode_be_handle(int(self.handles_arr[i]))

    def _bisect(self, key: bytes) -> int:
        p = self._prefix
        head = key[:11]
        if head != p:
            return 0 if head < p else self.n
        s = key[11:]
        if len(s) <= 8:
            # zero-padding preserves >= semantics: a key equal to the
            # padded probe is longer than (hence >) the raw probe, and
            # any key with the probe as a byte-prefix compares >= it
            probe, side = s + b"\x00" * (8 - len(s)), "left"
        else:
            probe, side = s[:8], "right"  # longer probe: equal-handle keys sort below it
        return int(np.searchsorted(self.handles_arr, _decode_be_handle(probe), side=side))

    def find(self, key: bytes) -> int:
        if len(key) != 19 or key[:11] != self._prefix:
            return -1
        h = _decode_be_handle(key[11:])
        i = int(np.searchsorted(self.handles_arr, h))
        if i < self.n and int(self.handles_arr[i]) == h and (self.alive is None or self.alive[i]):
            return i
        return -1

    def value(self, i: int) -> bytes:
        """Synthesize row i's v2 bytes on demand (point-get path); the
        full plane, once materialized, serves slices directly. A burst
        of per-row calls (a legacy pair scan walking the run) amortizes
        by materializing the whole plane after a small threshold instead
        of paying a full single-row encode per row."""
        if self._rows is not None:
            return super().value(i)
        self._value_calls = getattr(self, "_value_calls", 0) + 1
        if self._value_calls > 64:
            self._ensure_rows()
            return super().value(i)
        from ..codec import rowfast

        buf, offs = rowfast.encode_rows_v2(
            [c.cid for c in self.cols],
            [c.kind for c in self.cols],
            [c.scale for c in self.cols],
            [c.data[i : i + 1] for c in self.cols],
            [None if c.valid is None else c.valid[i : i + 1] for c in self.cols],
        )
        return buf.tobytes()

    def value_buffer(self) -> np.ndarray:
        return self._ensure_rows()[0]


class IntIndexRun(Run):
    """All-int secondary-index segment: `index_prefix + (0x03 + BE(col))*k
    [+ BE(handle)]` keys held as sorted int64 columns. Well-formed probes
    (whole 9-byte groups, the planner's index ranges and DML's exact
    index keys) binary-search the int columns; irregular probes (e.g. a
    chaos region split at a non-key byte boundary) fall back to the
    lazily-built key matrix. Unique-index values (the decimal-string
    handle) also build lazily."""

    def __init__(self, table_id: int, index_id: int, key_cols: list[np.ndarray],
                 handles: np.ndarray, unique: bool, commit_ts: int):
        from ..codec import tablecodec

        self.table_id = table_id
        self.index_id = index_id
        self.key_cols = [np.ascontiguousarray(c, dtype=np.int64) for c in key_cols]
        self.handles_arr = np.ascontiguousarray(handles, dtype=np.int64)
        self.unique = unique
        self.commit_ts = commit_ts
        self.alive = None
        self.n = len(self.handles_arr)
        self._prefix = tablecodec.index_prefix(table_id, index_id)
        self.w = len(self._prefix) + 9 * len(self.key_cols) + (0 if unique else 8)
        self._keybuf = None
        self._key_mat = None
        self._rows = None

    @staticmethod
    def build(table_id: int, index_id: int, key_cols: list[np.ndarray],
              handles: np.ndarray, unique: bool, commit_ts: int) -> "IntIndexRun":
        cols, handles = sort_int_key_cols(
            [np.asarray(c, dtype=np.int64) for c in key_cols],
            np.asarray(handles, dtype=np.int64),
        )
        return IntIndexRun(table_id, index_id, cols, handles, unique, commit_ts)

    @property
    def key_mat(self) -> np.ndarray:
        if self._key_mat is None:
            from ..codec import rowfast

            self._key_mat = rowfast.int_index_key_matrix(
                self.table_id, self.index_id, self.key_cols,
                None if self.unique else self.handles_arr,
            )
        return self._key_mat

    def _ensure_rows(self):
        if self._rows is None:
            if self.unique:
                from ..codec import rowfast

                vbuf, starts, lens = rowfast.handle_value_buffer(self.handles_arr)
                self._rows = (np.frombuffer(vbuf, dtype=np.uint8), starts, lens)
            else:
                z = np.zeros(self.n, dtype=np.int64)
                self._rows = (np.empty(0, dtype=np.uint8), z, z.copy())
        return self._rows

    @property
    def vbuf(self):
        return self._ensure_rows()[0]

    @property
    def starts(self) -> np.ndarray:
        return self._ensure_rows()[1]

    @property
    def lens(self) -> np.ndarray:
        return self._ensure_rows()[2]

    def value(self, i: int) -> bytes:
        return str(int(self.handles_arr[i])).encode() if self.unique else b""

    def key_at(self, i: int) -> bytes:
        parts = [self._prefix]
        for c in self.key_cols:
            parts.append(b"\x03" + _encode_be_handle(int(c[i])))
        if not self.unique:
            parts.append(_encode_be_handle(int(self.handles_arr[i])))
        return b"".join(parts)

    def _levels(self) -> list[np.ndarray]:
        return self.key_cols + ([] if self.unique else [self.handles_arr])

    def _parse_probe(self, key: bytes):
        """Decompose a probe into complete int levels → (values, side) or
        None when the probe doesn't follow the key structure."""
        plen = len(self._prefix)
        head = key[:plen]
        if head != self._prefix:
            return ("before",) if head < self._prefix else ("after",)
        rest = key[plen:]
        vals = []
        for li in range(len(self.key_cols)):
            if not rest:
                break
            if len(rest) < 9 or rest[0] != 0x03:
                return None  # partial/odd group: matrix fallback
            vals.append((li, _decode_be_handle(rest[1:9])))
            rest = rest[9:]
        else:
            if rest and not self.unique:
                if len(rest) < 8:
                    return None
                vals.append((len(self.key_cols), _decode_be_handle(rest[:8])))
                rest = rest[8:]
        if rest == b"":
            return (vals, "left")
        if not any(rest):
            # trailing zeros: a key that merely EXTENDS the parsed groups
            # still compares >= the probe ('left'), but a key consisting
            # of EXACTLY the parsed groups is a byte-prefix of the probe
            # and sorts BELOW it — the successor-key idiom key+b'\\x00'
            # must land AFTER the equal key ('right')
            full = len(vals) == len(self._levels())
            return (vals, "right" if full else "left")
        return None

    def _bisect(self, key: bytes) -> int:
        parsed = self._parse_probe(key)
        if parsed is None:
            return super()._bisect(key)  # byte compare over synthesized keys
        if parsed == ("before",):
            return 0
        if parsed == ("after",):
            return self.n
        vals, side = parsed
        levels = self._levels()
        lo, hi = 0, self.n
        for li, v in vals:
            arr = levels[li]
            lo2 = lo + int(np.searchsorted(arr[lo:hi], v, side="left"))
            hi = lo + int(np.searchsorted(arr[lo:hi], v, side="right"))
            lo = lo2
            if lo >= hi:
                return lo
        return hi if side == "right" else lo

    def find(self, key: bytes) -> int:
        if len(key) != self.w:
            return -1
        i = self._bisect(key)
        if i < self.n and self.key_at(i) == key and (self.alive is None or self.alive[i]):
            return i
        return -1


def sort_int_key_cols(cols: list[np.ndarray], handles: np.ndarray
                      ) -> tuple[list[np.ndarray], np.ndarray]:
    """Order (cols..., handle) tuples ascending — the memcomparable key
    order of sign-flipped big-endian int keys.

    Single-col fast paths exploit frame-of-reference + common-stride
    reduction (packed dates are all multiples of 86400e6 — the
    'pack' codec trick applied to sorting):

      * codes fit int16 → stable radix ARGSORT over the narrow codes
        (numpy's radix kicks in at ≤16-bit keys; handle order within
        equal codes rides on stability, so handles never join the key),
        the sorted column rebuilds from bincount+repeat, and arange
        handles (the auto-alloc case) come back as `order + first` —
        no 128MB gathers at all;
      * codes + handle bits fit one int64 → pack and np.sort (radix,
        no permutation array);
      * else → stable lexsort."""
    n = len(handles)
    if n <= 1:
        return cols, handles
    if len(cols) == 1:
        fast = _sort_single_col(cols[0], handles)
        if fast is not None:
            return fast
    order = np.lexsort((handles, *cols[::-1]))
    return [c[order] for c in cols], handles[order]


def _sort_single_col(col: np.ndarray, handles: np.ndarray):
    n = len(handles)
    c_lo, c_hi = int(col.min()), int(col.max())
    h_lo, h_hi = int(handles.min()), int(handles.max())
    if c_hi - c_lo >= 1 << 62 or h_hi - h_lo >= 1 << 62:
        return None  # checked BEFORE subtracting: int64 span overflow
    g = int(np.gcd.reduce(col[:4096] - c_lo))
    if g > 1:
        q, r = np.divmod(col - c_lo, g)
        if r.any():  # sample stride doesn't hold globally
            g, q = 1, col - c_lo
    else:
        g, q = 1, col - c_lo
    span = (c_hi - c_lo) // g
    if span < (1 << 15) and (n <= 1 or bool((np.diff(handles) >= 0).all())):
        # ASCENDING handles only (the bulk path always passes the sorted
        # record plane's handles): stability then makes within-code input
        # order equal handle order, so handles never need to join the key
        order = np.argsort(q.astype(np.int16), kind="stable")
        counts = np.bincount(q, minlength=span + 1)
        c_s = np.repeat(np.arange(span + 1, dtype=np.int64) * g + c_lo, counts)
        if h_lo + n - 1 == h_hi and bool((np.diff(handles) == 1).all()):
            h_s = order + h_lo  # arange handles: the permutation IS the answer
        else:
            h_s = handles[order]
        return [c_s], h_s
    bits_h = max(1, (h_hi - h_lo).bit_length())
    if span.bit_length() + bits_h > 62:
        return None
    pk = np.sort((q << bits_h) | (handles - h_lo), kind="stable")
    c_s = (pk >> bits_h) * g + c_lo
    h_s = (pk & ((1 << bits_h) - 1)) + h_lo
    return [c_s], h_s


class SegmentView:
    """A scan's view of one run slice, minus dropped (shadowed) rows."""

    __slots__ = ("run", "i", "j", "drop")

    def __init__(self, run: Run, i: int, j: int, drop: set[int] | None = None):
        self.run = run
        self.i = i
        self.j = j
        self.drop = drop  # absolute row indices within run

    def keep_idx(self) -> np.ndarray:
        """Absolute row indices surviving drop + alive mask, in key order."""
        idx = np.arange(self.i, self.j, dtype=np.int64)
        if self.run.alive is not None:
            idx = idx[self.run.alive[self.i : self.j]]
        if self.drop:
            idx = idx[~np.isin(idx, np.fromiter(self.drop, np.int64, len(self.drop)))]
        return idx

    @property
    def n_rows(self) -> int:
        return len(self.keep_idx())

    def min_key(self) -> bytes:
        return self.run.key_at(self.i)

    def max_key(self) -> bytes:
        return self.run.key_at(self.j - 1)

    def pairs(self) -> list[tuple[bytes, bytes]]:
        """Materialize (key, value) pairs — the legacy-scan compat path."""
        r = self.run
        return [(r.key_at(int(i)), r.value(int(i))) for i in self.keep_idx()]
