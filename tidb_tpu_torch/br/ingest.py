"""Lightning-style shared bulk-ingest engine (copy of tidb_tpu/br/ingest.py)
— the ONE path both `LOAD DATA INFILE` (br/importer.py, a later slice of
the port) and `models/tpch.bulk_load` drive (ref: br/pkg/lightning local backend: encode rows into sorted KV
artifacts off the write path, then ingest them as a unit).

Pipeline: columnar input → vectorized canonicalization (int64/uint64/
float64 lanes, scaled-decimal int64, 'S<w>' string arrays — numpy, no
per-row Datum work) → sorted KV artifacts (storage/segment.ColumnarRun
for the record plane, IntIndexRun for all-int secondary indexes, a byte
Run for everything else) → ONE atomic publish: a single WAL ingest
record (`rec_ingest`) so recovery and shipped standbys see the whole
ingest or none of it, one data-version bump, one tile/build-cache
invalidation — never per batch.

Concurrency contract: the ingest window EXCLUDES online DDL on the
target table both ways — `BulkIngest` refuses to start while a DDL job
on the table is queued/running, and the DDL worker parks its job steps
while `Storage.table_ingesting` reports a live window. Session-level
schema changes that bypass the job queue are caught by the schema
fingerprint re-check at publish (the ingest aborts instead of publishing
rows encoded against a stale schema).

`SET tidb_bulk_ingest = OFF` routes both entry points back to their
legacy paths (per-batch segment ingest for bulk_load, 2000-row txn
batches for LOAD DATA) as a live fallback.
"""

from __future__ import annotations

import numpy as np

from ..codec import tablecodec
from ..errors import DuplicateEntry, TiDBError
from ..mysqltypes.datum import Datum, K_DEC, K_FLOAT, K_INT, K_STR, K_TIME, K_UINT
from ..mysqltypes.mydecimal import Dec
from ..storage.segment import ColSpec, ColumnarRun, IntIndexRun, Run
from ..utils import metrics as M
from ..utils.failpoint import inject as _fp

INT_KINDS = (K_INT, K_TIME)  # kinds whose index keys encode as 0x03+BE(int)


class IngestAborted(TiDBError):
    """The ingest window could not start or publish (concurrent DDL,
    schema changed under the window). Nothing became visible."""


def publish_barrier(store, table_id: int, tiles=None) -> None:
    """The shared publish tail every segment producer runs AFTER its WAL
    record is appended (bulk ingest here, the delta-main compactor in
    storage/compact.py): the semi-sync durability wait, then ONE
    data-version bump — which invalidates every session's version-checked
    tile/build-side cache entries for the table. Pass the local session's
    tile cache to ALSO drop its decoded tiles eagerly (remote sessions
    re-validate via the version bump alone)."""
    # full publish durability point: the record is already fsynced locally
    # (the producer syncs under the kv lock), but a semi-sync primary must
    # ALSO wait for the standby's ack before this publish may ack — the
    # kill-primary→promote crashpoint round caught exactly this gap.
    # Group-commit ON makes this a covered-seq fast path, never a second
    # fsync.
    store.wal_sync()
    # ONE schema-version barrier for the whole publish: data version bump
    # + tile/build-side invalidation, not per batch
    store.bump_version([tablecodec.record_prefix(table_id)])
    if tiles is not None:
        tiles.invalidate_table(table_id)


def kind_of(ft) -> int:
    """Column kind for the bulk codecs. A K_INT fallthrough bug once
    lived here: DOUBLE/FLOAT columns fell through to K_INT and were
    silently truncated to integers — floats now map to K_FLOAT, and
    UNSIGNED ints to K_UINT (a K_INT unsigned lane would emit 0x03
    INT_FLAG index keys where the txn path emits 0x04 UINT_FLAG — the
    two routes' index entries would never match)."""
    if ft.is_decimal():
        return K_DEC
    if ft.is_float():
        return K_FLOAT
    if ft.is_time():
        return K_TIME
    if ft.is_string():
        return K_STR
    if ft.is_unsigned:
        return K_UINT
    return K_INT


def datum_for(kind: int, value, scale: int = 0) -> Datum:
    """ONE kind→Datum routing switch for every per-row bulk fallback
    (this engine's slow index path AND models/tpch's legacy per-row
    paths) — a K_INT fallthrough survived as long as it did
    while three hand-copied versions of this dispatch existed."""
    if kind == K_DEC:
        return Datum.d(Dec(int(value), scale))
    if kind == K_FLOAT:
        return Datum.f(float(value))
    if kind == K_STR:
        if isinstance(value, bytes):
            return Datum.s(value.decode("utf8"))
        return Datum.s(str(value))
    return Datum(int(kind), int(value))


def _schema_fingerprint(info) -> tuple:
    """What the encoded artifact depends on: column identities/kinds and
    the writable index set. Changes here between begin and publish mean
    the artifact no longer matches the table — the ingest must abort."""
    return (
        tuple((c.id, c.offset, c.name, kind_of(c.ft), max(c.ft.decimal, 0))
              for c in info.columns),
        # state-"none" indexes are invisible to the ingest (no plane is
        # built for them) AND legal to appear mid-window: an ALTER that
        # enqueued during the window parks at state none until the
        # window closes, then backfills over the published rows
        tuple((ix.id, ix.state, ix.unique, tuple(ix.col_offsets))
              for ix in info.indexes if ix.state != "none"),
        info.pk_is_handle,
    )


class BulkIngest:
    """One bulk-ingest window over one table: build sorted KV artifacts
    from columnar input, publish them atomically. Use as a context
    manager; an exception (or explicit abort) leaves NOTHING visible."""

    def __init__(self, session, info, db: str | None = None,
                 enforce_unique: bool = False, require_empty: bool = False):
        self.session = session
        self.store = session.store
        self.info = info
        self._db = db or session.current_db
        # in-batch pk/unique-key duplicate detection (LOAD DATA parity
        # with the txn path; bulk_load keeps the documented Lightning
        # ingest semantics — the caller owns dedup)
        self.enforce_unique = enforce_unique
        # Lightning physical-mode restriction, enforced ATOMICALLY: the
        # publish re-checks table emptiness under the kv lock, so a
        # commit racing in between an advance check and the publish
        # aborts the ingest instead of being silently shadowed
        self.require_empty = require_empty
        self._runs: list = []
        self._rows = 0
        self._bytes = 0
        self._open = False
        self._fingerprint = _schema_fingerprint(info)
        self.store.begin_table_ingest(info.id)
        self._open = True
        try:
            self._check_no_ddl()
        except BaseException:
            self.close()
            raise

    def _check_no_ddl(self) -> None:
        txn = self.store.begin()
        try:
            from ..catalog.meta import Meta

            jobs = Meta(txn).jobs()
        finally:
            txn.rollback()
        for job in jobs:
            if job.table_id == self.info.id:
                raise IngestAborted(
                    f"bulk ingest into {self.info.name!r} refused: DDL job "
                    f"{job.id} ({job.type}) is queued/running on the table — "
                    f"the ingest window excludes concurrent DDL"
                )

    # --- artifact build ----------------------------------------------------

    def add_columns(self, names: list[str], arrays: list[np.ndarray],
                    kinds: list[int] | None = None,
                    valids: list[np.ndarray | None] | None = None) -> int:
        """Vectorized encode of one columnar batch into pending runs.
        `arrays` follow the bulk_load contract: decimal lanes carry
        already-scaled int64 values at the column's schema scale. The
        ingest takes OWNERSHIP of the arrays (they become the store's
        segment payloads — callers must not mutate them afterwards)."""
        info = self.info
        col_infos = [info.col_by_name(n) for n in names]
        if kinds is None:
            kinds = [kind_of(c.ft) for c in col_infos]
        n = len(arrays[0]) if arrays else 0
        if n == 0:
            return 0

        specs: list[ColSpec] = []
        canon: list[np.ndarray] = []
        for c, k, arr in zip(col_infos, kinds, arrays):
            v = None
            if k == K_STR:
                # object str arrays pass through UNCONVERTED on in-memory
                # stores: they are already the scan-side chunk form. On a
                # DURABLE store they canonicalize NOW — the WAL 'C' record
                # stores 'S' lanes (which strip trailing NULs, the v2
                # heuristic accepted project-wide), and memory must serve
                # the SAME bytes recovery will (never diverge from the
                # durable state the ack promised)
                data = np.asarray(arr)
                if data.dtype.kind == "U" or (
                    data.dtype.kind == "O" and self.store.wal is not None
                ):
                    from ..storage.segment import canonical_str_array

                    data = canonical_str_array(data)
            elif k == K_FLOAT:
                data = np.ascontiguousarray(arr, dtype=np.float64)
            elif k == K_UINT:
                data = np.ascontiguousarray(arr, dtype=np.uint64)
            else:
                data = np.asarray(arr).astype(np.int64, copy=False)
            canon.append(data)
            scale = max(c.ft.decimal, 0) if k == K_DEC else 0
            specs.append(ColSpec(c.id, k, scale, data, v))
        if valids is not None:
            for spec, v in zip(specs, valids):
                if v is not None and not v.all():
                    spec.valid = np.ascontiguousarray(v, dtype=bool)

        # handles: clustered int pk IS the handle; else batch-alloc
        if info.pk_is_handle:
            hc = info.handle_col()
            pos = next(i for i, c in enumerate(col_infos) if c.offset == hc.offset)
            handles = canon[pos]
            if handles.dtype == np.uint64:
                # record keys order by the SIGNED bit pattern (sign-flip
                # BE), and uint64 np.diff wraps to always-positive —
                # out-of-order unsigned pks would pass as presorted
                handles = handles.view(np.int64)
            presorted = bool((np.diff(handles) > 0).all()) if n > 1 else True
        else:
            first = self.session.alloc_auto_id(info, n)
            handles = np.arange(first, first + n, dtype=np.int64)
            presorted = True

        rec = ColumnarRun.build(info.id, handles, specs, 0, presorted=presorted)
        if not presorted:
            # index planes follow the sorted order — data, handles AND
            # valid masks (rec.cols are the take()-reordered specs; the
            # unsorted originals would attribute NULLs to the wrong rows)
            handles = rec.handles_arr
            specs = rec.cols
            canon = [s.data for s in specs]
        if self.enforce_unique and rec.n > 1 and bool(
            (np.diff(rec.handles_arr) == 0).any()
        ):
            dup = int(rec.handles_arr[np.nonzero(np.diff(rec.handles_arr) == 0)[0][0]])
            raise DuplicateEntry(f"Duplicate entry '{dup}' for key 'PRIMARY'")
        self._runs.append(rec)
        self._bytes += int(handles.nbytes) + sum(int(d.nbytes) for d in canon)

        # secondary indexes (skip unwritable states and the clustered pk)
        pos_by_off = {c.offset: i for i, c in enumerate(col_infos)}
        for ix in info.indexes:
            if ix.state in ("none", "delete_only") or (info.pk_is_handle and ix.primary):
                continue
            poss = [pos_by_off.get(off) for off in ix.col_offsets]
            # NULL-bearing index columns must take the per-row path: the
            # int-key fast plane would index the 0 placeholder as a real
            # value (and trip a spurious unique-dup on multiple NULLs) —
            # index_value_key encodes NULL keys properly, handle-suffixed
            # so MySQL's many-NULLs-in-a-unique-index semantics hold
            has_null = any(
                p is not None and specs[p].valid is not None for p in poss
            )
            if not has_null and all(p is not None and kinds[p] in INT_KINDS for p in poss):
                kcols = [canon[p] for p in poss]
                run = IntIndexRun.build(info.id, ix.id, kcols, handles, ix.unique, 0)
                if self.enforce_unique and ix.unique and run.n > 1:
                    same = np.ones(run.n - 1, dtype=bool)
                    for c in run.key_cols:  # sorted: duplicates are adjacent
                        same &= np.diff(c) == 0
                    if bool(same.any()):
                        i = int(np.nonzero(same)[0][0])
                        vals = "-".join(str(int(c[i])) for c in run.key_cols)
                        raise DuplicateEntry(
                            f"Duplicate entry '{vals}' for key '{ix.name}'"
                        )
                self._runs.append(run)
                self._bytes += sum(int(c.nbytes) for c in run.key_cols)
            else:  # string/decimal/missing/NULL-bearing index cols — per-row fallback
                kvs: list[tuple[bytes, bytes]] = []
                self._slow_index_kvs(ix, col_infos, canon, kinds, handles, kvs,
                                     [s.valid for s in specs])
                if self.enforce_unique and ix.unique:
                    seen = set()
                    for k, _v in kvs:
                        if k in seen:
                            raise DuplicateEntry(
                                f"Duplicate entry for key '{ix.name}'"
                            )
                        seen.add(k)
                self._runs.extend(runs_from_kvs(kvs, 0))
                self._bytes += sum(len(k) + len(v) for k, v in kvs)
        self._rows += n
        M.INGEST_BYTES.inc(
            int(handles.nbytes) + sum(int(d.nbytes) for d in canon), stage="encode"
        )
        return n

    def _slow_index_kvs(self, ix, col_infos, canon, kinds, handles, kvs,
                        valids=None) -> None:
        from ..table.table import Table

        info = self.info
        tbl = Table(info)
        n_tbl_cols = len(info.columns)
        offsets = [c.offset for c in col_infos]
        scales = [max(c.ft.decimal, 0) if k == K_DEC else 0
                  for c, k in zip(col_infos, kinds)]
        if valids is None:
            valids = [None] * len(col_infos)
        for i in range(len(handles)):
            full = [Datum.null()] * n_tbl_cols
            for off, arr, k, sf, vm in zip(offsets, canon, kinds, scales, valids):
                if vm is not None and not vm[i]:
                    continue  # NULL stays Datum.null()
                full[off] = datum_for(k, arr[i], sf)
            for c in info.columns:
                if c.hidden and c.name == "_tidb_rowid":
                    full[c.offset] = Datum.i(int(handles[i]))
            ikey, ival, _ = tbl.index_value_key(ix, full, int(handles[i]))
            kvs.append((ikey, ival))

    # --- publish -----------------------------------------------------------

    def commit(self) -> int:
        """Publish every pending run atomically: one WAL ingest record,
        one version bump, one cache invalidation. A crash before the WAL
        append leaves the ingest fully absent; after it, fully visible."""
        if not self._open:
            raise IngestAborted("ingest window already closed")
        # crashpoint: artifacts built and sorted, NOTHING journaled or
        # published — recovery must see the ingest as absent
        _fp("ingest/after-artifact-before-publish")
        if _schema_fingerprint(self.info_now()) != self._fingerprint:
            self.close()
            raise IngestAborted(
                f"bulk ingest into {self.info.name!r} aborted: the table's "
                f"schema changed during the ingest window (nothing published)"
            )
        try:
            runs = self._runs
            commit_ts = self.store.tso.next()
            for r in runs:
                r.commit_ts = commit_ts
            self.store.mvcc.ingest_runs(runs, precondition=self._precondition())
            publish_barrier(self.store, self.info.id,
                            tiles=self.session.cop.tiles)
            M.INGEST_ROWS.inc(self._rows)
            if self.store.wal is not None:
                M.INGEST_BYTES.inc(self._bytes, stage="wal")
            M.INGEST_BYTES.inc(self._bytes, stage="publish")
            return self._rows
        finally:
            self.close()

    def _precondition(self):
        if not self.require_empty:
            return None
        from ..planner.ranger import prefix_next

        prefix = tablecodec.record_prefix(self.info.id)
        end = prefix_next(prefix)
        mvcc = self.store.mvcc

        def check():  # runs under the kv lock, before anything journals
            if mvcc.range_occupied(prefix, end):
                raise IngestAborted(
                    f"bulk ingest into {self.info.name!r} aborted: the table "
                    f"gained rows (or in-flight locks) during the ingest "
                    f"window — conflicts need the txn path (nothing published)"
                )

        return check

    def info_now(self):
        """Re-fetch the table info as the publish-time schema witness."""
        try:
            t = self.session.infoschema().table(self._db, self.info.name)
        except TiDBError:
            self.close()
            raise IngestAborted(
                f"bulk ingest aborted: table {self.info.name!r} vanished "
                f"during the ingest window"
            ) from None
        if t.id != self.info.id:
            self.close()
            raise IngestAborted(
                f"bulk ingest aborted: table {self.info.name!r} was dropped "
                f"and recreated during the ingest window"
            )
        return t

    def close(self) -> None:
        if self._open:
            self._open = False
            self.store.end_table_ingest(self.info.id)

    def abort(self) -> None:
        self._runs = []
        self.close()

    def __del__(self):  # leaked windows must not block DDL forever
        self.close()

    def __enter__(self) -> "BulkIngest":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self._open:
            self.commit()
        else:
            self.abort()


def runs_from_kvs(kvs: list[tuple[bytes, bytes]], commit_ts: int) -> list[Run]:
    """Arbitrary (key, value) pairs → fixed-width byte Runs (one per key
    width), sorted but NOT published — the BulkIngest building block the
    old mvcc.ingest published eagerly."""
    by_w: dict[int, list[tuple[bytes, bytes]]] = {}
    for k, v in kvs:
        by_w.setdefault(len(k), []).append((k, v))
    runs = []
    for w, group in by_w.items():
        n = len(group)
        key_mat = np.frombuffer(b"".join(k for k, _ in group), dtype=np.uint8).reshape(n, w)
        vbuf = b"".join(v for _, v in group)
        lens = np.fromiter((len(v) for _, v in group), np.int64, n)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        runs.append(Run.build(key_mat, vbuf, starts, lens, commit_ts))
    return runs
