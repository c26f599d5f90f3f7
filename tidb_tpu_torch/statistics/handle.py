"""Stats lifecycle: cache, DML deltas, persistence, auto-analyze policy
(copy of tidb_tpu/statistics/handle.py; ref: statistics/handle/handle.go:74, update.go:866 NeedAnalyzeTable).

The handle hangs off Storage so every session over the store shares one
stats view (the reference loads from mysql.stats_* tables; here stats
persist as JSON blobs in the meta keyspace `m_stats_{table_id}`)."""

from __future__ import annotations

import json

from ..codec import tablecodec
from ..planner.ranger import prefix_next
from .tablestats import TableStats, build_table_stats

AUTO_ANALYZE_RATIO = 0.5
AUTO_ANALYZE_MIN_COUNT = 1000

_STATS_PREFIX = b"m_stats_"


def _stats_key(table_id: int) -> bytes:
    return _STATS_PREFIX + str(table_id).encode()


class StatsHandle:
    def __init__(self, storage):
        self.storage = storage
        self.cache: dict[int, TableStats] = {}
        self.generation = 0  # bumped on stats writes; plan caches key on it

    # --- access ------------------------------------------------------------

    def get(self, table_id: int) -> TableStats | None:
        ts = self.cache.get(table_id)
        if ts is not None:
            return ts
        raw = self.storage.mvcc.get(_stats_key(table_id), self.storage.tso.current())
        if raw is None:
            return None
        ts = TableStats.from_json(json.loads(raw))
        self.cache[table_id] = ts
        return ts

    # --- analyze -----------------------------------------------------------

    def analyze_table(self, session, info) -> TableStats:
        """Full-table stats build over the cop client's columnar batches
        (ref: executor/analyze.go pushing sample collection to the store)."""
        read_ts = session.store.tso.next()
        cop = session.cop
        batches = []
        for pid in info.physical_ids():
            phys = info.partition_physical(pid) if info.partition else info
            prefix = tablecodec.record_prefix(pid)
            for region, s, e in session.store.regions.split_ranges(prefix, prefix_next(prefix)):
                batches.append(cop.tiles.get_batch(phys, s, e, read_ts))
        ts = build_table_stats(info, batches, read_ts)
        self.save(ts, session)
        return ts

    def save(self, ts: TableStats, session) -> None:
        self.generation += 1
        self.cache[ts.table_id] = ts
        txn = session.store.begin()
        txn.put(_stats_key(ts.table_id), json.dumps(ts.to_json()).encode())
        txn.commit()

    def dump(self, session, info, build_if_missing: bool = False) -> dict | None:
        """JSON stats dump for one table (ref: statistics/handle/dump.go
        DumpStatsToJSON; column ids are carried with their names so a
        load can remap onto a re-created table). Returns None when no
        stats exist unless build_if_missing — HTTP GETs must not trigger
        a full ANALYZE as a side effect."""
        ts = self.get(info.id)
        if ts is None:
            if not build_if_missing:
                return None
            ts = self.analyze_table(session, info)
        return {
            "database_name": info.db_name,
            "table_name": info.name,
            "stats": ts.to_json(),
            "col_names": {str(c.id): c.name for c in info.columns},
        }

    def load_dump(self, session, d: dict) -> None:
        """Install a dumped stats JSON onto the current schema's table of
        the same name, remapping column ids by column NAME (ref:
        handle/dump.go LoadStatsFromJSON)."""
        info = session.infoschema().table(d["database_name"], d["table_name"])
        ts = TableStats.from_json(d["stats"])
        name_by_old = {int(k): v for k, v in d.get("col_names", {}).items()}
        cur_by_name = {c.name.lower(): c.id for c in info.columns}
        cols = {}
        for old_id, cs in ts.columns.items():
            new_id = cur_by_name.get((name_by_old.get(old_id) or "").lower())
            if new_id is not None:  # dropped/renamed columns are skipped,
                cols[new_id] = cs   # never attached to an unrelated id
        ts.columns = cols
        ts.table_id = info.id
        self.save(ts, session)

    def drop_table(self, table_id: int, session) -> None:
        self.cache.pop(table_id, None)
        txn = session.store.begin()
        txn.delete(_stats_key(table_id))
        txn.commit()

    # --- DML delta + auto-analyze (ref: handle/update.go) -------------------

    def report_delta(self, table_id: int, changed: int, delta_rows: int = 0) -> None:
        self.generation += 1  # DML re-costs: plan caches must not go stale
        ts = self.cache.get(table_id)
        if ts is not None:
            ts.modify_count += changed
            ts.row_count = max(0, ts.row_count + delta_rows)

    def needs_analyze(self, table_id: int) -> bool:
        ts = self.cache.get(table_id)
        if ts is None:
            return False
        if ts.modify_count < AUTO_ANALYZE_MIN_COUNT:
            return False
        return ts.modify_count > ts.row_count * AUTO_ANALYZE_RATIO

    def auto_analyze(self, session) -> list[int]:
        """Re-analyze any table whose modify ratio crossed the trigger
        (ref: domain.go:1337 autoAnalyzeWorker — called at statement
        boundaries instead of from a background loop)."""
        done = []
        for tid in list(self.cache):
            if self.needs_analyze(tid):
                info = session.infoschema().table_by_id(tid)
                if info is not None:
                    self.analyze_table(session, info)
                    done.append(tid)
        return done
