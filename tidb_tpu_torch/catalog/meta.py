"""Meta KV layout (copy of tidb_tpu/catalog/meta.py; ref: meta/meta.go +
structure/ — fresh key design).

All schema metadata lives in the same transactional KV as table data, under
the b'm' prefix (sorts before all b't...' record keys):

  m:nextid           → global id allocator counter
  m:schema_version   → monotonically increasing schema version
  m:db:<name>        → DBInfo json
  m:tbl:<id>         → TableInfo json

Every DDL runs inside a normal 2PC txn over these keys, so concurrent DDL
conflicts surface as WriteConflict and retry — a deliberately simpler
model than the reference's async job queues (ddl/ddl_worker.go), kept
compatible in behavior for the single-coordinator case; the online
state-machine lives in ddl.py above this layer.
"""

from __future__ import annotations

import json

from .schema import DBInfo, TableInfo

K_NEXT_ID = b"m:nextid"
K_SCHEMA_VER = b"m:schema_version"
P_DB = b"m:db:"
P_TBL = b"m:tbl:"
P_JOB = b"m:job:"  # queued/running DDL jobs (ref: meta job queues, ddl_worker.go:67)
P_JOB_HIST = b"m:jobh:"  # finished jobs (ADMIN SHOW DDL JOBS)
P_SEQ = b"m:seq:"  # sequences (ref: ddl sequence objects, meta/autoid SequenceAllocator)
P_VIEW = b"m:view:"  # view definitions (stored SELECT text)
P_RG = b"m:rg:"  # resource groups (ref: meta.go ResourceGroup key space, DDL-managed)
P_RW = b"m:rw:"  # runaway watch list (sched/runaway.py): persisted KILL/
# COOLDOWN/DRYRUN digest watches so repeat offenders stay rejected across
# store restart (ref: mysql.tidb_runaway_watch, swept by TTL on load)


class Meta:
    """Meta accessor bound to one transaction."""

    def __init__(self, txn):
        self.txn = txn

    # --- id allocation -----------------------------------------------------

    def alloc_id(self, n: int = 1) -> int:
        cur = int(self.txn.get(K_NEXT_ID) or b"100")
        self.txn.put(K_NEXT_ID, str(cur + n).encode())
        return cur

    # --- schema version ----------------------------------------------------

    def schema_version(self) -> int:
        return int(self.txn.get(K_SCHEMA_VER) or b"0")

    def bump_schema_version(self) -> int:
        v = self.schema_version() + 1
        self.txn.put(K_SCHEMA_VER, str(v).encode())
        return v

    # --- databases ---------------------------------------------------------

    def db(self, name: str) -> DBInfo | None:
        raw = self.txn.get(P_DB + name.lower().encode())
        return DBInfo.from_json(json.loads(raw)) if raw else None

    def put_db(self, db: DBInfo) -> None:
        self.txn.put(P_DB + db.name.lower().encode(), json.dumps(db.to_json()).encode())

    def drop_db(self, name: str) -> None:
        self.txn.delete(P_DB + name.lower().encode())

    def list_dbs(self) -> list[DBInfo]:
        out = []
        for _, v in self.txn.scan(P_DB, P_DB + b"\xff"):
            out.append(DBInfo.from_json(json.loads(v)))
        return out

    # --- tables ------------------------------------------------------------

    def table(self, tid: int) -> TableInfo | None:
        raw = self.txn.get(P_TBL + str(tid).encode())
        return TableInfo.from_json(json.loads(raw)) if raw else None

    def put_table(self, t: TableInfo) -> None:
        self.txn.put(P_TBL + str(t.id).encode(), json.dumps(t.to_json()).encode())

    def drop_table(self, tid: int) -> None:
        self.txn.delete(P_TBL + str(tid).encode())

    def list_tables(self) -> list[TableInfo]:
        out = []
        for _, v in self.txn.scan(P_TBL, P_TBL + b"\xff"):
            out.append(TableInfo.from_json(json.loads(v)))
        return out

    # --- sequences (ref: 2020-04-17-sql-sequence.md; cached allocation) ----

    @staticmethod
    def _seq_key(db: str, name: str) -> bytes:
        return P_SEQ + f"{db.lower()}.{name.lower()}".encode()

    def sequence(self, db: str, name: str) -> dict | None:
        raw = self.txn.get(self._seq_key(db, name))
        return json.loads(raw) if raw else None

    def put_sequence(self, d: dict) -> None:
        self.txn.put(self._seq_key(d["db"], d["name"]), json.dumps(d).encode())

    def drop_sequence(self, db: str, name: str) -> None:
        self.txn.delete(self._seq_key(db, name))

    def list_sequences(self) -> list[dict]:
        return [json.loads(v) for _, v in self.txn.scan(P_SEQ, P_SEQ + b"\xff")]

    # --- views (ref: ddl_api.go CreateView; definition stored as text) -----

    @staticmethod
    def _view_key(db: str, name: str) -> bytes:
        return P_VIEW + f"{db.lower()}.{name.lower()}".encode()

    def view(self, db: str, name: str) -> dict | None:
        raw = self.txn.get(self._view_key(db, name))
        return json.loads(raw) if raw else None

    def put_view(self, d: dict) -> None:
        self.txn.put(self._view_key(d["db"], d["name"]), json.dumps(d).encode())

    def drop_view(self, db: str, name: str) -> None:
        self.txn.delete(self._view_key(db, name))

    def list_views(self) -> list[dict]:
        return [json.loads(v) for _, v in self.txn.scan(P_VIEW, P_VIEW + b"\xff")]

    # --- resource groups (ref: meta.go CreateResourceGroup; stored as the
    # group's keepalive-free spec dict, cached by sched.ResourceGroupManager) -

    @staticmethod
    def _rg_key(name: str) -> bytes:
        return P_RG + name.lower().encode()

    def resource_group(self, name: str) -> dict | None:
        raw = self.txn.get(self._rg_key(name))
        return json.loads(raw) if raw else None

    def put_resource_group(self, d: dict) -> None:
        self.txn.put(self._rg_key(d["name"]), json.dumps(d).encode())

    def drop_resource_group(self, name: str) -> None:
        self.txn.delete(self._rg_key(name))

    def list_resource_groups(self) -> list[dict]:
        return [json.loads(v) for _, v in self.txn.scan(P_RG, P_RG + b"\xff")]

    # --- runaway watch list (ref: mysql.tidb_runaway_watch; spec dicts
    # carry WALL-clock expiry so a restart can rebuild monotonic TTLs) ---

    @staticmethod
    def _rw_key(group: str, digest: str) -> bytes:
        return P_RW + f"{group}:{digest}".encode()

    def put_runaway_watch(self, d: dict) -> None:
        self.txn.put(self._rw_key(d["group"], d["digest"]), json.dumps(d).encode())

    def drop_runaway_watch(self, group: str, digest: str) -> None:
        self.txn.delete(self._rw_key(group, digest))

    def list_runaway_watches(self) -> list[dict]:
        return [json.loads(v) for _, v in self.txn.scan(P_RW, P_RW + b"\xff")]

    # --- DDL job queue (ref: ddl.go:535 doDDLJob, meta job lists) ----------

    @staticmethod
    def _job_key(jid: int) -> bytes:
        return P_JOB + f"{jid:012d}".encode()  # zero-pad: queue scans in id order

    def put_job(self, job) -> None:
        self.txn.put(self._job_key(job.id), json.dumps(job.to_json()).encode())

    def job(self, jid: int):
        from ..ddl.jobs import DDLJob

        raw = self.txn.get(self._job_key(jid))
        return DDLJob.from_json(json.loads(raw)) if raw else None

    def first_job(self):
        from ..ddl.jobs import DDLJob

        for _, v in self.txn.scan(P_JOB, P_JOB + b"\xff", limit=1):
            return DDLJob.from_json(json.loads(v))
        return None

    def jobs(self) -> list:
        from ..ddl.jobs import DDLJob

        return [DDLJob.from_json(json.loads(v)) for _, v in self.txn.scan(P_JOB, P_JOB + b"\xff")]

    def history_job(self, jid: int):
        from ..ddl.jobs import DDLJob

        raw = self.txn.get(P_JOB_HIST + f"{jid:012d}".encode())
        return DDLJob.from_json(json.loads(raw)) if raw else None

    def finish_job(self, job) -> None:
        """Move a job from the queue to history (ref: finishDDLJob)."""
        self.txn.delete(self._job_key(job.id))
        self.txn.put(P_JOB_HIST + f"{job.id:012d}".encode(), json.dumps(job.to_json()).encode())

    def job_history(self) -> list:
        from ..ddl.jobs import DDLJob

        out = []
        for _, v in self.txn.scan(P_JOB_HIST, P_JOB_HIST + b"\xff"):
            out.append(DDLJob.from_json(json.loads(v)))
        return out
