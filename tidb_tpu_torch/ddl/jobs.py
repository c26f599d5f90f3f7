"""DDL jobs — the persisted unit of online schema change (copy of tidb_tpu/ddl/jobs.py)
(ref: model Job in the reference's parser/model; queued via ddl.go:535
doDDLJob into meta job queues, executed by ddl_worker.go:490)."""

from __future__ import annotations

from dataclasses import dataclass, field

# F1-style schema states (ref: model.SchemaState; ddl_worker.go runs each
# object through none → delete_only → write_only → write_reorg → public,
# bumping the schema version per transition so concurrent sessions are at
# most one state apart)
ST_NONE = "none"
ST_DELETE_ONLY = "delete_only"
ST_WRITE_ONLY = "write_only"
ST_WRITE_REORG = "write_reorg"
ST_PUBLIC = "public"

# job queue states (ref: model.JobState)
JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_DONE = "done"
JOB_ROLLBACK = "rollback_done"


@dataclass
class DDLJob:
    id: int
    type: str  # add_index | drop_index
    table_id: int
    args: dict = field(default_factory=dict)
    state: str = JOB_QUEUED
    schema_state: str = ST_NONE
    reorg_handle: int | None = None  # backfill checkpoint (ref: ddl/reorg.go)
    error: str | None = None

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "type": self.type,
            "table_id": self.table_id,
            "args": self.args,
            "state": self.state,
            "schema_state": self.schema_state,
            "reorg_handle": self.reorg_handle,
            "error": self.error,
        }

    @staticmethod
    def from_json(d: dict) -> "DDLJob":
        return DDLJob(
            d["id"], d["type"], d["table_id"], d.get("args", {}), d.get("state", JOB_QUEUED),
            d.get("schema_state", ST_NONE), d.get("reorg_handle"), d.get("error"),
        )
