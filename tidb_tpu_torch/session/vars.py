"""System variables (copy of tidb_tpu/session/vars.py; ref: sessionctx/variable/sysvar.go — ~230 vars with
scope + validation; this registry carries the subset that drives behavior
here plus the high-traffic MySQL/TiDB knobs, each tagged with whether any
code actually consumes it — SET on an inert knob warns instead of lying).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SysVar:
    name: str
    default: str
    scope: str = "both"  # both | session | global | none (read-only)
    kind: str = "str"  # bool | int | float | enum | str
    enum: tuple = ()
    lo: int | None = None
    hi: int | None = None
    consumed: bool = False  # True: some code path reads it

    def normalize(self, raw: str) -> str:
        """Validate + canonicalize a SET value (ref: sysvar.go Validation)."""
        s = str(raw).strip()
        if self.kind == "bool":
            up = s.upper()
            if up in ("ON", "1", "TRUE"):
                return "ON"
            if up in ("OFF", "0", "FALSE"):
                return "OFF"
            raise ValueError(f"Variable '{self.name}' can't be set to the value of '{raw}'")
        if self.kind == "int":
            try:
                # int(s) first: int(float(s)) corrupts 64-bit values >2^53
                v = int(s) if not any(c in s for c in ".eE") else int(float(s))
            except ValueError:
                raise ValueError(f"Incorrect argument type to variable '{self.name}'")
            if self.lo is not None:
                v = max(v, self.lo)
            if self.hi is not None:
                v = min(v, self.hi)
            return str(v)
        if self.kind == "float":
            try:
                v = float(s)
            except ValueError:
                raise ValueError(f"Incorrect argument type to variable '{self.name}'")
            # clamp like int vars — the stored/displayed value must match
            # what enforcement actually uses
            if self.lo is not None and v < self.lo:
                return str(float(self.lo))
            if self.hi is not None and v > self.hi:
                return str(float(self.hi))
            return s
        if self.kind == "enum":
            for e in self.enum:
                if s.lower() == e.lower():
                    return e
            raise ValueError(f"Variable '{self.name}' can't be set to the value of '{raw}'")
        return s


SYSVARS: dict[str, SysVar] = {}


def _sv(name, default, scope="both", kind="str", enum=(), lo=None, hi=None, consumed=False):
    SYSVARS[name] = SysVar(name, default, scope, kind, enum, lo, hi, consumed)


# --- engine / executor knobs (consumed) ------------------------------------
_sv("tidb_cop_engine", "auto", kind="enum", enum=("auto", "tpu", "host"), consumed=True)
_sv("tidb_executor_concurrency", "5", kind="int", lo=1, hi=256, consumed=True)
_sv("tidb_distsql_scan_concurrency", "15", kind="int", lo=1, hi=256, consumed=True)
_sv("tidb_enable_cop_result_cache", "ON", kind="bool", consumed=True)
_sv("tidb_mem_quota_query", str(1 << 30), kind="int", lo=0, consumed=True)
_sv("tidb_slow_log_threshold", "300", kind="int", lo=0, consumed=True)
_sv("tidb_allow_mpp", "ON", kind="bool", consumed=True)
_sv("tidb_broadcast_join_threshold_count", "10240", kind="int", lo=0, consumed=True)
_sv("tidb_txn_mode", "optimistic", kind="enum", enum=("optimistic", "pessimistic", ""), consumed=True)
_sv("tidb_retry_limit", "10", kind="int", lo=0, consumed=True)
_sv("autocommit", "ON", kind="bool", consumed=True)
_sv("tidb_opt_prefer_merge_join", "OFF", kind="bool", consumed=True)
_sv("tidb_opt_prefer_index_join", "OFF", kind="bool", consumed=True)
_sv("tidb_enable_auto_analyze", "ON", kind="bool", consumed=True)
_sv("tidb_snapshot", "", consumed=True)
_sv("group_concat_max_len", "1024", kind="int", lo=4, hi=1 << 20, consumed=True)
_sv("sql_select_limit", str(2**64 - 1), kind="int", lo=0, consumed=True)
_sv("max_execution_time", "0", kind="int", lo=0, consumed=True)
_sv("tidb_enable_window_function", "ON", kind="bool", consumed=True)
_sv("tidb_enable_noop_functions", "ON", kind="bool", consumed=True)
_sv("tidb_general_log", "OFF", kind="bool", consumed=True)
_sv("sql_mode", "ONLY_FULL_GROUP_BY,STRICT_TRANS_TABLES", consumed=True)
_sv("time_zone", "SYSTEM", consumed=True)
_sv("tidb_isolation_read_engines", "tpu,host", consumed=True)
_sv("tidb_enable_clustered_index", "ON", kind="bool", consumed=True)
_sv("tidb_window_device_min_rows", str(1 << 15), kind="int", lo=0, consumed=True)
_sv("cte_max_recursion_depth", "1000", kind="int", lo=0, hi=4294967295, consumed=True)
_sv("tidb_ddl_reorg_batch_size", "256", kind="int", lo=32, hi=10240, consumed=True)
_sv("sql_safe_updates", "OFF", kind="bool", consumed=True)
_sv("default_week_format", "0", kind="int", lo=0, hi=7, consumed=True)
_sv("div_precision_increment", "4", kind="int", lo=0, hi=30, consumed=True)
_sv("max_allowed_packet", "67108864", kind="int", lo=1024, hi=1 << 30, consumed=True)
_sv("auto_increment_increment", "1", kind="int", lo=1, hi=65535, consumed=True)
_sv("auto_increment_offset", "1", kind="int", lo=1, hi=65535, consumed=True)
_sv("timestamp", "", consumed=True)  # SET timestamp=N freezes NOW()
_sv("tidb_enable_index_merge", "ON", kind="bool", consumed=True)
_sv("tidb_enable_list_partition", "OFF", kind="bool", consumed=True)
# agg-below-join pushdown rule doesn't exist here (cop partial/final split
# is unconditional, like the reference's cop pushdown) — stays inert
_sv("tidb_opt_agg_push_down", "OFF", kind="bool")
_sv("tidb_opt_join_reorder_threshold", "0", kind="int", lo=0, hi=63, consumed=True)
_sv("tidb_enforce_mpp", "OFF", kind="bool", consumed=True)
_sv("tidb_broadcast_join_threshold_size", str(100 * 1024 * 1024), kind="int", lo=0, consumed=True)
_sv("tidb_redact_log", "OFF", kind="bool", consumed=True)
_sv("tidb_query_log_max_len", "4096", kind="int", lo=-1, consumed=True)
_sv("tidb_stmt_summary_max_sql_length", "4096", kind="int", lo=0, consumed=True)
_sv("tidb_enable_stmt_summary", "ON", kind="bool", consumed=True)
_sv("tidb_enable_slow_log", "ON", kind="bool", consumed=True)
_sv("tidb_stmt_summary_max_stmt_count", "3000", scope="global", kind="int", lo=1, consumed=True)
_sv("tidb_gc_enable", "ON", scope="global", kind="bool", consumed=True)
_sv("tidb_gc_life_time", "10m0s", scope="global", consumed=True)
_sv("tidb_gc_run_interval", "10m0s", scope="global", consumed=True)
_sv("tidb_index_lookup_size", "20000", kind="int", lo=1, consumed=True)
_sv("tidb_index_join_batch_size", "25000", kind="int", lo=1, consumed=True)
_sv("tidb_disable_txn_auto_retry", "ON", kind="bool", consumed=True)
_sv("tidb_multi_statement_mode", "OFF", kind="enum", enum=("OFF", "ON", "WARN"), consumed=True)
_sv("tidb_track_aggregate_memory_usage", "ON", kind="bool", consumed=True)
_sv("tidb_mem_quota_sort", str(32 << 30), scope="session", kind="int", lo=-1, consumed=True)
_sv("tidb_mem_quota_topn", str(32 << 30), scope="session", kind="int", lo=-1, consumed=True)
_sv("tidb_mem_quota_hashjoin", str(32 << 30), scope="session", kind="int", lo=-1, consumed=True)

# --- observability (statement tracing + cop-path exec details) -------
# span recording for every statement (TRACE <sql> records regardless);
# traces land in the TIDB_TRACE ring / /debug/trace
_sv("tidb_enable_trace", "OFF", kind="bool", consumed=True)
# per-statement cop backoff sleep budget (session scope; statement scope
# via the SET_VAR optimizer hint) — replaces the fixed COP_BACKOFF_BUDGET_MS
_sv("tidb_backoff_budget_ms", "2000", kind="int", lo=0, hi=600000, consumed=True)
# capacity of the per-store TIDB_TRACE ring; SET GLOBAL resizes it live
# (replaces the fixed 64)
_sv("tidb_trace_ring_capacity", "64", scope="global", kind="int", lo=1, hi=4096,
    consumed=True)
# device timeline profiler: real-timestamped engine-boundary and
# launch-lifecycle events into the per-store ring behind /debug/timeline
# and TIDB_TIMELINE. GLOBAL-only: one ring per store, one flag on it
_sv("tidb_enable_timeline", "ON", scope="global", kind="bool", consumed=True)
# capacity of the per-store device timeline ring; SET GLOBAL resizes it
# live keeping the newest events (replaces the fixed 8192, the
# tidb_trace_ring_capacity pattern one ring over)
_sv("tidb_timeline_ring_capacity", "8192", scope="global", kind="int", lo=64,
    hi=1 << 20, consumed=True)

# --- durability fault domain ---------------------------------------
# what recovery does with a damaged WAL (storage/txn.py Storage):
# tolerate-torn-tail (default) truncates a crash-torn tail but REFUSES
# mid-log corruption (valid frames after a bad one = bit rot inside
# committed history); absolute refuses any damage; drop-corrupt is the
# explicit opt-in to skip corrupt frames and salvage the records after
# them. GLOBAL-only and persisted in the data dir's RECOVERY_MODE sidecar
# so the setting survives the very crash it exists for. A corrupt
# SNAPSHOT is refused in every mode.
_sv("tidb_wal_recovery_mode", "tolerate-torn-tail", scope="global", kind="enum",
    enum=("tolerate-torn-tail", "absolute", "drop-corrupt"), consumed=True)

# --- group-commit WAL ----------------------------------------------
# ON (default): concurrent committers batch their WAL fsyncs into one —
# every committer appends, one leader fsyncs for the whole group, the
# followers wait on the flushed sequence (KILL/deadline release the wait
# through the shared interrupt gate; a failed group sync withholds EVERY
# ack in the group and poisons the log per the fsyncgate discipline).
# OFF recovers the exact per-commit-fsync behavior live — the A/B
# baseline for tools/bench_serve.py and the incident fallback.
# GLOBAL-only: the durability protocol is a store-wide property.
_sv("tidb_wal_group_commit", "ON", scope="global", kind="bool", consumed=True)

# --- warm-standby shipping + online WAL media failover --------------
# semi-sync replication (MySQL rpl_semi_sync analog over WAL shipping):
# with a WalShipper attached, ON makes every commit ack additionally
# mean durable-on-STANDBY — after local group-commit durability the
# committer waits for the shipper's standby-fsync confirmation (released
# by KILL/deadline through the shared interrupt gate; the commit is then
# indeterminate, never falsely acked). QUORUM upgrades the ack
# to majority-of-N: the commit waits until the MEDIAN per-replica
# durable horizon covers it — ceil(N/2) of the N attached links — and
# raises the typed indeterminate shape (8150) when too many links are
# broken for the quorum to ever form. OFF (default) ships async —
# measured cost: nothing (the wait is never entered). GLOBAL-only like
# tidb_wal_group_commit: the durability protocol is store-wide.
_sv("tidb_wal_semi_sync", "OFF", scope="global", kind="enum",
    enum=("OFF", "ON", "QUORUM"), consumed=True)
# follower-read routing (ref: client-go replica-read modes):
# "leader" (default) pins every statement to the primary; "follower" and
# "leader-and-follower" let top-level read-only statements route to an
# in-process replica whose applied-ts lag is within
# tidb_replica_read_max_lag_ms (choose-and-bump placement re-weighted by
# lag; automatic fallback to the primary when every replica is too
# stale). AS OF TIMESTAMP reads route to a replica only once its applied
# watermark REACHED the requested ts — the snapshot is then exactly the
# primary's.
_sv("tidb_replica_read", "leader", kind="enum",
    enum=("leader", "follower", "leader-and-follower"), consumed=True)
# bounded staleness for follower reads: a replica lagging more than this
# many wall-clock ms (primary now vs replica applied-ts physical time)
# is skipped
_sv("tidb_replica_read_max_lag_ms", "5000", kind="int", lo=0, hi=3600000,
    consumed=True)
# cross-node trace propagation: ON (default) lets a
# follower-routed statement's replica-side spans (cop.task + its
# device-phase children) adopt into the PRIMARY statement trace tagged
# with the serving replica's name, and stamps the routing decision
# (outcome/reason) as a replica.route span. OFF reverts to untagged
# per-process spans — the A/B knob for the paired overhead gate
# (tools/bench_trace_propagation.py, standing ≤5% rule).
_sv("tidb_enable_trace_propagation", "ON", kind="bool", consumed=True)
# --- partition hardening --------------------------------------------
# link heartbeat cadence: an idle socket ship link pings the standby (a
# bare sync marker, acked like a batch) every this-many ms, so a
# black-holed link — a peer that accepts but never answers — is DETECTED
# instead of silently pinning the quorum until some later commit stalls
# on it. GLOBAL-only: link-health policy is fleet-wide.
_sv("tidb_replica_heartbeat_ms", "1000", scope="global", kind="int",
    lo=10, hi=3600000, consumed=True)
# per-IO deadline on ship-link sockets (replaces the old hard 30s): any
# frame/ack round trip exceeding it breaks the link TYPED
# (reason=timeout, no reconnect ladder — reconnecting to a black hole is
# futile), releasing quorum waiters to count the link against potential
_sv("tidb_replica_heartbeat_timeout_ms", "3000", scope="global", kind="int",
    lo=10, hi=3600000, consumed=True)
# bounded quorum wait: a semi-sync ON/QUORUM commit that cannot confirm
# within this many ms raises the typed indeterminate shape (8150) —
# durable locally, UNCONFIRMED on the fleet — instead of blocking until
# KILL/deadline. 0 disables the bound (the pre-PR-19 behavior).
_sv("tidb_replica_quorum_timeout_ms", "10000", scope="global", kind="int",
    lo=0, hi=3600000, consumed=True)
# comma-separated spare WAL directories: on a WAL IO failure the store
# checkpoints onto the first healthy spare (fresh log, writes resume,
# zero acks lost) instead of degrading read-only forever; failed media
# joins a background re-probe with hysteresis. Empty (default) keeps the
# exact fsyncgate degrade. GLOBAL-only: media topology is
# store-wide.
_sv("tidb_wal_spare_dirs", "", scope="global", consumed=True)

# --- mesh-wide cop dispatch -----------------------------------------
# dispatch width over the device mesh: cop tasks place onto the first N
# runner lanes (0 = every device). Serving knob for hosts whose backend
# serializes executions across in-process devices (see BENCH_mesh_pr6's
# overlap_x): width 1 there recovers full cross-session coalescing
_sv("tidb_tpu_cop_lanes", "0", scope="global", kind="int", lo=0, hi=256,
    consumed=True)

# --- compressed, width-narrowed device tiles -------------------------
# ON (default): batches pad to power-of-two row buckets (min 256) and each
# column ships in the cheapest of dense/pack/dict/rle form with decode
# fused into the device program. OFF forces the legacy dense 64Ki-tile
# layout — the A/B baseline and the incident fallback. GLOBAL-only: the
# layout keys the store-wide compile cache and batcher groups
_sv("tidb_tpu_tile_compression", "ON", scope="global", kind="bool", consumed=True)

# --- fused MPP fragment chains --------------------------------------
# ON (default): all-inner fragment chains specialize eligible join levels
# to device-resident direct-address LUT structures (no in-program build
# sort, no exchange — the structure is cached across statements in the
# store's BuildSideCache) and group-on-build-key aggregations to
# build-row-position segments. OFF recovers the pre-fusion sort-join /
# sorted-agg programs exactly — the A/B baseline and the incident
# fallback, mirroring tidb_tpu_tile_compression. GLOBAL-only; the live
# value overrides every session's dispatch (incident semantics).
_sv("tidb_tpu_mpp_fused", "ON", scope="global", kind="bool", consumed=True)

# --- workload-history feedback routing -------------------------------
# ON (default): the `auto` engine routes per (statement digest, row
# bucket) from the store's observed WorkloadProfile (utils/workload.py)
# — first sight explores via the static heuristics, repeats exploit the
# measured per-task walls; the profile also arms at statement
# completion. OFF recovers the pre-feedback static heuristics exactly
# (no profile reads, no feeds, no route metrics) — the A/B baseline and
# the live incident fallback, mirroring tidb_tpu_tile_compression.
# GLOBAL-only: the history is store-wide and the routing contract must
# flip for every session at once.
_sv("tidb_tpu_feedback_route", "ON", scope="global", kind="bool", consumed=True)

# --- Lightning-style bulk ingest (br/ingest.BulkIngest) --------------
# ON (default): LOAD DATA and models bulk_load build sorted columnar KV
# artifacts and publish them atomically under ONE WAL ingest record
# (all-visible-or-absent recovery), skipping per-row MVCC prewrite/
# commit. OFF recovers the legacy paths exactly — 2000-row txn batches
# for LOAD DATA, per-batch segment ingest for bulk_load — as the live
# incident fallback. Session-scoped so one load can opt out without
# flipping the store (a LOAD DATA ... WITH bulk_ingest=0 option
# overrides per statement).
_sv("tidb_bulk_ingest", "ON", kind="bool", consumed=True)

# --- delta-main compaction (storage/compact.py) ---------------------
# The background worker that folds row-major txn writes + MVCC versions
# at/below the gc safepoint into sorted columnar segments, one per
# durable primary store. GLOBAL-only: compaction is a store property
# (the worker reads these from store.global_vars every tick — SET GLOBAL
# takes effect on the next round, no restart).
_sv("tidb_compact_enable", "ON", scope="global", kind="bool", consumed=True)
# minimum mutable w-CF entries under a table's prefix before a fold is
# worth the decode/build cost (MemKV.count_range per tick is two bisects)
_sv("tidb_compact_delta_threshold", "2048", scope="global", kind="int", lo=1, consumed=True)
# per-plane run-count bound: above it the oldest contiguous commit-ts
# prefix of structurally identical runs merges into one (size-tiered)
_sv("tidb_compact_max_runs", "8", scope="global", kind="int", lo=2, consumed=True)
# background tick cadence, tidb_gc_* go-duration format ('500ms', '5s')
_sv("tidb_compact_interval", "1s", scope="global", consumed=True)

# --- server memory arbitration (utils/memory ServerMemTracker) -------
# store-wide hard limit on tracked statement memory; 0 = unlimited.
# GLOBAL-only like the reference: a per-session opt-out would defeat it
_sv("tidb_server_memory_limit", "0", scope="global", kind="int", lo=0, consumed=True)
# soft-limit ratio: above limit*ratio the store degrades (auto→host cop
# routing + tile/device cache eviction) before anything is killed
_sv("tidb_memory_usage_alarm_ratio", "0.8", scope="global", kind="float",
    lo=0, hi=1, consumed=True)

# --- resource control (sched/: admission + RU groups + launch batcher) ------
_sv("tidb_resource_group", "default", consumed=True)
# GLOBAL-only (as in the reference): a plain-SET session toggle would let
# any unprivileged session opt itself out of admission control
_sv("tidb_enable_resource_control", "ON", scope="global", kind="bool", consumed=True)

# --- read-only session state surfaced via SELECT @@x (SET is rejected;
# values are computed live by Session._sysvar_read) ------------------------
for _name in (
    "last_insert_id", "warning_count", "error_count", "tidb_current_ts",
    "tidb_last_txn_info", "tidb_last_query_info", "last_plan_from_cache",
    "last_plan_from_binding", "tidb_config",
):
    _sv(_name, "", scope="none", consumed=True)

# --- accepted, surfaced in SHOW, but nothing reads them here (warn) --------
for _name, _d, _k in (
    ("tidb_enable_chunk_rpc", "ON", "bool"),
    ("tidb_enable_vectorized_expression", "ON", "bool"),
    ("tidb_index_lookup_concurrency", "4", "int"),
    ("tidb_index_lookup_join_concurrency", "4", "int"),
    ("tidb_hash_join_concurrency", "5", "int"),
    ("tidb_window_concurrency", "4", "int"),
    ("tidb_projection_concurrency", "4", "int"),
    ("tidb_hashagg_partial_concurrency", "4", "int"),
    ("tidb_hashagg_final_concurrency", "4", "int"),
    ("tidb_merge_join_concurrency", "1", "int"),
    ("tidb_stream_agg_concurrency", "1", "int"),
    ("tidb_build_stats_concurrency", "4", "int"),
    ("tidb_opt_distinct_agg_push_down", "OFF", "bool"),
    ("tidb_enable_parallel_apply", "OFF", "bool"),
    ("tidb_enable_async_commit", "OFF", "bool"),
    ("tidb_enable_1pc", "OFF", "bool"),
    ("tidb_max_chunk_size", "1024", "int"),
    ("tidb_init_chunk_size", "32", "int"),
    ("tidb_enable_rate_limit_action", "ON", "bool"),
    ("tidb_enable_strict_double_type_check", "ON", "bool"),
    ("tidb_enable_table_partition", "ON", "bool"),
    ("tidb_scatter_region", "OFF", "bool"),
    ("tidb_enable_collect_execution_info", "ON", "bool"),
    ("tidb_enable_telemetry", "ON", "bool"),
    ("tidb_row_format_version", "2", "int"),
    ("tidb_analyze_version", "2", "int"),
    ("tidb_stats_load_sync_wait", "0", "int"),
    ("tidb_ddl_reorg_worker_cnt", "4", "int"),
    ("tidb_ddl_error_count_limit", "512", "int"),
    ("tidb_auto_analyze_ratio", "0.5", "float"),
    ("tidb_auto_analyze_start_time", "00:00 +0000", "str"),
    ("tidb_auto_analyze_end_time", "23:59 +0000", "str"),
    ("tidb_gc_concurrency", "-1", "int"),
    ("tidb_backoff_weight", "2", "int"),
    ("tidb_ddl_slow_threshold", "300", "int"),
    ("tidb_force_priority", "NO_PRIORITY", "str"),
    ("tidb_constraint_check_in_place", "OFF", "bool"),
    ("tidb_batch_insert", "OFF", "bool"),
    ("tidb_batch_delete", "OFF", "bool"),
    ("tidb_dml_batch_size", "0", "int"),
    ("tidb_opt_write_row_id", "OFF", "bool"),
    ("tidb_check_mb4_value_in_utf8", "ON", "bool"),
    ("tidb_opt_insubq_to_join_and_agg", "ON", "bool"),
    ("tidb_opt_correlation_threshold", "0.9", "float"),
    ("tidb_opt_correlation_exp_factor", "1", "int"),
    ("tidb_opt_network_factor", "1", "float"),
    ("tidb_opt_scan_factor", "1.5", "float"),
    ("tidb_opt_seek_factor", "20", "float"),
    ("tidb_opt_memory_factor", "0.001", "float"),
    ("tidb_opt_disk_factor", "1.5", "float"),
    ("tidb_opt_concurrency_factor", "3", "float"),
    ("tidb_enable_noop_variables", "ON", "bool"),
    ("tidb_low_resolution_tso", "OFF", "bool"),
    ("tidb_expensive_query_time_threshold", "60", "int"),
    ("tidb_skip_isolation_level_check", "OFF", "bool"),
    ("tidb_skip_ascii_check", "OFF", "bool"),
    ("tidb_skip_utf8_check", "OFF", "bool"),
    ("foreign_key_checks", "OFF", "bool"),
    ("unique_checks", "ON", "bool"),
    ("sql_auto_is_null", "OFF", "bool"),
    ("big_tables", "OFF", "bool"),
    ("sql_log_bin", "ON", "bool"),
    ("innodb_lock_wait_timeout", "50", "int"),
    ("lock_wait_timeout", "31536000", "int"),
    ("tx_read_only", "OFF", "bool"),
    ("transaction_read_only", "OFF", "bool"),
    ("lc_time_names", "en_US", "str"),
    ("max_sort_length", "1024", "int"),
    ("net_write_timeout", "60", "int"),
    ("net_read_timeout", "30", "int"),
    ("net_buffer_length", "16384", "int"),
    ("query_cache_size", "0", "int"),
    ("query_cache_type", "OFF", "str"),
    ("tmp_table_size", "16777216", "int"),
    ("max_heap_table_size", "16777216", "int"),
    ("thread_cache_size", "9", "int"),
    ("table_open_cache", "2000", "int"),
):
    _sv(_name, _d, kind=_k)

# --- remainder of the reference registry (sysvar.go) — registered with the
# reference's scope/kind/defaults so SET/SHOW behave, inert here (warn) -----
for _name, _d, _k in (
    ("allow_auto_random_explicit_insert", "OFF", "bool"),
    ("ddl_slow_threshold", "300", "int"),
    ("block_encryption_mode", "aes-128-ecb", "str"),
    ("tidb_allow_batch_cop", "1", "int"),
    ("tidb_allow_fallback_to_tikv", "", "str"),
    ("tidb_allow_remove_auto_inc", "OFF", "bool"),
    ("tidb_backoff_lock_fast", "100", "int"),
    ("tidb_batch_commit", "OFF", "bool"),
    ("tidb_capture_plan_baselines", "OFF", "bool"),
    ("tidb_checksum_table_concurrency", "4", "int"),
    ("tidb_ddl_reorg_priority", "PRIORITY_LOW", "str"),
    ("tidb_enable_alter_placement", "OFF", "bool"),
    ("tidb_enable_amend_pessimistic_txn", "OFF", "bool"),
    ("tidb_enable_auto_increment_in_generated", "OFF", "bool"),
    ("tidb_enable_cascades_planner", "OFF", "bool"),
    ("tidb_enable_change_multi_schema", "OFF", "bool"),
    ("tidb_enable_exchange_partition", "OFF", "bool"),
    ("tidb_enable_extended_stats", "OFF", "bool"),
    ("tidb_enable_fast_analyze", "OFF", "bool"),
    ("tidb_enable_global_temporary_table", "OFF", "bool"),
    ("tidb_enable_index_merge_join", "OFF", "bool"),
    ("tidb_enable_local_txn", "OFF", "bool"),
    ("tidb_enable_ordered_result_mode", "OFF", "bool"),
    ("tidb_enable_pipelined_window_function", "ON", "bool"),
    ("tidb_enable_point_get_cache", "OFF", "bool"),
    ("tidb_enable_streaming", "OFF", "bool"),
    ("tidb_enable_top_sql", "OFF", "bool"),
    ("tidb_evolve_plan_baselines", "OFF", "bool"),
    ("tidb_evolve_plan_task_end_time", "23:59 +0000", "str"),
    ("tidb_evolve_plan_task_max_time", "600", "int"),
    ("tidb_evolve_plan_task_start_time", "00:00 +0000", "str"),
    ("tidb_gc_scan_lock_mode", "LEGACY", "str"),
    ("tidb_guarantee_linearizability", "ON", "bool"),
    ("tidb_hash_exchange_with_new_collation", "ON", "bool"),
    ("tidb_index_serial_scan_concurrency", "1", "int"),
    ("tidb_max_delta_schema_count", "1024", "int"),
    ("tidb_mem_quota_apply_cache", str(32 << 20), "int"),
    ("tidb_mem_quota_indexlookupjoin", str(32 << 30), "int"),
    ("tidb_mem_quota_indexlookupreader", str(32 << 30), "int"),
    ("tidb_mem_quota_mergejoin", str(32 << 30), "int"),
    ("tidb_metric_query_range_duration", "60", "int"),
    ("tidb_metric_query_step", "60", "int"),
    ("tidb_mpp_store_fail_ttl", "60s", "str"),
    ("tidb_opt_broadcast_cartesian_join", "1", "int"),
    ("tidb_opt_broadcast_join", "OFF", "bool"),
    ("tidb_opt_copcpu_factor", "3.0", "float"),
    ("tidb_opt_cpu_factor", "3.0", "float"),
    ("tidb_opt_desc_factor", "3.0", "float"),
    ("tidb_opt_enable_correlation_adjustment", "ON", "bool"),
    ("tidb_opt_mpp_outer_join_fixed_build_side", "OFF", "bool"),
    ("tidb_opt_prefer_range_scan", "OFF", "bool"),
    ("tidb_opt_tiflash_concurrency_factor", "24.0", "float"),
    ("tidb_optimizer_selectivity_level", "0", "int"),
    ("tidb_partition_prune_mode", "static", "str"),
    ("tidb_pprof_sql_cpu", "0", "int"),
    ("tidb_record_plan_in_slow_log", "ON", "bool"),
    # tidb_replica_read lives in the consumed block above
    ("tidb_restricted_read_only", "OFF", "bool"),
    ("tidb_shard_allocate_step", str(2**63 - 1), "int"),
    ("tidb_slow_log_masking", "OFF", "bool"),
    ("tidb_slow_query_file", "", "str"),
    ("tidb_stmt_summary_history_size", "24", "int"),
    ("tidb_stmt_summary_internal_query", "OFF", "bool"),
    ("tidb_stmt_summary_refresh_interval", "1800", "int"),
    ("tidb_store_limit", "0", "int"),
    ("tidb_streamagg_concurrency", "1", "int"),
    ("tidb_top_sql_agent_address", "", "str"),
    ("tidb_top_sql_max_collect", "10000", "int"),
    ("tidb_top_sql_max_statement_count", "200", "int"),
    ("tidb_top_sql_precision_seconds", "1", "int"),
    ("tidb_top_sql_report_interval_seconds", "60", "int"),
    ("tidb_use_plan_baselines", "ON", "bool"),
    ("tidb_wait_split_region_finish", "ON", "bool"),
    ("tidb_wait_split_region_timeout", "300", "int"),
    ("tx_read_ts", "", "str"),
    ("txn_scope", "global", "str"),
    ("windowing_use_high_precision", "ON", "bool"),
    ("max_connections", "151", "int"),
    ("max_prepared_stmt_count", "-1", "int"),
    ("skip_name_resolve", "OFF", "bool"),
):
    _sv(_name, _d, kind=_k)

# --- connection/session plumbing clients legitimately SET ------------------
for _name, _d in (
    ("wait_timeout", "28800"), ("interactive_timeout", "28800"),
    ("character_set_server", "utf8mb4"), ("collation_server", "utf8mb4_bin"),
    ("character_set_client", "utf8mb4"), ("character_set_results", "utf8mb4"),
    ("character_set_connection", "utf8mb4"), ("collation_connection", "utf8mb4_bin"),
    ("character_set_database", "utf8mb4"), ("collation_database", "utf8mb4_bin"),
    ("tx_isolation", "REPEATABLE-READ"), ("transaction_isolation", "REPEATABLE-READ"),
    ("default_storage_engine", "InnoDB"), ("init_connect", ""),
):
    _sv(_name, _d)

# --- server identity (read-only: SET is rejected, ref ErrIncorrectScope) ---
for _name, _d in (
    ("ssl_ca", ""), ("ssl_cert", ""), ("ssl_key", ""), ("log_bin", "OFF"),
    ("plugin_dir", ""), ("plugin_load", ""),
    ("default_authentication_plugin", "mysql_native_password"),
    ("tidb_enable_enhanced_security", "OFF"),
    ("version_comment", "tidb-tpu"), ("port", "4000"), ("socket", ""),
    ("datadir", ""), ("version", "8.0.11-tidb-tpu"), ("hostname", "localhost"),
    ("license", "Apache License 2.0"), ("system_time_zone", "UTC"),
    ("lower_case_table_names", "2"), ("have_openssl", "DISABLED"),
    ("have_ssl", "DISABLED"), ("performance_schema", "OFF"),
):
    _sv(_name, _d, scope="none")

DEFAULT_VARS = {v.name: v.default for v in SYSVARS.values()}


def set_var(name: str, value: str, warnings: list | None = None,
            scope: str | None = None) -> str:
    """Validate one SET assignment → canonical stored value. Unknown
    variables raise (ref: ErrUnknownSystemVariable); known-but-inert ones
    append a warning so silent no-ops are visible. `scope` is the
    assignment's requested scope ("global" for SET GLOBAL) — global-only
    variables reject plain SET (MySQL ER_GLOBAL_VARIABLE), so store-wide
    state can never be mutated below the SET GLOBAL privilege check."""
    from ..utils import sem

    sem.check_variable(name)
    sv = SYSVARS.get(name)
    if sv is None:
        raise ValueError(f"Unknown system variable '{name}'")
    if sv.scope == "none":
        raise ValueError(f"Variable '{name}' is a read only variable")
    if sv.scope == "global" and scope != "global":
        raise ValueError(
            f"Variable '{name}' is a GLOBAL variable and should be set with SET GLOBAL"
        )
    if sv.scope == "session" and scope == "global":
        raise ValueError(f"Variable '{name}' is a SESSION variable")
    out = sv.normalize(value)
    if not sv.consumed and warnings is not None:
        warnings.append(
            f"variable '{name}' is accepted for compatibility but has no effect in this engine"
        )
    return out
