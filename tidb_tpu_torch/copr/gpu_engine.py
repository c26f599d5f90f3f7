"""GPU coprocessor engine — pushed-down DAGs over torch tensors with the
port's hand-written kernels (ref: tidb_tpu/copr/tpu_engine.py TPUEngine).

The reference traces one fused XLA program per DAG. Here the same steps
run eagerly on the card:

    column lanes ──► K1 decode_lane ──► K2/K3 expr_eval ──► one of
    (codec payloads    (kernels/)         one launch: the mask and every
     uploaded once)                       argument / key lane of the DAG
                                          (expr/program.py compiles it)

      direct GROUP BY   K4 seg_agg over the mixed-radix key code
      sort GROUP BY     K9 sort_groups (K8 lex_sort inside) → capped dense
                        group ids → K4 seg_agg in its segment-lane mode
      single-key TopN   K6 topk (radix select; K8 orders the k rows)
      multi-key TopN    K7 topn_multi (radix select; K8 orders the k rows
                        only past its ordering cap)
      a launch group    K10: the task-grid modes of the same kernels
                        (kernels/grouped.py; module doc below)

then the results come back to the host, which rebuilds the partial chunk
exactly as the reference does (_agg_outputs_to_chunk,
_agg_sorted_to_chunk, the TopN take).

A lowered DAG is a DevicePlan (ref: :421): `launch()` issues the kernels
and returns the device tensors without synchronizing, `finalize(fetched)`
rebuilds the chunk from their host copies, and `execute` is
finalize(fetch(launch())). `execute_many` (ref: :785-886) runs many
tasks: plans sharing a program key (the rewritten DAG plus every lane's
codec signature) form launch groups of up to MAX_FUSE tasks. Every group
of two or more runs K10 (kernels/grouped.py): one launch of each kernel's
task-grid mode over the whole group, every task narrowed to the group's
`width` — K1 and the expression kernel, then K4 (filter, direct GROUP
BY), K9 + K8 + K4 (sort GROUP BY: one host read of the group's counts),
K6 (single-key TopN) or K7 (multi-key TopN); a group of one
launches its solo kernels. Everything launched comes back with one host
synchronization (`fetches` counts them).

The engine's surface for the launch batcher (sched/batcher.py) is the
reference's: one DeviceLane per card (one named `cpu:0` on the CPU) with
its own circuit breaker (copr/retry.py), `place` / `release_lane`,
`tile_bucket`. It declines — and counts in `fallbacks` and
M.TPU_FALLBACK — exactly the DAGs TPUEngine._lower declines, answering
through host_engine.execute_dag_host.
"""

from __future__ import annotations

import bisect
import time
from contextlib import nullcontext
from threading import Lock, RLock

import numpy as np
import torch

from ..chunk.chunk import Chunk, Column
from ..errors import CircuitBreakerOpen
from ..expr.expression import Column as ExprCol, Constant, Expression, ScalarFunc
from ..expr.program import ProgramCache, ValueSpec, evaluate, evaluate_tasks
from ..expr.xp_torch import U64
from ..kernels import SegKey, SegLane, decode_lanes, seg_agg, sort_groups, topk, topn_multi
from ..kernels.grouped import decode_lanes_tasks, seg_agg_tasks, sort_groups_tasks, topk_tasks, topn_multi_tasks
from ..utils import memory as _mem
from ..utils import metrics as M
from ..utils import timeline as TL
from ..utils import tracing
from ..mysqltypes.datum import Datum, K_STR, K_BYTES
from ..mysqltypes.field_type import ft_longlong
from ..mysqltypes.mydecimal import pow10
from ..torchenv import resolve_device
from .dag import DAGRequest
from .host_engine import exact_sum64, exact_sumsq64, execute_dag_host
from .retry import CircuitBreaker, device_boundary
from .tilecache import ColumnBatch, _pad2d, encode_data_lane, encode_valid_lane, pow2_rows

TILE_ROWS = 1 << 16
DIRECT_GROUP_MAX = 1 << 16
# the reference reduces up to this many segments densely (where an empty
# segment keeps the caller's fill) and above it with jax.ops.segment_*
# (where it gets the dtype's identity); only FIRST_ROW's fill tells them
# apart, and the port mirrors both so the raw partials stay bit-identical
SEG_DENSE_MAX = 64
_I64 = np.iinfo(np.int64)

_CMP_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
_VAR = ("stddev_pop", "stddev_samp", "var_pop", "var_samp")
# bitwise aggregates: K4's op and the fill of an empty segment (the
# reference's per-bit segment_min / max / sum % 2 identities, recombined)
_BIT = {"bit_and": ("and_i64", -1), "bit_or": ("or_i64", 0), "bit_xor": ("xor_i64", 0)}


class Vocab(list):
    """Sorted dict-encode vocabulary: ORIGINAL values in code order, plus
    the lookup keys codes were assigned by (weight strings under a ci
    collation, the values themselves under binary)."""

    def __init__(self, originals, keys=None, coll="utf8mb4_bin"):
        super().__init__(originals)
        self.keys = list(self) if keys is None else keys
        self.coll = coll

    def lookup(self, s: str):
        """(insertion position, exact-present) for a constant under this
        vocab's collation — the bisect behind code-space compare/IN."""
        from ..mysqltypes import collate as _c

        k = _c.weight(s, self.coll) if _c.is_ci(self.coll) else s
        i = bisect.bisect_left(self.keys, k)
        return i, i < len(self.keys) and self.keys[i] == k


def _dict_encode_lane(d: np.ndarray, v: np.ndarray, coll: str = "utf8mb4_bin"):
    """Vectorized sorted-dict encoding of an object lane → (int32 codes,
    Vocab) (copy of tpu_engine._dict_encode_lane). Under a ci collation
    codes follow WEIGHT order — equal-weight values share one code whose
    vocab entry is the first occurrence in row order."""
    from ..mysqltypes import collate as _coll

    if not v.any():
        return np.zeros(len(d), np.int32), Vocab([], coll=coll)
    present = d[v]
    kinds = {type(x) for x in present.tolist()}
    if _coll.is_ci(coll) and kinds <= {str}:
        raw = np.where(v, d, "")
        wa = _coll.weight_lane(raw, coll).astype("U")
        sel = np.nonzero(v)[0]
        uniqw, first = np.unique(wa[sel], return_index=True)
        reps = [d[i] for i in sel[first]]
        codes = np.searchsorted(uniqw, wa).astype(np.int32)
        codes[~v] = 0
        return codes, Vocab(reps, keys=uniqw.tolist(), coll=coll)
    if kinds <= {str}:
        vals = np.where(v, d, "").astype("U")
        vocab_arr = np.unique(vals[v])
        codes = np.searchsorted(vocab_arr, vals).astype(np.int32)
        codes[~v] = 0
        return codes, Vocab(vocab_arr.tolist())
    if kinds <= {bytes}:
        as_str = np.array([x.decode("latin-1") for x in present.tolist()], dtype="U")
        vocab_arr = np.unique(as_str)
        codes = np.zeros(len(d), np.int32)
        codes[v] = np.searchsorted(vocab_arr, as_str).astype(np.int32)
        orig = [s.encode("latin-1") for s in vocab_arr.tolist()]
        return codes, Vocab(orig, keys=vocab_arr.tolist())
    vocab = sorted({x if isinstance(x, str) else x.decode("latin-1") for x in present.tolist()})
    code_of = {s: i for i, s in enumerate(vocab)}
    codes = np.zeros(len(d), np.int32)
    for i in np.nonzero(v)[0]:
        x = d[i]
        codes[i] = code_of[x if isinstance(x, str) else x.decode("latin-1")]
    return codes, Vocab(vocab)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → tensor on `device`. uint16/uint32/uint64 go as signed bit
    views of the same width: the kernels read codes unsigned, and uint64
    values are carried as int64 bit patterns (xp_torch.U64)."""
    a = np.ascontiguousarray(a)
    view = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
            np.dtype(np.uint64): np.int64}.get(a.dtype)
    if view is not None:
        a = a.view(view)
    return torch.from_numpy(a).to(device)


def _upload_payload(pay: dict, device: torch.device) -> dict:
    out = {}
    for k, a in pay.items():
        if k == "b":  # pack base: a launch parameter, kept on the host
            a = np.asarray(a)
            out[k] = torch.tensor(int(a.view(np.int64)) if a.dtype == np.uint64 else a.item(),
                                  dtype=torch.int64 if a.dtype.itemsize == 8 else torch.int32)
        else:
            out[k] = _to_device(a, device)
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`_upload` with the reference's transfer accounting (:95 _to_device):
    the bytes consume into the thread's bound statement MemTracker (which
    may raise the quota error at the allocation site) and feed the h2d
    transfer series and the active phase frame."""
    _mem.consume_current(a.nbytes)
    t0 = time.perf_counter_ns()
    out = _upload(a, device)
    t1 = time.perf_counter_ns()
    M.TPU_TRANSFER_BYTES.inc(a.nbytes, dir="h2d")
    tracing.add_phase("h2d_bytes", a.nbytes)
    tracing.add_phase("h2d_ms", (t1 - t0) / 1e6)
    tracing.add_phase_event("device.transfer", t0, t1, dir="h2d", bytes=int(a.nbytes))
    return out


def tile_shape(n_rows: int, compress: bool) -> tuple[int, int]:
    """(tile count, row bucket) `n_rows` pad to: with compression a batch
    up to TILE_ROWS rows pads to a power-of-two bucket, else to TILE_ROWS
    tiles (ref: :302-305, :719 tile_bucket)."""
    if compress and n_rows <= TILE_ROWS:
        return 1, pow2_rows(n_rows)
    return max((n_rows + TILE_ROWS - 1) // TILE_ROWS, 1), TILE_ROWS


class DeviceBatch:
    """Device-resident mirror of a ColumnBatch: per used column the
    encoded (data, valid) lanes, uploaded once (ref: tpu_engine.py:283).

    With `compress` (the reference's tidb_tpu_tile_compression default)
    batches up to TILE_ROWS pad to a power-of-two row bucket and every
    lane ships in the cheapest of dense/pack/dict/rle form, decoded on the
    card by K1; `compress=False` keeps the legacy layout: 64Ki-row tiles,
    dense lanes."""

    def __init__(self, batch: ColumnBatch, device: torch.device, compress: bool = True):
        self.batch = batch
        self.device = device
        self.compress = compress
        n = batch.n_rows
        self.t, self.r = tile_shape(n, compress)
        self.padded = self.t * self.r
        self.vocabs: dict[int, Vocab] = {}
        self._data: dict[int, object] = {}
        self._valid: dict[int, object] = {}
        # each used lane's static (data, valid) codec signature: the static
        # half of every program key, so tasks fuse only when their lanes'
        # codecs and aux shapes agree (ref: :313, :934)
        self.lane_sigs: dict[int, tuple] = {}
        rv = np.zeros(self.padded, dtype=bool)
        rv[:n] = True
        self.row_valid = _to_device(rv.reshape(self.t, self.r), device)

    def lanes(self, off: int, phase=None):
        """(data, valid) device lanes for a table column offset — each a
        dense [T, R] tensor or a codec payload K1 decodes. Object lanes
        dict-encode to sorted-vocab int32 codes first. `phase(name)` (an
        engine's PhaseTimer hook) brackets the host encode and the h2d
        upload of a first touch."""
        if off not in self._data:
            phase = phase or (lambda name: nullcontext())
            with phase("encode"):
                d = self.batch.data[off]
                v = self.batch.valid[off]
                if d.dtype == object:
                    coll = getattr(self.batch.table.columns[off].ft, "collate", "utf8mb4_bin")
                    codes, vocab = _dict_encode_lane(d, v, coll)
                    self.vocabs[off] = vocab
                    d = codes
                if self.compress:
                    pay_d, sig_d = encode_data_lane(d, v, (self.t, self.r))
                    pay_v, sig_v = encode_valid_lane(v, (self.t, self.r))
                else:
                    pay_d = pay_v = None
                    sig_d, sig_v = ("dense",), ("dense",)
            with phase("h2d"):
                self._data[off] = (_to_device(_pad2d(d, (self.t, self.r)), self.device) if pay_d is None
                                   else _upload_payload(pay_d, self.device))
                self._valid[off] = (_to_device(_pad2d(v, (self.t, self.r)), self.device) if pay_v is None
                                    else _upload_payload(pay_v, self.device))
            self.lane_sigs[off] = (sig_d, sig_v)
        return self._data[off], self._valid[off]


class DevicePlan:
    """A lowered DAG split at the device→host boundary (ref: :421):
    `launch()` issues the kernels and returns a list of device tensors
    (and host-side values, passed through the fetch as they are) without
    synchronizing; `finalize(fetched)` turns their host copies into the
    result chunk. Plans with one program key `key` share a launch group
    in `execute_many`: one task-grid launch of each kernel (K10) over
    their `args` = (flat lanes, row_valid), each task finalized from its
    own slice of the group's outputs."""

    __slots__ = ("launch", "finalize", "key", "args", "rows")

    def __init__(self, launch, finalize, key=None, args=None, rows=0):
        self.launch = launch
        self.finalize = finalize
        self.key = key  # program key, shared ⇒ one task-grid launch
        self.args = args  # (flat [data, valid] lanes per used column, row_valid)
        self.rows = rows  # real (unpadded) row count of the batch


class DeviceLane:
    """One cop runner lane per card (ref: :449): the device, its own
    circuit breaker (an open breaker drains only this lane), a launch lock
    serializing device work, and the in-flight occupancy the placement
    policy balances on (guarded by the engine's placement lock)."""

    __slots__ = ("idx", "device", "name", "breaker", "lock", "occupancy",
                 "launches", "ewma_ms", "faults")

    def __init__(self, idx: int, device: torch.device, breaker):
        self.idx = idx
        self.device = device
        self.name = f"{device.type}:{device.index if device.index is not None else idx}"
        self.breaker = breaker
        self.lock = RLock()
        self.occupancy = 0  # placed-but-unfinished tasks (queued + running)
        self.launches = 0
        self.ewma_ms = 0.0  # observed per-task wall, fault-penalized; 0 = none yet
        self.faults = 0


class _lane_guard:
    """Exclusive use of one device lane for a launch: the lane's launch
    lock plus the timeline device-lane binding (ref: :479). Re-entrant —
    the batcher guards around `execute_many`, which guards again."""

    __slots__ = ("lane", "_scope")

    def __init__(self, lane: DeviceLane):
        self.lane = lane

    def __enter__(self):
        self.lane.lock.acquire()
        self._scope = TL.device_scope(self.lane.name)
        self._scope.__enter__()
        return self.lane

    def __exit__(self, *exc):
        self._scope.__exit__(*exc)
        self.lane.lock.release()
        return False


class _TaskView:
    """One task of a launch group as the aggregate-lane builders see a
    DeviceBatch: its row_valid and the group's (narrowed) row count."""

    __slots__ = ("row_valid", "padded")

    def __init__(self, row_valid, padded: int):
        self.row_valid = row_valid
        self.padded = padded


def _stacked(host: list, j: int) -> list:
    """Task j's part of a group's fetched outputs: row j of each stacked
    array (host values pass as they are)."""
    return [h[j] if isinstance(h, np.ndarray) else h for h in host]


def _host_of(t: torch.Tensor, buf: np.ndarray) -> np.ndarray:
    return buf.view(np.dtype(str(t.dtype).split(".")[1])).reshape(t.shape)


class TorchEngine:
    """The port's device cop engine (ref: TPUEngine). `device` defaults to
    "cuda" and is never swapped for the CPU on the engine's own initiative:
    without a card, construction raises unless the caller passes "cpu"."""

    MAX_FUSE = 64  # largest launch group
    # resident-lane queue depth beyond the fair share before a task
    # spills off its resident card (ref: :508)
    SPILL_SLACK = 3

    def __init__(self, device="cuda"):
        asked = torch.device(device)
        self.device = resolve_device(device)
        self._lock = Lock()
        self.fallbacks = 0
        # bucketed/compressed device tiles (the reference's SET GLOBAL
        # tidb_tpu_tile_compression, default ON); OFF = dense 64Ki tiles
        self.tile_compression = True
        # optional torchenv.PhaseTimer: encode / h2d (first touch of a
        # lane) and decode / mask / sort (K6-K9) / agg_args / seg_agg /
        # d2h / finalize spans of each execute
        self.timer = None
        # the kernels' entry points; a caller may wrap one per instance to
        # observe its inputs (chip_smoke.py times each kernel on the main
        # path's own tensors)
        self.seg_agg = seg_agg
        self.topk = topk
        self.topn_multi = topn_multi
        self.sort_groups = sort_groups
        # sort-based GROUP BY group capacity: start at gcap0, escalate x4
        # past an overflow and remember it per DAG shape (the reference's
        # TPUEngine.gcap0 / _gcap)
        self.gcap0 = 1 << 16
        self._gcap: dict = {}
        self.programs = ProgramCache()  # compiled expression programs (K2/K3)
        # program keys (the reference's jit cache keys: one per compiled
        # program, a launch group's (key, gcap, width) included) and each
        # key's group program; compile_count counts the keys, as the
        # reference counts its compiles
        self._programs: set = set()
        self._raw: dict = {}
        self._vprograms: dict = {}
        self.compile_count = 0
        self.fetches = 0  # host synchronizations that fetched results
        # one runner lane per card (every card when the caller named none),
        # each with its own breaker; engine-scoped labels keep two engines'
        # breaker series apart (ref: :531-546)
        if self.device.type == "cuda" and asked.index is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [self.device]
        eid = f"e{next(CircuitBreaker._seq)}"
        self._all_lanes = []
        for i, d in enumerate(devices):
            lane = DeviceLane(i, d, None)
            lane.breaker = CircuitBreaker(label=f"{eid}/{lane.name}")
            self._all_lanes.append(lane)
        self.lanes = list(self._all_lanes)
        self._place_lock = Lock()  # atomic choose-and-bump across lanes
        # residency by batch CONTENT (table, span, version, rows): the lane
        # that holds a batch's upload; a stale entry only costs a re-upload
        self._residency: dict[tuple, set] = {}

    def phase(self, name: str):
        """The timer's span for `name`, or a no-op without a timer."""
        return self.timer.phase(name) if self.timer is not None else nullcontext()

    # --- per-device placement (ref: :557-708) -------------------------------

    @staticmethod
    def _residency_key(batch) -> tuple:
        t = getattr(batch, "table", None)
        return (getattr(t, "id", None), getattr(batch, "start", b""), getattr(batch, "end", b""),
                getattr(batch, "version", None), batch.n_rows)

    def _mirror_key(self, lane: DeviceLane) -> tuple:
        return (str(lane.device), self.tile_compression)

    @property
    def breaker(self):
        """Lane 0's breaker — the single-device view."""
        return self.lanes[0].breaker

    def set_active_lanes(self, n: int) -> None:
        """Route cop tasks over only the first `n` lanes; 0 = every lane."""
        n = int(n)
        if n <= 0 or n > len(self._all_lanes):
            n = len(self._all_lanes)
        self.lanes = self._all_lanes[:n]

    def limit_lanes(self, n: int) -> None:
        """SHRINK the dispatch width to at most `n` lanes (never widens)."""
        self.set_active_lanes(min(max(1, n), len(self.lanes)))

    def place(self, batch: ColumnBatch, sched=None, gate_breakers: bool = False,
              stats=None, weighted: bool = False) -> DeviceLane | None:
        """Choose the runner lane for one cop task and bump its occupancy
        (the caller MUST `release_lane`). The reference's policy (:597):
        residency affinity, a spill to an idle sibling when the resident
        lane is oversubscribed past the fair share + SPILL_SLACK, lanes
        whose breaker rejects skipped under `gate_breakers` (None when all
        refuse), and with `weighted` an order by (occupancy + 1) x the
        lane's observed per-task EWMA wall."""
        lanes = self.lanes
        mirrors = getattr(batch, "_gpu_mirrors", None) or {}
        rkey = self._residency_key(batch)
        with self._place_lock:
            if weighted:
                seen = sorted(l.ewma_ms for l in lanes if l.ewma_ms > 0.0)
                base = seen[len(seen) // 2] if seen else 1.0
                cost = lambda l: ((l.occupancy + 1) * (l.ewma_ms if l.ewma_ms > 0.0 else base),  # noqa: E731
                                  l.occupancy, l.idx)
            else:
                cost = lambda l: (l.occupancy, l.idx)  # noqa: E731
            res_idx = {l.idx for l in self._all_lanes if self._mirror_key(l) in mirrors}
            res_idx |= self._residency.get(rkey) or set()
            order: list[DeviceLane] = []
            resident = [l for l in lanes if l.idx in res_idx]
            if resident:
                r = min(resident, key=cost)
                load = 0
                if sched is not None:
                    sc = getattr(sched, "scheduler", None)
                    if sc is not None:
                        load = sc.running() + sc.queue_depth()
                fair = max(1.0, load / len(lanes))
                if not (r.occupancy > fair + self.SPILL_SLACK
                        and any(l.occupancy == 0 for l in lanes if l is not r)):
                    order.append(r)
            chosen_first = order[0] if order else None
            order += sorted((l for l in lanes if l is not chosen_first), key=cost)
            rerouted = False
            for lane in order:
                if gate_breakers and not lane.breaker.allow():
                    rerouted = True
                    continue
                if resident and lane.idx not in res_idx:
                    M.TPU_LANE_REROUTES.inc(device=lane.name, reason="breaker" if rerouted else "spill")
                    if stats is not None:
                        stats("lane_reroutes" if rerouted else "lane_spills", 1)
                lane.occupancy += 1
                M.TPU_LANE_OCCUPANCY.set(lane.occupancy, device=lane.name)
                return lane
        return None

    def release_lane(self, lane: DeviceLane) -> None:
        with self._place_lock:
            lane.occupancy -= 1
            M.TPU_LANE_OCCUPANCY.set(lane.occupancy, device=lane.name)

    def note_lane(self, lane: DeviceLane, wall_ms: float, ok: bool = True) -> None:
        """A placed task's observed wall: success folds into the lane's
        EWMA; a device fault doubles the believed cost (ref: :678)."""
        with self._place_lock:
            if ok:
                lane.ewma_ms = wall_ms if lane.ewma_ms <= 0.0 else 0.7 * lane.ewma_ms + 0.3 * wall_ms
            else:
                lane.faults += 1
                lane.ewma_ms = max(lane.ewma_ms, wall_ms, 0.001) * 2.0

    def breakers_describe(self) -> str:
        return ", ".join(f"{l.name}:{l.breaker.state}" for l in self.lanes)

    def raise_breakers_open(self) -> None:
        """Forced device engine with EVERY lane's breaker rejecting."""
        if len(self.lanes) == 1:
            self.lanes[0].breaker.raise_open()
        raise CircuitBreakerOpen(
            f"every device lane's circuit breaker rejected the request "
            f"(state=open on all {len(self.lanes)} lanes: "
            f"{self.breakers_describe()}); use engine='host'/'auto' or "
            f"wait out the cooldown"
        )

    # --- public ------------------------------------------------------------

    @staticmethod
    def tile_count(batch: ColumnBatch) -> int:
        """Padded tile count at the legacy full-tile width (ref: :713)."""
        return max((batch.n_rows + TILE_ROWS - 1) // TILE_ROWS, 1)

    def tile_bucket(self, batch: ColumnBatch) -> tuple[int, int]:
        """(tile count, row bucket) a batch pads to under the current
        layout — the static-shape class the batcher's groups key on."""
        return tile_shape(batch.n_rows, self.tile_compression)

    def _plan_for(self, dag: DAGRequest, batch: ColumnBatch, lane: DeviceLane | None = None):
        """The batch's mirror on the lane's card (built and uploaded at
        first use), then the lowered plan, or None for a declined DAG."""
        lane = lane or self.lanes[0]
        mirrors = getattr(batch, "_gpu_mirrors", None)
        if mirrors is None:
            mirrors = batch._gpu_mirrors = {}
        mkey = self._mirror_key(lane)
        dev = mirrors.get(mkey)
        if dev is None:
            dev = mirrors[mkey] = DeviceBatch(batch, lane.device, compress=self.tile_compression)
            with self._place_lock:
                if len(self._residency) > 4096:
                    self._residency.clear()
                self._residency.setdefault(self._residency_key(batch), set()).add(lane.idx)
        return self._lower(dag, dev)

    def _boundary(self):
        """The device boundary (copr/retry.device_boundary): a card's
        faults leave the engine as DeviceTransientError / DeviceFatalError."""
        return device_boundary(self.device.type == "cuda")

    def _decline(self, dag: DAGRequest, batch: ColumnBatch) -> Chunk:
        with self._lock:
            self.fallbacks += 1
        M.TPU_FALLBACK.inc(path="cop", reason="not_lowerable")
        return execute_dag_host(dag, batch)

    def execute(self, dag: DAGRequest, batch: ColumnBatch, lane: DeviceLane | None = None,
                _solo_event: bool = True) -> Chunk:
        """Run one cop DAG over one region batch → the partial chunk the
        reference's TPUEngine.execute returns for the same inputs."""
        placed = None
        if lane is None:
            lane = placed = self.place(batch)
        try:
            with _lane_guard(lane):
                t0 = time.perf_counter_ns()
                with self._boundary():
                    plan = self._plan_for(dag, batch, lane)
                    if plan is None:
                        return self._decline(dag, batch)
                    (fetched,) = self._fetch([plan.launch()])
                with self.phase("finalize"):
                    chunk = plan.finalize(fetched)
                if _solo_event:
                    lane.launches += 1
                    M.TPU_LANE_LAUNCHES.inc(device=lane.name, mode="solo")
                    tl = TL.active()
                    if tl is not None:
                        tl.device_event("cop.launch", "launch", t0, time.perf_counter_ns(),
                                        launch_id=tracing._next_id(), occupancy=1, device=lane.name)
                return chunk
        finally:
            if placed is not None:
                self.release_lane(placed)

    def execute_many(self, items: list, lane: DeviceLane | None = None) -> list[Chunk]:
        """Run (DAG, batch) cop tasks with launch amortization on one lane
        (module doc); → one partial chunk per task, each equal to its
        solo `execute`."""
        placed = None
        if lane is None:
            if items:
                lane = placed = self.place(items[0][1])
            else:
                lane = self.lanes[0]
        try:
            with _lane_guard(lane):
                return self._execute_many_on(items, lane)
        finally:
            if placed is not None:
                self.release_lane(placed)

    def _execute_many_on(self, items: list, lane: DeviceLane) -> list[Chunk]:
        """The reference's two tiers (:800): tasks sharing a program key
        (same rewritten DAG, tile bucket and lane codecs) form groups of
        up to MAX_FUSE, each run as one grouped launch; everything
        launched, grouped or single, comes back in ONE fetch.

        A group narrows every task to `width` flattened rows: a
        single-tile group to the power-of-two bucket of its largest task,
        a multi-tile group its last tile to a power-of-two remainder
        (None when that is the padded width). `gcap`, the next power of
        two of the group's size, is the reference's program size class:
        the port launches the real tasks only and keeps (key, gcap,
        width) as the group's program key."""
        with self._boundary():
            plans = [self._plan_for(dag, batch, lane) for dag, batch in items]
            results: list = [None] * len(items)
            fusable: dict = {}  # program key -> [task index]
            # (task indices, outputs, split: (fetched, j) -> task j's part or
            # None for a solo launch) in launch order
            launched = []
            for i, (plan, (dag, batch)) in enumerate(zip(plans, items)):
                if plan is None:
                    results[i] = self._decline(dag, batch)
                else:
                    fusable.setdefault(plan.key, []).append(i)
            for key, idx_list in fusable.items():
                for lo in range(0, len(idx_list), self.MAX_FUSE):
                    grp = idx_list[lo:lo + self.MAX_FUSE]
                    if len(grp) == 1:  # a group of one launches solo
                        launched.append((grp, plans[grp[0]].launch(), None))
                        continue
                    t_, r_ = plans[grp[0]].args[1].shape
                    need = max(plans[i].rows for i in grp)
                    w = pow2_rows(need) if t_ == 1 else (t_ - 1) * r_ + pow2_rows(need - (t_ - 1) * r_)
                    width = w if w < t_ * r_ else None
                    group = self._vmapped_program(key, 1 << (len(grp) - 1).bit_length(), width)
                    # a group's outputs, with the function that cuts out each task's
                    outs, split = group([plans[i].args for i in grp], t_ * r_ if width is None else width)
                    launched.append((grp, outs, split))
            fetched = self._fetch([outs for _, outs, _ in launched]) if launched else []
        with self.phase("finalize"):
            for (idx, _, split), host in zip(launched, fetched):
                for j, i in enumerate(idx):
                    results[i] = plans[i].finalize(host if split is None else split(host, j))
        return results

    def _vmapped_program(self, key, gcap: int, width):
        """The group program of `key` at size class `gcap` and narrowed
        `width` (ref: :1096), counted as a program of its own."""
        with self._lock:
            vkey = (key, gcap, width)
            if vkey in self._vprograms:
                M.TPU_COMPILE_CACHE.inc(result="hit")
            else:
                M.TPU_COMPILE_CACHE.inc(result="miss")
                self._vprograms[vkey] = self._raw[key]
                self.compile_count += 1
            return self._vprograms[vkey]

    def _program(self, key, group=None) -> None:
        """Record `key`'s program (a compile in the reference's count, :1051)
        and its group program, the K10 task-grid callable (None: an
        escalated sort-aggregation capacity, whose group program the first
        plan lowered at that capacity records)."""
        with self._lock:
            if group is not None:
                self._raw.setdefault(key, group)
            if key in self._programs:
                M.TPU_COMPILE_CACHE.inc(result="hit")
            else:
                M.TPU_COMPILE_CACHE.inc(result="miss")
                self._programs.add(key)
                self.compile_count += 1

    def _fetch(self, outs: list) -> list:
        """Device→host for every launch's outputs (a list of lists of
        tensors and host values) with ONE host synchronization: the
        tensors' bytes are gathered into one buffer on the card and copied
        back once; host values pass through (ref: :119 _fetch)."""
        tensors = [t for o in outs for t in o if isinstance(t, torch.Tensor)]
        t0 = time.perf_counter_ns()
        with self.phase("d2h"):
            if tensors and tensors[0].device.type == "cuda":
                buf = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
                host, off = [], 0
                for t in tensors:
                    nb = t.numel() * t.element_size()
                    host.append(_host_of(t, buf[off:off + nb]))
                    off += nb
            else:
                host = [t.numpy() for t in tensors]
        t1 = time.perf_counter_ns()
        nbytes = sum(h.nbytes for h in host)
        with self._lock:
            self.fetches += 1
        M.TPU_EXECUTE_SECONDS.observe((t1 - t0) / 1e9)
        M.TPU_TRANSFER_BYTES.inc(nbytes, dir="d2h")
        tracing.add_phase("execute_ms", (t1 - t0) / 1e6)
        tracing.add_phase("d2h_bytes", nbytes)
        tracing.add_phase_event("device.execute", t0, t1, d2h_bytes=int(nbytes))
        it = iter(host)
        return [[next(it) if isinstance(t, torch.Tensor) else t for t in o] for o in outs]

    # --- lowering ----------------------------------------------------------

    def _lower(self, dag: DAGRequest, dev: DeviceBatch):
        """→ the DevicePlan of `dag` over `dev`, or None if this DAG can't
        run on device (host fallback, as the reference)."""
        scan_offs = dag.scan.col_offsets
        used: set[int] = set()
        conds = dag.selection.conds if dag.selection else []
        for c in conds:
            c.collect_columns(used)
        if dag.agg:
            for g in dag.agg.group_by:
                g.collect_columns(used)
            for a in dag.agg.aggs:
                for e in a.args:
                    e.collect_columns(used)
        elif dag.topn:
            for e, _ in dag.topn.by:
                e.collect_columns(used)
            used |= set(range(len(scan_offs)))
        else:
            used |= set(range(len(scan_offs)))

        lanes = {}
        vocabs = {}
        for i in sorted(used):
            off = scan_offs[i]
            lanes[i] = dev.lanes(off, self.phase)
            if off in dev.vocabs:
                vocabs[i] = dev.vocabs[off]

        r_conds = [self._rewrite(c, vocabs) for c in conds]
        if any(c is None for c in r_conds):
            return None
        # lanes of BIGINT UNSIGNED columns decode to U64 (xp_torch)
        unsigned = {i for i in used
                    if i not in vocabs and dev.batch.data[scan_offs[i]].dtype == np.uint64}
        # the static half of every program key (ref: :927-936): the tile
        # shape and each used lane's codec signature — tasks whose lanes
        # encoded differently never share a launch group
        sig = (dev.t, dev.r) + tuple((i, dev.lane_sigs.get(scan_offs[i], ((), ()))) for i in sorted(used))
        low = (dev, lanes, r_conds, unsigned, sig)
        if dag.agg is not None:
            return self._lower_agg(dag, vocabs, *low)
        if dag.topn is not None:
            return self._lower_topn(dag, vocabs, *low)
        return self._lower_filter(dag, *low)

    def _plan(self, key, launch, finalize, dev: DeviceBatch, lanes: dict, group) -> DevicePlan:
        """The DevicePlan of a lowering, its program recorded under `key`
        with its group program: `group(argss, width)` → (outputs, split),
        `split(fetched, j)` cutting task j's part out of the fetched
        outputs (`_stacked`: row j of each)."""
        self._program(key, group)
        flat = [x for i in sorted(lanes) for x in lanes[i]]
        return DevicePlan(launch, finalize, key=key, args=(flat, dev.row_valid), rows=dev.batch.n_rows)

    # --- string/dict rewriting --------------------------------------------

    def _rewrite(self, e: Expression, vocabs: dict[int, list]):
        """Rewrite an expression into device (code-space) form; None if not
        lowerable. String columns become int32 code lanes; comparisons with
        string constants map through the sorted vocab so code order ==
        collation order."""
        if isinstance(e, ExprCol):
            return e
        if isinstance(e, Constant):
            if e.value.kind in (K_STR, K_BYTES):
                return None
            return e
        if not isinstance(e, ScalarFunc):
            return None
        name = e.sig.name
        if name in _CMP_SWAP and len(e.args) == 2:
            a, b = e.args
            if isinstance(b, ExprCol) and isinstance(a, Constant):
                a, b = b, a
                name = _CMP_SWAP[name]
            if isinstance(a, ExprCol) and a.idx in vocabs and isinstance(b, Constant):
                if b.value.kind not in (K_STR, K_BYTES):
                    return None
                return self._code_cmp(name, a, b, vocabs[a.idx])
            if isinstance(a, ExprCol) and a.idx in vocabs:
                return None
        if name == "in" and isinstance(e.args[0], ExprCol) and e.args[0].idx in vocabs:
            vocab = vocabs[e.args[0].idx]
            codes = []
            for c in e.args[1:]:
                if not isinstance(c, Constant) or c.value.kind not in (K_STR, K_BYTES):
                    return None
                i, present = vocab.lookup(c.value.to_str())
                codes.append(i if present else -1)
            col = ExprCol(e.args[0].idx, ft_longlong(), e.args[0].name)
            from ..expr.expression import make_func

            return make_func("in", col, *[Constant(Datum.i(c), ft_longlong()) for c in codes])
        for a in e.args:
            if isinstance(a, ExprCol) and a.idx in vocabs:
                return None
        new_args = [self._rewrite(a, vocabs) for a in e.args]
        if any(a is None for a in new_args):
            return None
        return ScalarFunc(e.sig, new_args, e.ret_type)

    def _code_cmp(self, op: str, col: ExprCol, const: Constant, vocab: Vocab):
        """col <op> 'str' → code-space comparison via sorted-vocab bisect."""
        from ..expr.expression import make_func

        pos, present = vocab.lookup(const.value.to_str())
        icol = ExprCol(col.idx, ft_longlong(), col.name)

        def c(v):
            return Constant(Datum.i(v), ft_longlong())

        if op == "eq":
            return make_func("eq", icol, c(pos if present else -1))
        if op == "ne":
            return make_func("ne", icol, c(pos if present else -1))
        if op == "lt":
            return make_func("lt", icol, c(pos))
        if op == "ge":
            return make_func("ge", icol, c(pos))
        if op == "le":
            return make_func("lt" if not present else "le", icol, c(pos))
        if op == "gt":
            return make_func("ge" if not present else "gt", icol, c(pos))
        return None

    # --- device evaluation (K2/K3: the expression kernel) -----------------

    def _evaluate(self, r_conds, specs, lanes, dev: DeviceBatch, force: bool = False):
        """One expression program over the decoded lanes (ref: :1021
        _eval_device, :1044 _mask): → (flat mask, [(data lanes, valid,
        kind)] per ValueSpec). The mask is row_valid itself when there is
        no condition, unless `force` (the filter program) launches it."""
        mask, vals = evaluate(self.programs, r_conds, specs, lanes, dev.row_valid, dev.padded, force=force)
        return mask.reshape(-1), vals

    def _decode(self, dev: DeviceBatch, lanes: dict, unsigned: set):
        """K1 over every used lane (the reference's _unflatten): each
        lane's data and valid payloads, the coded ones in one launch."""
        order = list(lanes)
        got = decode_lanes([x for i in order for x in lanes[i]], dev.row_valid)
        out = {}
        for k, i in enumerate(order):
            dd = got[2 * k]
            out[i] = (U64(dd) if i in unsigned else dd, got[2 * k + 1])
        return out

    @staticmethod
    def _decode_tasks(argss: list, order: list, unsigned: set, width: int, only=None) -> list:
        """K10's decode: K1's task mode over each used lane of a launch
        group's tasks (`argss`: each task's (flat lanes, row_valid), in
        `order`) → per task the lanes dict `_decode` gives, each lane read
        to `width`; with `only`, just those lanes. Every coded data and
        valid lane of every task in one launch."""
        rvs = [rv for _, rv in argss]
        picked = [(k, i) for k, i in enumerate(order) if only is None or i in only]
        got = decode_lanes_tasks([[flat[2 * k + h] for flat, _ in argss] for k, _ in picked for h in (0, 1)],
                                 rvs, width)
        out = [{} for _ in argss]
        for j, (_, i) in enumerate(picked):
            for g, (d, v) in enumerate(zip(got[2 * j], got[2 * j + 1])):
                out[g][i] = (U64(d) if i in unsigned else d, v)
        return out

    # --- filter-only --------------------------------------------------------

    def _lower_filter(self, dag: DAGRequest, dev: DeviceBatch, lanes, r_conds, unsigned, sig):
        """The filter program (ref: :1138): the mask comes back, the host
        filters the batch's rows (and applies a LIMIT)."""
        order = sorted(lanes)

        def launch():
            with self.phase("decode"):
                l = self._decode(dev, lanes, unsigned)
            with self.phase("expr_eval"):
                mask, _ = self._evaluate(r_conds, [], l, dev, force=True)
            return [mask]

        def group(argss, width):  # K10: K1 → expression kernel, task-grid modes
            with self.phase("decode"):
                l = self._decode_tasks(argss, order, unsigned, width)
            with self.phase("expr_eval"):
                mask, _ = evaluate_tasks(self.programs, r_conds, [], l, [rv for _, rv in argss], width, force=True)
            return [mask], _stacked

        def finalize(fetched):
            mask = fetched[0].reshape(-1)[: dev.batch.n_rows]
            chunk = dev.batch.to_chunk(dag.scan.col_offsets).filter(mask)
            if dag.limit is not None:
                chunk = chunk.slice(0, min(dag.limit.n, chunk.num_rows))
            return chunk

        return self._plan(("filter", repr(r_conds), sig), launch, finalize, dev, lanes, group)

    # --- aggregation --------------------------------------------------------

    def _lower_agg(self, dag: DAGRequest, vocabs, dev: DeviceBatch, lanes, r_conds, unsigned, sig):
        agg = dag.agg
        gb = agg.group_by
        wide_keys = False
        for g in gb:
            if not isinstance(g, ExprCol):
                return None
            if g.idx not in vocabs:
                d = dev.batch.data[dag.scan.col_offsets[g.idx]]
                if d.dtype == np.float64 or d.dtype == np.uint64:
                    wide_keys = True
        from ..mysqltypes import collate as _coll

        dev_args = []
        for a in agg.aggs:
            if a.name not in (
                "count", "sum", "avg", "min", "max", "first_row",
                "stddev_pop", "stddev_samp", "var_pop", "var_samp",
                "bit_and", "bit_or", "bit_xor",
            ):
                return None
            if (
                a.name in ("min", "max")
                and a.args
                and a.args[0].ret_type.is_string()
                and _coll.is_ci(getattr(a.args[0].ret_type, "collate", None))
            ):
                # dict codes collapse a ci weight class to ONE vocab
                # representative chosen batch-wide (pre-filter): host path
                return None
            r_args = [
                self._rewrite(x, vocabs) if not (isinstance(x, ExprCol) and x.idx in vocabs)
                else (x if a.name in ("min", "max", "first_row", "count") else None)
                for x in a.args
            ]
            if any(x is None for x in r_args):
                return None
            dev_args.append(r_args)

        # direct addressing needs NULL-free keys with small finite domains
        domains = []
        key_cols = []
        direct = not wide_keys
        for g in gb:
            if not direct:
                break
            if g.idx in vocabs:
                domains.append(max(len(vocabs[g.idx]), 1))
            else:
                d = dev.batch.data[dag.scan.col_offsets[g.idx]]
                v = dev.batch.valid[dag.scan.col_offsets[g.idx]]
                if not v.all() or len(d) == 0:
                    direct = False
                    break
                lo, hi = int(d.min()), int(d.max())
                if hi - lo + 1 > DIRECT_GROUP_MAX:
                    direct = False
                    break
                domains.append(hi - lo + 1)
                key_cols.append((g.idx, lo))
                continue
            key_cols.append((g.idx, 0))
        nseg = 1
        for s in domains:
            nseg *= s + 1  # +1 slot for NULL keys
        if not direct or nseg > DIRECT_GROUP_MAX:
            return self._lower_agg_sorted(dag, dev, lanes, vocabs, r_conds, unsigned, dev_args, sig)

        specs = [self._agg_spec(a, r_args) for a, r_args in zip(agg.aggs, dev_args)]
        vspecs = [s for s in specs if s is not None]
        order = sorted(lanes)

        def seg_inputs(l, vals, view):
            """K4's key lanes and value lanes (the group count first)."""
            keys = [SegKey(l[idx][0].reshape(-1), self._valid_arg(l[idx][1], view), lo, dom)
                    for (idx, lo), dom in zip(key_cols, domains)]
            seg_lanes = [SegLane("count")]  # group_count: masked-in rows per slot
            seg_lanes += self._agg_lanes(agg.aggs, specs, vals, view, nseg)
            return keys, seg_lanes

        def launch():
            with self.phase("decode"):
                l = self._decode(dev, lanes, unsigned)
            with self.phase("expr_eval"):
                flat_mask, vals = self._evaluate(r_conds, vspecs, l, dev)
            with self.phase("agg_args"):
                keys, seg_lanes = seg_inputs(l, vals, dev)
            with self.phase("seg_agg"):
                i_mat, f_mat = self.seg_agg(flat_mask, keys, seg_lanes, nseg)
            return [i_mat, f_mat, self._layout(seg_lanes)]

        def group(argss, width):  # K10: K1 → expression kernel → K4, task-grid modes
            rvs = [rv for _, rv in argss]
            with self.phase("decode"):
                ls = self._decode_tasks(argss, order, unsigned, width)
            with self.phase("expr_eval"):
                mask, vals = evaluate_tasks(self.programs, r_conds, vspecs, ls, rvs, width)
            with self.phase("agg_args"):
                per = [seg_inputs(l, v, _TaskView(rv, width)) for l, v, rv in zip(ls, vals, rvs)]
            with self.phase("seg_agg"):
                i_mat, f_mat = seg_agg_tasks(list(mask), [k for k, _ in per], [s for _, s in per], nseg, width)
            return [i_mat, f_mat, self._layout(per[0][1])], _stacked

        def finalize(fetched):
            i_host, f_host, layout = fetched
            res = [i_host[k] if t == "i" else f_host[k] for t, k in layout]
            return self._agg_outputs_to_chunk(dag, dev, res, domains, key_cols, vocabs, nseg)

        key = ("agg", repr(r_conds), repr([(a.name, repr(x)) for a, x in zip(agg.aggs, dev_args)]),
               repr(key_cols), repr(domains), sig, nseg)
        return self._plan(key, launch, finalize, dev, lanes, group)

    # --- sort-based aggregation (high-cardinality GROUP BY) -----------------

    def _lower_agg_sorted(self, dag: DAGRequest, dev: DeviceBatch, lanes, vocabs, r_conds, unsigned,
                          dev_args, sig):
        """GROUP BY over NULL-able, float, uint64 or wide key domains (ref:
        tpu_engine.py:1324 _lower_agg_sorted): K9 sorts the masked rows by
        (NULL flag, key bits) per key (through K8) and gives each row a
        dense group id; K4 reduces the value lanes over those ids.

        The group capacity starts at gcap0 and, when n_groups overflows
        it, escalates x4 until it fits and is remembered for this DAG
        shape — the reference's escalation, with the same capacities. The
        reference learns n_groups after a full launch and reruns at the
        new capacity; here K9 counts the groups before K4 runs, so the
        first launch already uses the capacity the rerun would — and the
        plan's `launch` synchronizes inside, once, to read that count.
        The plan's key carries the capacity it was lowered at (ref:
        :1443); an escalation records the escalated program as the
        reference's rerun compiles it.

        A launch group (K10) runs the task-grid modes: K1, the expression
        kernel, K9 over every task (K8 sorting by (task, mask, keys) once),
        one host read of every task's n_groups, and K4 over all the tasks'
        rows into their groups, numbered on across the tasks. Then, task by
        task, a count above the plan's capacity escalates it as the
        reference's per-task rerun does (:1413-1440): the same `_gcap`,
        programs and compile count. No task reruns: the counts, not the
        capacity, size the outputs."""
        agg = dag.agg
        key_idx = [g.idx for g in agg.group_by]
        if not key_idx:
            return None
        base_key = ("aggsort", repr(r_conds), repr([(a.name, repr(x)) for a, x in zip(agg.aggs, dev_args)]),
                    repr(key_idx), sig)
        gcap = self._gcap.get(base_key, self.gcap0)

        def cap_of(ng: int) -> int:
            # from the capacity this plan was lowered at, as the
            # reference's rerun escalates from its plan's (:1418)
            cap = gcap
            if ng > cap:
                while cap < ng:
                    cap <<= 2
                with self._lock:
                    self._gcap[base_key] = cap
                self._program(base_key + (cap,))
            return cap

        specs = [self._agg_spec(a, r_args) for a, r_args in zip(agg.aggs, dev_args)]
        vspecs = [s for s in specs if s is not None]
        order = sorted(lanes)

        def launch():
            with self.phase("decode"):
                l = self._decode(dev, lanes, unsigned)
            with self.phase("expr_eval"):
                flat_mask, vals = self._evaluate(r_conds, vspecs, l, dev)
            with self.phase("sort"):
                keys = [(self._flat(l[ki][0], dev.padded), self._valid_arg(l[ki][1], dev))
                        for ki in key_idx]
                g = self.sort_groups(flat_mask, keys, cap_of)
            with self.phase("agg_args"):
                seg_lanes = self._agg_lanes(agg.aggs, specs, vals, dev, g.cap)
            ng = g.n_groups  # only [:n_groups] reaches the chunk
            out = [g.kval[:, :ng], g.kvalid[:, :ng], None, None, [], ng]
            if seg_lanes:
                with self.phase("seg_agg"):
                    i_mat, f_mat = self.seg_agg(flat_mask, [], seg_lanes, g.cap, seg=g.seg)
                out[2:5] = [i_mat[:, :ng], f_mat[:, :ng], self._layout(seg_lanes)]
            return out

        def group(argss, width):  # K10: K1 → expression kernel → K9 (K8) → K4, task-grid modes
            rvs = [rv for _, rv in argss]
            views = [_TaskView(rv, width) for rv in rvs]
            with self.phase("decode"):
                ls = self._decode_tasks(argss, order, unsigned, width)
            with self.phase("expr_eval"):
                masks, vals = evaluate_tasks(self.programs, r_conds, vspecs, ls, rvs, width)
            masks = [m.reshape(-1) for m in masks]
            with self.phase("sort"):
                keys = [[(self._flat(l[ki][0], width), self._valid_arg(l[ki][1], view)) for ki in key_idx]
                        for l, view in zip(ls, views)]
                g = sort_groups_tasks(masks, keys, width)
                for ng in g.counts:  # the reference's per-task reruns, in task order
                    cap_of(ng)
            total = sum(g.counts)
            with self.phase("agg_args"):
                per = [self._agg_lanes(agg.aggs, specs, v, view, total) for v, view in zip(vals, views)]
            outs = [g.kval, g.kvalid, None, None, []]
            if per[0]:
                with self.phase("seg_agg"):
                    if total:
                        i_mat, f_mat = seg_agg_tasks(masks, [[] for _ in masks], per, total, width,
                                                     segs=list(g.seg), counts=g.counts)
                    else:  # no group in any task: nothing to reduce
                        n_i = sum(1 for lane in per[0] if not lane.is_float)
                        i_mat = torch.empty((n_i, 0), dtype=torch.int64, device=masks[0].device)
                        f_mat = torch.empty((len(per[0]) - n_i, 0), dtype=torch.float64, device=masks[0].device)
                outs[2:5] = [i_mat, f_mat, self._layout(per[0])]
            offs = np.cumsum([0] + g.counts).tolist()

            def split(host, j):  # task j's groups: columns offs[j]:offs[j + 1]
                a, b = offs[j], offs[j + 1]
                return [h[:, a:b] if isinstance(h, np.ndarray) else h for h in host] + [b - a]

            return outs, split

        def finalize(fetched):
            kval, kvalid, i_host, f_host, layout, ng = fetched
            res = [row for j in range(len(key_idx)) for row in (kval[j], kvalid[j])]
            res += [i_host[k] if t == "i" else f_host[k] for t, k in layout]
            return self._agg_sorted_to_chunk(dag, dev, res, key_idx, vocabs, ng)

        return self._plan(base_key + (gcap,), launch, finalize, dev, lanes, group)

    def _agg_sorted_to_chunk(self, dag, dev, outs, key_idx, vocabs, ng):
        """Sorted partials → chunk (copy of TPUEngine._agg_sorted_to_chunk)."""
        out_fts = dag.output_types()
        present = np.arange(ng)
        cols: list[Column] = []
        pos = 0
        oi = 0
        for ki in key_idx:
            kval = np.asarray(outs[pos])[:ng]
            valid = np.asarray(outs[pos + 1])[:ng] == 1
            ft = out_fts[oi]
            if ki in vocabs:
                vocab = vocabs[ki]
                data = np.empty(ng, dtype=object)
                for j in range(ng):
                    c = int(kval[j])
                    data[j] = vocab[c] if valid[j] and 0 <= c < len(vocab) else None
            else:
                # undo the kernel's bit-pattern canonicalization
                src_dt = dev.batch.data[dag.scan.col_offsets[ki]].dtype
                data = kval.astype(np.int64)
                if src_dt == np.float64:
                    data = data.view(np.float64).copy()
                    data[~valid] = 0.0
                elif src_dt == np.uint64:
                    data = data.view(np.uint64).copy()
                    data[~valid] = 0
                else:
                    data[~valid] = 0
            cols.append(Column(ft, data, valid))
            pos += 2
            oi += 1
        cols.extend(self._agg_value_cols(dag, dev, outs, pos, oi, present, vocabs))
        return Chunk(cols)

    @staticmethod
    def _device_lanes(lanes: dict, exprs) -> dict:
        """The lanes the device reads for `exprs`. A TopN uploads every
        scan column (its rows come back from the batch) but computes on the
        filter and key columns only; the reference's fused program drops
        the other decodes as dead code, and so does the port."""
        used: set[int] = set()
        for e in exprs:
            e.collect_columns(used)
        return {i: lanes[i] for i in sorted(used)}

    @staticmethod
    def _flat(x, n: int):
        """A device value as a flat contiguous [n] lane (a 0-d constant is
        broadcast); U64 stays U64."""
        if isinstance(x, U64):
            return U64(TorchEngine._flat(x.bits, n))
        return x.reshape(-1) if x.ndim else x.expand(n).contiguous()

    @staticmethod
    def _valid_arg(v, dev: DeviceBatch):
        """A valid lane for the kernel: None when it is row_valid itself
        (every masked-in row is valid), else the flat bool lane."""
        if v is dev.row_valid:
            return None
        return TorchEngine._flat(v, dev.padded)

    @staticmethod
    def _layout(seg_lanes):
        """Each SegLane's row in K4's packed matrices (K5: the int lanes
        in order, then the float lanes), in output order."""
        layout, ki, kf = [], 0, 0
        for lane in seg_lanes:
            if lane.is_float:
                layout.append(("f", kf))
                kf += 1
            else:
                layout.append(("i", ki))
                ki += 1
        return layout

    @staticmethod
    def _agg_spec(a, r_args):
        """The expression program's output an aggregate reads (ref: the
        argument evaluation of :1527 _agg_partials_device); None for an
        argument-free COUNT(*)."""
        if not r_args:
            return None
        x = r_args[0]
        if a.name in ("count", "first_row"):
            return ValueSpec(x, "valid")
        ft = a.args[0].ret_type
        if a.name in _VAR:
            return ValueSpec(x, "var_dec" if ft.is_decimal() else "var_f")
        if a.name in _BIT:
            return ValueSpec(x, "bit", max(ft.decimal, 0) if ft.is_decimal() else -1)
        return ValueSpec(x)

    def _agg_lanes(self, aggs, specs, vals, dev: DeviceBatch, nseg: int) -> list:
        """SegLanes of every aggregate's partials, in the reference's
        output order (ref: :1527 _agg_partials_device), from the program's
        outputs."""
        it = iter(vals)
        lanes = []
        for a, spec in zip(aggs, specs):
            lanes += self._agg_partials_device(a, None if spec is None else next(it), dev, nseg)
        return lanes

    def _agg_partials_device(self, a, out, dev: DeviceBatch, nseg: int) -> list:
        name = a.name
        n = dev.padded
        datas, vv, kind = ([], None, "i64") if out is None else (out[0], self._valid_arg(out[1], dev), out[2])

        def cnt():
            return SegLane("count", valid=vv)

        if name == "count":
            return [cnt()]
        if name in ("sum", "avg"):
            d = datas[0]
            s = SegLane("sum_f64", d, vv) if kind == "f64" else SegLane("sum_i64", d.to(torch.int64), vv)
            return [s, cnt()]
        if name in ("min", "max"):
            if kind == "f64":
                op, big, small = "f64", float("inf"), float("-inf")
            else:
                # sentinels in the lane's OWN dtype (uint64 / int32 codes)
                info = np.iinfo({"u64": np.uint64, "i32": np.int32}.get(kind, np.int64))
                op, big, small = ("u64" if kind == "u64" else "i64"), int(info.max), int(info.min)
            x = datas[0] if kind == "f64" else datas[0].to(torch.int64)
            return [SegLane(f"{name}_{op}", x, vv, big if name == "min" else small), cnt()]
        if name == "first_row":
            return [SegLane("first_row", valid=vv, fill=n if nseg <= SEG_DENSE_MAX else int(_I64.max))]
        if name in _VAR:
            # (cnt, sum, sumsq) partials; decimals ship (int64 wrap-sum,
            # float estimate) pairs of the SCALED ints and their 32-bit
            # limbs, rebuilt exactly on the host (host_engine.exact_sum64)
            ops = ["sum_i64", "sum_f64"] * 4 if len(datas) == 8 else ["sum_f64", "sum_f64"]
            return [cnt()] + [SegLane(op, d, vv) for op, d in zip(ops, datas)]
        if name in _BIT:
            op, fill = _BIT[name]
            return [SegLane(op, datas[0], vv, fill)]
        raise NotImplementedError(name)

    def _agg_outputs_to_chunk(self, dag, dev, outs, domains, key_cols, vocabs, nseg):
        out_fts = dag.output_types()
        group_count = np.asarray(outs[0])
        present = np.nonzero(group_count > 0)[0]
        G = len(present)
        cols: list[Column] = []
        radix = [d + 1 for d in domains]
        codes = present.copy()
        key_vals = []
        for r in reversed(radix):
            key_vals.append(codes % r)
            codes = codes // r
        key_vals.reverse()
        oi = 0
        for (idx, lo), kv in zip(key_cols, key_vals):
            ft = out_fts[oi]
            valid = kv > 0
            if idx in vocabs:
                vocab = vocabs[idx]
                data = np.empty(G, dtype=object)
                for j, code in enumerate(kv):
                    data[j] = vocab[code - 1] if code > 0 else None
            else:
                data = (kv.astype(np.int64) - 1) + lo
                data[~valid] = 0
            cols.append(Column(ft, data, valid))
            oi += 1
        cols.extend(self._agg_value_cols(dag, dev, outs, 1, oi, present, vocabs))
        return Chunk(cols)

    def _agg_value_cols(self, dag, dev, outs, pos, oi, present, vocabs):
        """Partial-state → Column decode (copy of TPUEngine._agg_value_cols)."""
        agg = dag.agg
        out_fts = dag.output_types()
        G = len(present)
        cols: list[Column] = []
        for a in agg.aggs:
            if a.name == "count":
                cnt = np.asarray(outs[pos])[present]
                cols.append(Column(out_fts[oi], cnt.astype(np.int64), np.ones(G, dtype=bool)))
                pos += 1
                oi += 1
            elif a.name in ("sum", "avg"):
                s = np.asarray(outs[pos])[present]
                cnt = np.asarray(outs[pos + 1])[present]
                has = cnt > 0
                sd = s if out_fts[oi].is_float() else s.astype(np.int64)
                cols.append(Column(out_fts[oi], sd, has))
                oi += 1
                if a.name == "avg":
                    cols.append(Column(out_fts[oi], cnt.astype(np.int64), np.ones(G, dtype=bool)))
                    oi += 1
                pos += 2
            elif a.name in ("min", "max"):
                s = np.asarray(outs[pos])[present]
                cnt = np.asarray(outs[pos + 1])[present]
                has = cnt > 0
                ft = out_fts[oi]
                arg = a.args[0]
                if isinstance(arg, ExprCol) and arg.idx in vocabs:
                    vocab = vocabs[arg.idx]
                    data = np.empty(G, dtype=object)
                    for j in range(G):
                        data[j] = vocab[int(s[j])] if has[j] and 0 <= int(s[j]) < len(vocab) else None
                elif ft.is_float():
                    data = s
                elif ft.is_int() and ft.is_unsigned:
                    data = s.astype(np.int64).view(np.uint64).copy()
                    data[~has] = 0
                else:
                    data = np.where(has, s.astype(np.int64), 0)
                cols.append(Column(ft, data, has))
                pos += 2
                oi += 1
            elif a.name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
                ones = np.ones(G, dtype=bool)
                cnt = np.asarray(outs[pos])[present].astype(np.int64)
                arg_ft = a.args[0].ret_type
                if arg_ft.is_decimal():
                    o = [np.asarray(outs[pos + j])[present] for j in range(1, 9)]
                    scale = float(pow10(max(arg_ft.decimal, 0)))
                    s = exact_sum64(o[0], o[1]) / scale
                    sq = exact_sumsq64(o[2], o[3], o[4], o[5], o[6], o[7]) / (scale * scale)
                    pos += 9
                else:
                    s = np.asarray(outs[pos + 1])[present]
                    sq = np.asarray(outs[pos + 2])[present]
                    pos += 3
                cols.append(Column(out_fts[oi], cnt, ones))
                cols.append(Column(out_fts[oi + 1], s, ones))
                cols.append(Column(out_fts[oi + 2], sq, ones))
                oi += 3
            elif a.name in ("bit_and", "bit_or", "bit_xor"):
                val = np.asarray(outs[pos])[present].astype(np.int64)
                cols.append(Column(out_fts[oi], val, np.ones(G, dtype=bool)))
                pos += 1
                oi += 1
            elif a.name == "first_row":
                firsts = np.asarray(outs[pos])[present]
                ft = out_fts[oi]
                n = dev.batch.n_rows
                src_off = dag.scan.col_offsets[a.args[0].idx] if isinstance(a.args[0], ExprCol) else None
                from ..chunk.chunk import col_numpy_dtype, VARLEN

                dt = col_numpy_dtype(ft)
                data = np.empty(G, dtype=object) if dt is VARLEN else np.zeros(G, dtype=dt)
                valid = np.zeros(G, dtype=bool)
                for j, fi in enumerate(firsts):
                    fi = int(fi)
                    if fi < n and src_off is not None:
                        data[j] = dev.batch.data[src_off][fi]
                        valid[j] = dev.batch.valid[src_off][fi]
                cols.append(Column(ft, data, valid))
                pos += 1
                oi += 1
        return cols

    # --- topn ----------------------------------------------------------------

    def _lower_topn(self, dag: DAGRequest, vocabs, dev: DeviceBatch, lanes, r_conds, unsigned, sig):
        """Single-key TopN (ref: tpu_engine.py:1747 _lower_topn): K6 picks
        the k best rows in lax.top_k's order; the host keeps those the
        mask lets through, up to n. A launch group (K10) runs K6's task
        grid, k = min(n, width) a task (the rows past `width` are masked,
        so the chunk is solo's), and one K8 task-leading sort of every
        task's candidates."""
        by = dag.topn.by
        if len(by) != 1:
            return self._lower_topn_multi(dag, vocabs, dev, lanes, r_conds, unsigned, sig)
        e, desc = by[0]
        r_e = self._rewrite(e, vocabs)
        if r_e is None:
            return None
        n = dag.topn.n
        dlanes = self._device_lanes(lanes, r_conds + [r_e])

        def launch():
            with self.phase("decode"):
                l = self._decode(dev, dlanes, unsigned)
            with self.phase("expr_eval"):
                mask, ((datas, v, kind),) = self._evaluate(r_conds, [ValueSpec(r_e)], l, dev)
            with self.phase("sort"):
                # integer keys stay integer (exact for packed datetimes and
                # decimals); a uint64 key keeps its bits, as astype(int64)
                d = datas[0] if kind == "f64" else datas[0].to(torch.int64)
                idx, ok = self.topk(d.contiguous(), self._valid_arg(v, dev), mask, desc, min(n, dev.padded))
            return [idx, ok]

        order = sorted(lanes)

        def group(argss, width):  # K10: K1 → expression kernel → K6 (K8), task-grid modes
            rvs = [rv for _, rv in argss]
            with self.phase("decode"):
                ls = self._decode_tasks(argss, order, unsigned, width, only=dlanes)
            with self.phase("expr_eval"):
                masks, vals = evaluate_tasks(self.programs, r_conds, [ValueSpec(r_e)], ls, rvs, width)
            with self.phase("sort"):
                datas, valids = [], []
                for ((ds, v, kind),), rv in zip(vals, rvs):
                    d = ds[0] if kind == "f64" else ds[0].to(torch.int64)
                    datas.append(self._flat(d, width).contiguous())
                    valids.append(self._valid_arg(v, _TaskView(rv, width)))
                idx, ok = topk_tasks(datas, valids, [m.reshape(-1) for m in masks], desc, min(n, width), width)
            return [idx, ok], _stacked

        def finalize(fetched):
            idx, ok = fetched
            idx = idx[ok]  # drop indices pointing at masked rows
            return dev.batch.to_chunk(dag.scan.col_offsets).take(idx[:n])

        return self._plan(("topn", repr(r_conds), repr(r_e), desc, n, sig), launch, finalize, dev, lanes, group)

    def _lower_topn_multi(self, dag: DAGRequest, vocabs, dev: DeviceBatch, lanes, r_conds, unsigned, sig):
        """Multi-key TopN (ref: tpu_engine.py:1796 _lower_topn_multi): K7
        selects the first min(n, padded) rows in the operands' order and
        returns them with their mask bits. A launch group (K10) runs K7's
        task grid, min(n, width) rows a task."""
        r_by = []
        for e, desc in dag.topn.by:
            r_e = self._rewrite(e, vocabs)
            if r_e is None:
                return None
            r_by.append((r_e, desc))
        n = dag.topn.n
        dlanes = self._device_lanes(lanes, r_conds + [r_e for r_e, _ in r_by])

        def launch():
            with self.phase("decode"):
                l = self._decode(dev, dlanes, unsigned)
            with self.phase("expr_eval"):
                mask, vals = self._evaluate(r_conds, [ValueSpec(r_e) for r_e, _ in r_by], l, dev)
            with self.phase("sort"):
                keys = [(U64(datas[0]) if kind == "u64" else datas[0], self._valid_arg(v, dev), desc)
                        for (datas, v, kind), (_, desc) in zip(vals, r_by)]
                idx, ok = self.topn_multi(mask, keys, min(n, dev.padded))
            return [idx, ok]

        order = sorted(lanes)

        def group(argss, width):  # K10: K1 → expression kernel → K7, task-grid modes
            rvs = [rv for _, rv in argss]
            with self.phase("decode"):
                ls = self._decode_tasks(argss, order, unsigned, width, only=dlanes)
            with self.phase("expr_eval"):
                masks, vals = evaluate_tasks(self.programs, r_conds, [ValueSpec(r_e) for r_e, _ in r_by], ls, rvs,
                                             width)
            with self.phase("sort"):
                keys = [[(U64(ds[0]) if kind == "u64" else ds[0], self._valid_arg(v, _TaskView(rv, width)), desc)
                         for (ds, v, kind), (_, desc) in zip(task, r_by)] for task, rv in zip(vals, rvs)]
                idx, ok = topn_multi_tasks([m.reshape(-1) for m in masks], keys, min(n, width), width)
            return [idx, ok], _stacked

        def finalize(fetched):
            idx, ok = fetched
            return dev.batch.to_chunk(dag.scan.col_offsets).take(idx[ok][:n])

        return self._plan(("topn_multi", repr(r_conds), repr(r_by), n, sig), launch, finalize, dev, lanes, group)
