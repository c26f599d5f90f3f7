"""Device window path — one sort + segmented scans per window spec
(copy of the host side of tidb_tpu/executor/window_device.py).

The reference compiles one XLA program per spec. Here the same steps run
on the card through two hand-written kernels:

    host: lane eval, dict-encode strings, canonical key codes packed
          into a few sort words, pad to P = _bucket(n) rows  ("prep")
      -> upload                                               ("h2d")
      -> W1 kernels/window.window: K8 over the words, partition/peer
         bounds, frames, every function, scatter back to row order
                                                     ("sort", "window")
      -> W2 kernels/pack_flat: one int64 buffer             ("pack")
      -> one device-to-host copy                             ("d2h")
      -> torchenv.unpack_flat and the host post-steps   ("finalize")

The sort order, NULL placement (first asc / last desc) and tie-breaks are
the reference's, so outputs are bit-identical to the host oracle for
integer/decimal/string lanes; float sums match up to summation order.

Strings never reach the card: lanes are dict-encoded to sorted-vocab
codes, computed in code space and decoded on the way out.

A prepared spec (sort words and padded argument lanes, resident on the
card) is kept in a byte-budgeted LRU keyed by the caller's provenance, so
a repeated window over an unchanged batch skips lane evaluation,
encoding, packing and the upload (`run_cached_window`).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..expr.xp_torch import U64
from ..kernels.pack_flat import pack_flat
from ..kernels.window import frame_width, window
from ..mysqltypes.mydecimal import DIV_FRAC_INCR, MAX_SCALE, Dec, pow10
from ..torchenv import resolve_device, unpack_flat

# Below this many rows 'auto' stays on the host; 'tpu' forces the device
# path (tests, EXPLAIN). The reference's figure, kept as its default.
MIN_DEVICE_ROWS = 1 << 15

# func names with a device kernel (everything WindowExec supports)
SUPPORTED = {
    "row_number", "rank", "dense_rank", "ntile", "cume_dist", "percent_rank",
    "lead", "lag", "first_value", "last_value", "nth_value",
    "count", "sum", "avg", "min", "max",
}


def _bucket(n: int) -> int:
    """Pad to a power of two, at least 1024 rows (the reference's rule)."""
    p = 1024
    while p < n:
        p <<= 1
    return p


def encode_obj(d: np.ndarray, v: np.ndarray, extra=None):
    """Dict-encode an object lane to sorted-vocab codes.

    Mirrors `_lex_argsort`'s np.unique trick, so code order == the host's
    binary sort order. `extra` values (lead/lag defaults) share the vocab."""
    strs = np.where(v, d, "").astype("U")
    pool = strs if extra is None else np.concatenate([strs, np.atleast_1d(extra).astype("U")])
    vocab, inv = np.unique(pool, return_inverse=True)
    codes = inv[: len(strs)].astype(np.int64)
    extra_codes = inv[len(strs):].astype(np.int64) if extra is not None else None
    return codes, vocab, extra_codes


# largest static ROWS window lowered via the on-device sparse table; wider
# sliding frames stay on host (memory: log2(w) extra lanes of length P;
# frame_width comes from kernels/window.py, beside that table)
MAX_DEVICE_FRAME_W = 1 << 16


def _canon_key_items(d: np.ndarray, v: np.ndarray, desc: bool):
    """One key lane → [(codes, rng)] of non-negative order codes with NULL
    placement (first asc / last desc, the host _lex_argsort contract) and
    direction folded in, ready for radix packing. Wide-span lanes that
    cannot shift return two items: a 2-range NULL word and a full-range
    canonical int64 word (rng None = standalone)."""
    if d.dtype == np.float64:
        # order-preserving bitcast (sign-flip trick); -0.0 folds into +0.0
        b = np.where(d == 0.0, 0.0, d).view(np.int64)
        key = np.where(b < 0, ~b, b ^ np.int64(-0x8000000000000000))
    elif d.dtype == np.uint64:
        key = (d ^ np.uint64(0x8000000000000000)).view(np.int64)
    else:
        key = d.astype(np.int64)
    vals = key[v]
    if len(vals) == 0:
        return [(np.where(v, 1, 0 if not desc else 2).astype(np.int64), 3)]
    mn, mx = int(vals.min()), int(vals.max())
    span = mx - mn
    if span < (1 << 61):
        if desc:
            shifted = (mx - key) + 1
        else:
            shifted = (key - mn) + 1
        codes = np.where(v, shifted, 0 if not desc else span + 2)
        return [(codes.astype(np.int64), span + 3)]
    # full-range lane: separate NULL word + canonical value word
    nullw = np.where(v, 1, 0 if not desc else 2).astype(np.int64)
    vw = np.where(v, ~key if desc else key, 0)  # ~ reverses int64 order
    return [(nullw, 3), (vw, None)]


def _pack_words(items, n: int, P: int):
    """Radix-pack [(codes, rng)] (most significant first) into as few
    device sort words as possible; pad rows [n:P] get a sentinel ABOVE
    every real code so they sort last and form their own partition.
    Words whose packed range fits int32 ship narrow."""
    words: list[np.ndarray] = []
    cur, cur_rng = None, 1

    def flush():
        nonlocal cur, cur_rng
        if cur is None:
            return
        pad_val = cur_rng
        w = np.full(P, pad_val, dtype=np.int64)
        w[:n] = cur
        words.append(w.astype(np.int32) if cur_rng < (1 << 31) - 1 else w)
        cur, cur_rng = None, 1

    for codes, rng in items:
        if rng is None:  # standalone full-range word
            flush()
            w = np.full(P, np.iinfo(np.int64).max, dtype=np.int64)
            w[:n] = codes
            words.append(w)
            continue
        if cur is not None and cur_rng <= (1 << 61) // rng:
            cur = cur * rng + codes
            cur_rng *= rng
        else:
            flush()
            cur, cur_rng = codes.copy(), rng
    flush()
    return words


def _avg_dec_finish(s: np.ndarray, cnt: np.ndarray, arg_scale: int, out_scale: int):
    """Exact AVG(decimal) from int64 (sum, count): replicates
    Dec.div(Dec(cnt,0)).rescale(out_scale) — including the double rounding
    (round-half-away at scale+DIV_FRAC_INCR, then again at out_scale)."""
    sdiv = min(arg_scale + DIV_FRAC_INCR, MAX_SCALE)
    p1 = pow10(sdiv - arg_scale)
    valid = cnt > 0
    c = np.maximum(cnt, 1)
    amax = int(np.abs(s).max()) if s.size else 0
    if amax > (1 << 62) // max(p1, 1):
        # int64 headroom exhausted — exact big-int per row
        qs = np.zeros_like(s)
        for i in range(len(s)):
            if valid[i]:
                q = Dec(int(s[i]), arg_scale).div(Dec(int(cnt[i]), 0))
                qs[i] = q.rescale(out_scale).value if q is not None else 0
        return qs, valid
    num = np.abs(s) * p1
    q = num // c
    q += (num - q * c) * 2 >= c
    if sdiv > out_scale:
        p2 = pow10(sdiv - out_scale)
        q2 = q // p2
        q2 += (q - q2 * p2) * 2 >= p2
        q = q2
    elif out_scale > sdiv:
        q = q * pow10(out_scale - sdiv)
    return np.where(s < 0, -q, q).astype(np.int64), valid


# Prepared device inputs (packed sort words + padded arg lanes, all
# resident on the card) keyed by (provenance, n, bucket, device), where
# provenance = (table id, batch version, batch uid, window-spec digest)
# from the caller. A repeated window over an unchanged batch skips lane
# eval, dict-encoding, packing AND the upload. Byte-budgeted LRU (hits
# re-insert; eviction pops the least recently used). Entries pin device
# memory — the budget bounds that too.
_INPUT_CACHE: dict = {}
_INPUT_CACHE_BYTES = [0]
INPUT_CACHE_BUDGET = 2 << 30


def _input_cache_put(key, value, nbytes: int):
    while _INPUT_CACHE and _INPUT_CACHE_BYTES[0] + nbytes > INPUT_CACHE_BUDGET:
        k = next(iter(_INPUT_CACHE))
        _, old_n = _INPUT_CACHE.pop(k)
        _INPUT_CACHE_BYTES[0] -= old_n
    _INPUT_CACHE[key] = (value, nbytes)
    _INPUT_CACHE_BYTES[0] += nbytes


def _cache_key(provenance, n: int, device: torch.device):
    return (provenance, n, _bucket(n), str(device))


def run_cached_window(provenance, n: int, device="cuda", phase=None):
    """Replay a fully-prepared window (device inputs + post metadata) for
    a stable provenance, or None on miss. Lets the caller skip lane
    evaluation and dict-encoding entirely on repeat executions."""
    dev = resolve_device(device)
    key = _cache_key(provenance, n, dev)
    cached = _INPUT_CACHE.get(key)
    if cached is None:
        return None
    _INPUT_CACHE[key] = _INPUT_CACHE.pop(key)  # LRU: hits refresh recency
    words, fargs, pwords_n, owords_n, fspecs_meta, range_dev = cached[0]
    return _run_prepared(words, fargs, pwords_n, owords_n, fspecs_meta, n, range_dev, phase)


def _to_device(a: np.ndarray, device: torch.device):
    """A padded numpy lane on `device`: uint64 as xp_torch.U64 (int64 bit
    patterns), floats as float64, bools as bool, other ints as int64."""
    if a.dtype == np.uint64:
        return U64(torch.from_numpy(a.view(np.int64)).to(device))
    if a.dtype == np.bool_:
        return torch.from_numpy(a).to(device)
    if a.dtype.kind == "f":
        return torch.from_numpy(a.astype(np.float64, copy=False)).to(device)
    return torch.from_numpy(a.astype(np.int64, copy=False)).to(device)


def _nbytes(x) -> int:
    t = x.bits if isinstance(x, U64) else x
    return t.numel() * t.element_size()


def run_device_window(part_lanes, order_lanes, fspecs, n: int, device="cuda", provenance=None,
                      range_lane=None, phase=None):
    """Execute a window spec on `device`; returns [(data, valid), ...] per
    func in input row order (numpy, length n).

    part_lanes: [(d, v)] int64/float64/uint64 (pre-encoded strings)
    order_lanes: [((d, v), desc)]
    fspecs: per func dict — {name, static, args: [(d, v), ...], post, frame}
      post: ('decode', vocab) | ('avg_dec', arg_scale, out_scale) | None
    provenance: stable (table, version, batch, spec-digest) identity from
      the caller, or None — enables the prepared-device-input cache.
    range_lane: (d, v, gmin, gmax) of the single ORDER BY key when a RANGE
      offset frame is present, else None.
    phase: optional PhaseTimer.phase hook for the prep / h2d / sort /
      window / pack / d2h / finalize spans.
    """
    dev = resolve_device(device)
    phase = phase or (lambda name: nullcontext())
    cache_key = _cache_key(provenance, n, dev) if provenance is not None else None
    cached = _INPUT_CACHE.get(cache_key) if cache_key is not None else None
    if cached is not None:
        _INPUT_CACHE[cache_key] = _INPUT_CACHE.pop(cache_key)  # LRU touch
        words, fargs, pwords_n, owords_n, fspecs_meta, range_dev = cached[0]
        return _run_prepared(words, fargs, pwords_n, owords_n, fspecs_meta, n, range_dev, phase)

    words, fargs, n_pwords, n_owords, range_dev = prepare(part_lanes, order_lanes, fspecs, n, dev,
                                                           range_lane, phase)
    if cache_key is not None:
        lanes = {id(t): t for fa in fargs for pair in fa for t in pair}  # a shared lane once
        nbytes = sum(_nbytes(w) for w in words) + sum(_nbytes(t) for t in lanes.values()) + (
            _nbytes(range_dev[0]) + _nbytes(range_dev[1]) if range_dev is not None else 0)
        fspecs_meta = [{k: v for k, v in f.items() if k != "args"} for f in fspecs]
        _input_cache_put(
            cache_key,
            (words, fargs, n_pwords, n_owords, fspecs_meta, range_dev), nbytes,
        )
    return _run_prepared(words, fargs, n_pwords, n_owords, fspecs, n, range_dev, phase)


def prepare(part_lanes, order_lanes, fspecs, n: int, device, range_lane=None, phase=None):
    """W1's inputs on `device`: → (words, fargs, n_pwords, n_owords,
    range_dev). The host half ("prep"): canonical key codes packed into
    sort words, argument lanes padded to P = _bucket(n) rows; then the
    upload ("h2d")."""
    dev = resolve_device(device)
    phase = phase or (lambda name: nullcontext())
    P = _bucket(n)

    def pad(d, v):
        dd = np.zeros(P, dtype=d.dtype)
        vv = np.zeros(P, dtype=bool)
        dd[:n], vv[:n] = d, v
        return dd, vv

    with phase("prep"):
        part_items = []
        for d, v in part_lanes:
            part_items += _canon_key_items(np.asarray(d), np.asarray(v), False)
        if not part_items:
            # no PARTITION BY: one trivial word still separates the pad block
            part_items = [(np.zeros(n, dtype=np.int64), 1)]
        order_items = []
        for (d, v), desc in order_lanes:
            order_items += _canon_key_items(np.asarray(d), np.asarray(v), bool(desc))
        pwords = _pack_words(part_items, n, P)
        owords = _pack_words(order_items, n, P)
        host_args = [[(d, v) for d, v in f["args"]] for f in fspecs]
        host_range = None
        if range_lane is not None:
            d0, v0, gmin, gmax = range_lane
            host_range = pad(np.asarray(d0), np.asarray(v0)) + (int(gmin), int(gmax))
    with phase("h2d"):
        words = tuple(torch.from_numpy(w).to(dev) for w in pwords + owords)
        # a lane that several functions take (LAG(x) and MAX(x) OVER ...) is
        # padded, uploaded and gathered by W1 once
        lanes: dict = {}

        def lane(d, v):
            key = (id(d), id(v))
            if key not in lanes:
                pd, pv = pad(np.asarray(d), np.asarray(v))
                lanes[key] = (_to_device(pd, dev), _to_device(pv, dev))
            return lanes[key]

        fargs = tuple(tuple(lane(d, v) for d, v in fa) for fa in host_args)
        range_dev = None
        if host_range is not None:
            range_dev = (_to_device(host_range[0], dev), _to_device(host_range[1], dev)) + host_range[2:]
    return words, fargs, len(pwords), len(owords), range_dev


def _run_prepared(words, fargs, n_pwords: int, n_owords: int, fspecs, n: int,
                  range_dev=None, phase=None):
    phase = phase or (lambda name: nullcontext())
    funcspecs = tuple(f["static"] for f in fspecs)
    framespecs = tuple(f.get("frame") for f in fspecs)
    outs = window(list(words), fargs, (n_pwords, n_owords, funcspecs, framespecs), range_dev, phase=phase)
    with phase("pack"):
        packed = pack_flat(outs)
    with phase("d2h"):
        host = packed.cpu().numpy()
    with phase("finalize"):
        flat = unpack_flat(host)
        return _post(flat, fspecs, n)


def _post(flat, fspecs, n: int):
    """The host post-steps of the reference's _run_prepared (:574-601)."""
    outs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(fspecs))]
    results = []
    for f, (a, b) in zip(fspecs, outs):
        a = np.asarray(a)[:n]
        b = np.asarray(b)[:n]
        post = f.get("post")
        if post is None:
            results.append((a, b.astype(bool)))
        elif post[0] == "decode":
            vocab = post[1]
            v = b.astype(bool)
            code = np.clip(a, 0, max(len(vocab) - 1, 0))
            data = np.empty(n, dtype=object)
            data[:] = vocab[code] if len(vocab) else ""
            results.append((data, v))
        elif post[0] == "cume_dist":  # a=frame rows, b=psize (>=1)
            results.append((a / np.maximum(b, 1), np.ones(n, dtype=bool)))
        elif post[0] == "percent_rank":  # a=rank-1, b=psize-1
            data = np.where(b > 0, a / np.maximum(b, 1), 0.0)
            results.append((data, np.ones(n, dtype=bool)))
        elif post[0] == "avg_f":  # a=frame_sum(f64), b=frame_cnt
            cnt = b.astype(np.int64)
            data = np.where(cnt > 0, a / np.maximum(cnt, 1), 0.0)
            results.append((data, cnt > 0))
        else:  # avg_dec: a=frame_sum, b=frame_cnt (int64)
            _, arg_scale, out_scale = post
            qs, valid = _avg_dec_finish(a, b.astype(np.int64), arg_scale, out_scale)
            results.append((qs, valid))
    return results
