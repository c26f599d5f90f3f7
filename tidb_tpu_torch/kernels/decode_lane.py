"""K1: expand uploaded lanes to their dense [T, R] form — every coded lane
of a call in one launch.

Replaces tidb_tpu/copr/tpu_engine.py:1169 TPUEngine._decode_lane. The
CUDA kernel is csrc/decode_lane.cu (its note gives the codecs, the work
split and what bounds it); `decode_lane_ref` is the plain PyTorch version
beside it.

A lane on the device is what the reference uploads:

  * a dense tensor [T, R]                      — returned as it is
  * {}                                         — the all-valid alias: row_valid
  * {"p": codes [T, R], "b": base}             — pack
  * {"c": codes [T, R], "v": vocab [V]}        — dict
  * {"rv": run values [V], "rl": run lengths}  — rle

Codes are uint8, or uint16/uint32 carried as int16/int32 bit views (the
kernel reads them unsigned); uint64 values travel as int64 bit patterns.
`b` is a 0-d CPU tensor: a scalar parameter of the launch, never a
device read. An rle lane's inclusive run ends are computed on its first
decode on the card and kept in the lane as "re" (`run_ends`), so a
resident lane pays that cumsum once.

  decode_lanes(encs, row_valid)  every lane of `encs` against one
                                 row_valid: the coded ones in ONE launch
  decode_lane(enc, row_valid)    one lane: decode_lanes of one
  launch(ents, dev)              the launch itself over entries
                                 (codec, codes or run values, vocab or run
                                 ends, their count, pack base, output,
                                 rows) — the task mode's too
                                 (kernels/grouped.decode_lanes_tasks)

The wrappers take the plain version only for a lane on the CPU. On a CUDA
device they launch the kernel or raise; `decode_lane.launches` counts the
launches of the solo mode (whichever wrapper made them).
"""

from __future__ import annotations

import ctypes

import torch

from .build import count, library
from .tables import host_words, sm_count, staging, stream_scratch

PACK, DICT, RLE = 0, 1, 2  # codecs (csrc/decode_lane.cu)
WORDS = 7  # int64 words an entry: codec | code bytes << 8 | value bytes << 16, src, aux, naux, base, out, rows
_bound: dict = {}  # "decode_lane" → (entries that travel by value, bytes an entry) of the built kernel


def _codes_i64(codes: torch.Tensor) -> torch.Tensor:
    """Unsigned code values as int64 (undoing the signed bit views)."""
    w = codes.element_size()
    x = codes.to(torch.int64)
    return x if codes.dtype == torch.uint8 else x & ((1 << (8 * w)) - 1)


def decode_lane_ref(enc, row_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch decode: the same function as the CUDA kernel."""
    if isinstance(enc, torch.Tensor):
        return enc
    if not enc:
        return row_valid
    if "p" in enc:
        base = enc["b"].to(row_valid.device)
        return _codes_i64(enc["p"]).to(base.dtype) + base
    if "c" in enc:
        vocab = enc["v"]
        return vocab[_codes_i64(enc["c"]).clamp(max=vocab.shape[0] - 1)]
    vals, lens = enc["rv"], enc["rl"]
    ends = torch.cumsum(lens.to(torch.int64), 0)
    rows = torch.arange(row_valid.numel(), dtype=torch.int64, device=vals.device)
    idx = torch.searchsorted(ends, rows, right=True).clamp(max=vals.shape[0] - 1)
    return vals[idx].reshape(row_valid.shape)


def _lib():
    lib = library("decode_lane")
    if "decode_lane" not in _bound:
        lib.tt_decode_lanes.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.tt_decode_lanes.restype = ctypes.c_int
        lib.tt_decode_max_by_value.restype = ctypes.c_int
        lib.tt_decode_ent_bytes.restype = ctypes.c_int
        _bound["decode_lane"] = (lib.tt_decode_max_by_value(), lib.tt_decode_ent_bytes())
    return lib


def run_ends(enc: dict) -> torch.Tensor:
    """An rle lane's inclusive run ends (int64), computed once and kept in
    the lane (enc["re"])."""
    ends = enc.get("re")
    if ends is None:
        ends = enc["re"] = torch.cumsum(enc["rl"].to(torch.int64), 0)
    return ends


def codec(enc) -> str:
    if isinstance(enc, torch.Tensor):
        return "dense"
    if not enc:
        return "alias"
    return "pack" if "p" in enc else "dict" if "c" in enc else "rle"


def out_dtype(enc) -> torch.dtype:
    """The dtype a coded lane decodes to."""
    if "p" in enc:
        dtype = enc["b"].dtype
        if dtype not in (torch.int32, torch.int64):
            raise TypeError(f"decode_lane: pack base must be int32/int64, got {dtype}")
        return dtype
    return (enc["v"] if "c" in enc else enc["rv"]).dtype


def entry(enc, out: int, out_bytes: int, rows: int, dev: torch.device) -> list:
    """The kernel's words for one coded lane decoded into its first `rows`
    rows at address `out` (elements of `out_bytes` bytes), checked as the
    kernel reads it."""
    if "p" in enc:
        codes = enc["p"]
        _need(codes, "pack codes", dev, rows)
        return [PACK | codes.element_size() << 8 | out_bytes << 16, codes.data_ptr(), 0, 0, int(enc["b"]), out, rows]
    if "c" in enc:
        codes, vocab = enc["c"], enc["v"]
        _need(codes, "dict codes", dev, rows)
        _need(vocab, "dict vocab", dev, 1)
        return [DICT | codes.element_size() << 8 | out_bytes << 16, codes.data_ptr(), vocab.data_ptr(),
                vocab.shape[0], 0, out, rows]
    vals = enc["rv"]
    _need(vals, "rle values", dev, 1)
    ends = run_ends(enc)
    return [RLE | 1 << 8 | out_bytes << 16, vals.data_ptr(), ends.data_ptr(), vals.shape[0], 0, out, rows]


def launch(words: list, ne: int, dev: torch.device) -> None:
    """One launch of the kernel over `ne` entries (their WORDS words each,
    concatenated), on the current stream: by value, or past the by-value
    tiers from one pinned table copied up."""
    if ne == 0:
        return
    lib = _lib()
    addr = host_words(words)
    stream = torch.cuda.current_stream(dev).cuda_stream
    by_value, ent_bytes = _bound["decode_lane"]
    if ne <= by_value:
        rc = lib.tt_decode_lanes(addr, ne, None, None, sm_count(dev), stream)
    else:
        nw = -(-ne * ent_bytes // 8)
        with staging("decode_lane", dev, nw) as st, stream_scratch("decode_lane", dev, nw) as table:
            rc = lib.tt_decode_lanes(addr, ne, st.pin.data_ptr(), table.data_ptr(), sm_count(dev), stream)
            st.record(dev)  # the kernel library's copy reads the pinned table
    if rc != 0:
        raise RuntimeError(f"decode_lane: kernel launch failed (cudaError {rc})")


def _need(t: torch.Tensor, name: str, device, rows: int) -> None:
    if t.device != device:
        raise ValueError(f"decode_lane: {name} on {t.device}, row_valid on {device}")
    if not t.is_contiguous():
        raise ValueError(f"decode_lane: {name} must be contiguous")
    if t.numel() < rows:
        raise ValueError(f"decode_lane: {name} has {t.numel()} rows, {rows} are read")


def decode_lanes(encs: list, row_valid: torch.Tensor) -> list:
    """The dense [T, R] lane of every uploaded lane of `encs` (module doc):
    dense lanes and the alias without a launch, the coded ones in one."""
    dev = row_valid.device
    if dev.type == "cpu":
        return [decode_lane_ref(e, row_valid) for e in encs]
    if dev.type != "cuda":
        raise ValueError(f"decode_lane: unsupported device {dev}")
    out, words, ne, n = [], [], 0, row_valid.numel()
    for enc in encs:
        if isinstance(enc, torch.Tensor):
            out.append(enc)
        elif not enc:  # all-valid alias: the mask IS row_valid, no launch
            out.append(row_valid)
        else:
            o = torch.empty(row_valid.shape, dtype=out_dtype(enc), device=dev)
            words += entry(enc, o.data_ptr(), o.element_size(), n, dev)
            ne += 1
            out.append(o)
    if ne:
        launch(words, ne, dev)
        count(decode_lane)
    return out


def decode_lane(enc, row_valid: torch.Tensor) -> torch.Tensor:
    """Dense [T, R] lane of one uploaded column lane (see module doc)."""
    return decode_lanes([enc], row_valid)[0]


decode_lane.launches = 0
