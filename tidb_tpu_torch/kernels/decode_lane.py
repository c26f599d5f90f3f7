"""K1: expand an uploaded lane to its dense [T, R] form.

Replaces tidb_tpu/copr/tpu_engine.py:1169 TPUEngine._decode_lane. The
CUDA kernel is csrc/decode_lane.cu (its note gives the codecs and what
bounds it); `decode_lane_ref` is the plain PyTorch version beside it.

A lane on the device is what the reference uploads:

  * a dense tensor [T, R]                      — returned as it is
  * {}                                         — the all-valid alias: row_valid
  * {"p": codes [T, R], "b": base}             — pack
  * {"c": codes [T, R], "v": vocab [V]}        — dict
  * {"rv": run values [V], "rl": run lengths}  — rle

Codes are uint8, or uint16/uint32 carried as int16/int32 bit views (the
kernel reads them unsigned); uint64 values travel as int64 bit patterns.
`b` is a 0-d CPU tensor: a scalar parameter of the launch, never a
device read.

`decode_lane` takes the plain version only for a lane on the CPU. On a
CUDA device it launches the kernel or raises; `decode_lane.launches`
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import count, library

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_bound: set = set()


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
        lib.tt_decode_pack.argtypes = [_C, _I, _L, _I, _C, _L, _C]
        lib.tt_decode_dict.argtypes = [_C, _I, _C, _L, _I, _C, _L, _C]
        lib.tt_decode_rle.argtypes = [_C, _I, _C, _L, _C, _L, _C]
        for f in (lib.tt_decode_pack, lib.tt_decode_dict, lib.tt_decode_rle):
            f.restype = _I
        _bound.add("decode_lane")
    return lib


def _need(t: torch.Tensor, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"decode_lane: {name} on {t.device}, row_valid on {device}")
    if not t.is_contiguous():
        raise ValueError(f"decode_lane: {name} must be contiguous")


def decode_lane(enc, row_valid: torch.Tensor) -> torch.Tensor:
    """Dense [T, R] lane of one uploaded column lane (see module doc)."""
    if isinstance(enc, torch.Tensor):
        return enc
    if not enc:  # all-valid alias: the mask IS row_valid, no launch
        return row_valid
    dev = row_valid.device
    if dev.type == "cpu":
        return decode_lane_ref(enc, row_valid)
    if dev.type != "cuda":
        raise ValueError(f"decode_lane: unsupported device {dev}")
    lib = _lib()
    n = row_valid.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if "p" in enc:
        codes, base = enc["p"], enc["b"]
        _need(codes, "pack codes", dev)
        if base.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"decode_lane: pack base must be int32/int64, got {base.dtype}")
        out = torch.empty(row_valid.shape, dtype=base.dtype, device=dev)
        rc = lib.tt_decode_pack(codes.data_ptr(), codes.element_size(), int(base.item()),
                                out.element_size(), out.data_ptr(), n, stream)
    elif "c" in enc:
        codes, vocab = enc["c"], enc["v"]
        _need(codes, "dict codes", dev)
        _need(vocab, "dict vocab", dev)
        out = torch.empty(row_valid.shape, dtype=vocab.dtype, device=dev)
        rc = lib.tt_decode_dict(codes.data_ptr(), codes.element_size(), vocab.data_ptr(),
                                vocab.shape[0], vocab.element_size(), out.data_ptr(), n, stream)
    else:
        vals, lens = enc["rv"], enc["rl"]
        _need(vals, "rle values", dev)
        ends = torch.cumsum(lens.to(torch.int64), 0)  # inclusive run ends (glue)
        out = torch.empty(row_valid.shape, dtype=vals.dtype, device=dev)
        rc = lib.tt_decode_rle(vals.data_ptr(), vals.element_size(), ends.data_ptr(),
                               vals.shape[0], out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"decode_lane: kernel launch failed (cudaError {rc})")
    count(decode_lane)
    return out


decode_lane.launches = 0
