"""W2: pack the output lanes of a window program into one int64 buffer.

Replaces tidb_tpu/jaxenv.py:104-138 pack_flat. The buffer is
[n, kind0, len0, ... | seg0 | seg1 | ...]: float64 lanes bit-cast,
float32 first widened to float64, uint64 lanes (xp_torch.U64) bit-cast,
bool lanes bit-packed 64 rows to a word (bit j of word w is row 64·w + j),
other ints cast to int64. One device-to-host copy fetches it and
`torchenv.unpack_flat` takes it apart on the host.

The CUDA kernel is csrc/pack_flat.cu (the host writes the static header,
one launch writes every segment); `pack_flat_ref` is the plain PyTorch
version beside it. `pack_flat` takes the plain version only for tensors
on the CPU. On a CUDA device it launches the kernel or raises;
`pack_flat.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..expr.xp_torch import U64
from ..torchenv import _KIND_BOOL, _KIND_F64, _KIND_I64, _KIND_U64
from .build import count, library
from .tables import sm_count

# source kinds of csrc/pack_flat.cu's segment table
_S_B64, _S_I32, _S_F32, _S_BOOL = 0, 1, 2, 3
_SRC = {torch.int64: (_S_B64, _KIND_I64), torch.float64: (_S_B64, _KIND_F64),
        torch.int32: (_S_I32, _KIND_I64), torch.float32: (_S_F32, _KIND_F64),
        torch.bool: (_S_BOOL, _KIND_BOOL)}


def _lanes(outs) -> list[tuple[torch.Tensor, int, int]]:
    """[(tensor, source kind, pack kind)] for each output lane."""
    lanes = []
    for o in outs:
        if isinstance(o, U64):
            t, src, kind = o.bits, _S_B64, _KIND_U64
        else:
            if o.dtype not in _SRC:
                raise TypeError(f"pack_flat: no pack kind for {o.dtype}")
            t, (src, kind) = o, _SRC[o.dtype]
        if t.dim() != 1:
            raise ValueError(f"pack_flat: lanes are 1-d, got {tuple(t.shape)}")
        lanes.append((t, src, kind))
    return lanes


def _header(lanes) -> tuple[list[int], list[int]]:
    """(header words, segment lengths in words)."""
    header, seg_words = [len(lanes)], []
    for t, _, kind in lanes:
        L = t.shape[0]
        header += [kind, L]
        seg_words.append(-(-L // 64) if kind == _KIND_BOOL else L)
    return header, seg_words


def pack_flat_ref(outs) -> torch.Tensor:
    """Plain PyTorch version: the same layout, segment by segment."""
    lanes = _lanes(outs)
    header, _ = _header(lanes)
    dev = lanes[0][0].device if lanes else torch.device("cpu")
    parts = [torch.tensor(header, dtype=torch.int64, device=dev)]
    for t, src, kind in lanes:
        if src == _S_BOOL:
            L = t.shape[0]
            W = -(-L // 64)
            padded = torch.zeros(W * 64, dtype=torch.int64, device=dev)
            padded[:L] = t.to(torch.int64)
            shifts = torch.arange(64, dtype=torch.int64, device=dev)
            # the bits are disjoint, so the int64 sum is their OR
            parts.append((padded.reshape(W, 64) << shifts).sum(dim=1))
        elif src == _S_F32:
            parts.append(t.to(torch.float64).view(torch.int64))
        elif t.dtype == torch.float64:
            parts.append(t.view(torch.int64))
        else:
            parts.append(t.to(torch.int64))
    return torch.cat(parts)


_bound: set = set()


def _lib():
    lib = library("pack_flat")
    if "pack_flat" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_pack_flat.argtypes = [C, I, L, C, I, C]
        lib.tt_pack_flat.restype = I
        _bound.add("pack_flat")
    return lib


def pack_flat(outs) -> torch.Tensor:
    """One int64 buffer holding every lane of `outs` (module doc)."""
    lanes = _lanes(outs)
    if not lanes:
        raise ValueError("pack_flat: no lanes")
    dev = lanes[0][0].device
    if dev.type == "cpu":
        return pack_flat_ref(outs)
    if dev.type != "cuda":
        raise ValueError(f"pack_flat: unsupported device {dev}")
    for t, _, _ in lanes:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"pack_flat: lanes must be contiguous tensors on {dev}")
    if len(lanes) > 65535:
        raise ValueError("pack_flat: more than 65535 lanes")
    header, seg_words = _header(lanes)
    out = torch.empty(len(header) + sum(seg_words), dtype=torch.int64, device=dev)
    out[: len(header)].copy_(torch.tensor(header, dtype=torch.int64))
    table, off, most = [], len(header), 0
    for (t, src, _), w in zip(lanes, seg_words):
        table.append([t.data_ptr(), src, t.shape[0], off])
        off += w
        most = max(most, 32 * w if src == _S_BOOL else w)
    segs = torch.tensor(table, dtype=torch.int64).to(dev)
    rc = _lib().tt_pack_flat(segs.data_ptr(), len(table), most, out.data_ptr(), sm_count(dev),
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack_flat: kernel launch failed (cudaError {rc})")
    count(pack_flat)
    return out


pack_flat.launches = 0
