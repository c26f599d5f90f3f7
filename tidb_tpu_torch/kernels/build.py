"""Build of the port's CUDA kernels, at first use.

Every `csrc/*.cu` has a plain C interface (no PyTorch headers), so each is
compiled by `nvcc` into its own shared library and loaded with ctypes: a
source builds in seconds, where one that includes PyTorch's extension
headers takes minutes. All sources compile in parallel, one `nvcc` each,
for `sm_90a` (Hopper) at -O3, into `build/kernels/` at the repository root
(git-ignored). A library is named after the content hash of its source
and of the shared headers (`csrc/*.cuh`), so an edited source or header
rebuilds and an unchanged one is loaded as it is.

A build failure raises with the compiler's output: no wrapper ever falls
back to its plain version on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
last_build: dict = {}  # seconds and ptxas report of the last build in this process


def count(wrapper, attr: str = "launches") -> None:
    """wrapper.<attr> += 1 under one lock (a mesh's ranks launch from
    threads at once)."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def nvcc_path() -> str:
    """The CUDA compiler: CUDA_HOME/bin/nvcc as torch finds it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("tidb_tpu_torch kernels: nvcc not found (CUDA_HOME unset, not on PATH)")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; → {stem: CDLL}."""
    with _lock:
        if _libs:
            return _libs
        srcs = sorted(CSRC.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in srcs:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = {}
        failed = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            report[src.name] = log
            (BUILD_DIR / f"{src.stem}.log").write_text(log)
            if p.returncode != 0:
                failed.append(f"{src.name} (exit {p.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("tidb_tpu_torch kernel build failed: " + "\n".join(failed))
        for src in srcs:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        last_build.update(seconds=time.perf_counter() - t0, compiled=sorted(report), ptxas=report)
        return _libs


def library(stem: str) -> ctypes.CDLL:
    return build_all()[stem]
