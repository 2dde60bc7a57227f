"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface under ``corrosion_tpu_torch/_build/``
(gitignored), at first use, and loaded with ``ctypes``.  `build_all`
starts one ``nvcc`` per source at once and waits for all of them.  The
library name carries a hash of the source and of every ``csrc`` header
it includes (``#include "x.cuh"``, followed through headers), so an
edited source or header never loads a stale build.

`Kernel` is one C entry point: it checks the launch's return code (a
``cudaError_t``; a refused launch raises here, it never runs silently)
and counts launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = (
    "sample_targets.cu", "broadcast_scatter.cu", "sync_pull.cu",
    "merge_entries.cu", "threefry.cu", "gaps_refresh.cu",
    "converge_fold.cu", "word_phases.cu", "fault_edges.cu",
    "node_faults.cu", "dense_phases.cu", "dense_sync.cu", "dense_gaps.cu",
    "swim_full.cu", "budget_words.cu", "trace_counts.cu", "trace_wire.cu",
    "trace_row.cu", "edge_classes.cu", "peerswap.cu", "order_check.cu",
    "membership_detect.cu",
)
_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def local_includes(source: str, csrc: Path = CSRC) -> list:
    """The ``csrc`` files ``source`` includes by quoted name, directly or
    through another of them, sorted."""
    found, todo = set(), [source]
    while todo:
        for name in _LOCAL_INCLUDE.findall((csrc / todo.pop()).read_text()):
            if name not in found:
                found.add(name)
                todo.append(name)
    return sorted(found)


def _lib_path(source: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for name in (source, *local_includes(source, csrc)):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Sequence[str] = SOURCES, verbose: bool = False):
    """Compile every missing library in parallel (one nvcc per source)
    and load them all; raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for src in sources:
        if src in _LOADED:
            continue
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / src)]
        pending[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    failed = []
    for src, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
        if verbose and log:
            print(f"[nvcc {src}]\n{log}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for src in sources:
        if src not in _LOADED:
            _LOADED[src] = ctypes.CDLL(str(_lib_path(src)))


class Kernel:
    """One C launcher of a ``csrc`` source, bound through ctypes."""

    def __init__(self, name: str, source: str, symbol: str, n_ints: int):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.n_ints = n_ints
        self.launches = 0

    def launch(self, pointers: Sequence[Optional[torch.Tensor]],
               ints: Sequence[int]):
        """Call the launcher on ``pointers`` (CUDA tensors in order; None
        passes a null pointer), then ``ints``, then the current stream;
        count the launch."""
        if len(ints) != self.n_ints:
            raise ValueError(f"{self.name}: expected {self.n_ints} ints")
        if self.source not in _LOADED:
            build_all()
        fn = getattr(_LOADED[self.source], self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * len(pointers)
            + [ctypes.c_int] * len(ints)
            + [ctypes.c_void_p]
        )
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if p is None else p.data_ptr() for p in pointers),
                 *ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError_t {err}"
            )
        self.launches += 1


def check(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Wrapper-side argument check before a pointer reaches C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
