"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared object with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  A kernel is built the first
time its wrapper is called on a CUDA tensor, into ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``); the file name carries a
hash of the sources and flags, so an edited source is rebuilt.
:func:`build_all` starts one ``nvcc`` per source at once.

Also holds the checks every wrapper shares: device, dtype, layout, and the
CUDA error code each C entry point returns; the SM count the launch plans
take; and the copies into aligned rows that the TMA kernels' wrappers make
(:func:`tma_ready`, counted in :data:`ALIGN_COPIES`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import functools
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = [
    "KERNELS",
    "BUILD_DIR",
    "KernelLib",
    "kernel_libs",
    "CSRC",
    "nvcc_path",
    "library",
    "build_all",
    "check_launch",
    "stream_ptr",
    "padded_rows",
    "padded_stack",
    "aligned_rows",
    "row_stride",
    "stack_strides",
    "check_vector_layout",
    "sm_count",
    "ALIGN_COPIES",
    "tma_ready",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("lowrank_matmul", "sketch_matmul", "decode_attention", "flash_attention", "paged_decode_attention",
           "lowrank_matmul_batched", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded by: _LOCK
_REGISTRY: list = []  # guarded by: _LOCK -- every KernelLib, in creation order


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _so_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # every .cu and .cuh the build may include
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built."""
    so = _so_path(name)
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = open(so.with_suffix(".log"), "w")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return so, (proc, tmp, log)


def _finish(name: str, so: Path, job) -> None:
    if job is None:
        return
    proc, tmp, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {rc}):\n{so.with_suffix('.log').read_text()[-4000:]}"
        )
    os.replace(tmp, so)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Build every named kernel library, one nvcc each, all at once."""
    names = list(names)
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, (so, job) in jobs.items():
            _finish(n, so, job)
    return {n: so for n, (so, _) in jobs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared object for kernel ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so, job = _start(name)
            _finish(name, so, job)
            lib = ctypes.CDLL(str(so))
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} (error {code})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class KernelLib:
    """One kernel library: its C entry points and its count of launches.

    ``entries`` maps each C entry point to its argument types (``P`` for a
    pointer or the stream, ``I`` for an int, ``F`` for a float).  Every
    launching entry takes the stream last and returns a CUDA error code.
    The count goes up by one for each successful call of :meth:`launch` and
    nowhere else, so a run can show that it went through the kernel.

    A call made while the current stream is capturing a CUDA graph only
    records the launch into the graph, so it counts in :attr:`captured`
    instead; whoever replays the graph adds the launches each replay makes
    (:meth:`replayed`).
    """

    def __init__(self, name: str, entries: Dict[str, list]):
        self.name = name
        self._entries = entries
        self._lock = threading.Lock()
        self._launches = 0  # guarded by: _lock
        self._captured = 0  # guarded by: _lock
        self._fns = None  # guarded by: _lock
        with _LOCK:
            _REGISTRY.append(self)

    def _bound(self):
        """(library, {entry: ctypes function}) with signatures set, resolved once."""
        with self._lock:
            if self._fns is None:
                lib = library(self.name)
                fns = {"repro_set_device": lib.repro_set_device}
                fns["repro_set_device"].argtypes, fns["repro_set_device"].restype = [I], ctypes.c_int
                for entry, argtypes in self._entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                    fns[entry] = fn
                self._fns = (lib, fns)
            return self._fns

    def launch(self, entry: str, device: torch.device, *args) -> None:
        lib, fns = self._bound()
        check_launch(lib, "repro_set_device", fns["repro_set_device"](device.index or 0))
        check_launch(lib, entry, fns[entry](*args, stream_ptr(device)))
        capturing = torch.cuda.is_current_stream_capturing()
        with self._lock:
            if capturing:
                self._captured += 1
            else:
                self._launches += 1

    @property
    def launches(self) -> int:
        with self._lock:
            return self._launches

    @property
    def captured(self) -> int:
        """Launches recorded into CUDA graphs (not yet run by themselves)."""
        with self._lock:
            return self._captured

    def replayed(self, n: int) -> None:
        """Count ``n`` launches made by replaying a captured graph."""
        with self._lock:
            self._launches += n

    def reset(self) -> None:
        with self._lock:
            self._launches = 0


def kernel_libs() -> list:
    """Every :class:`KernelLib` created so far (one per kernel wrapper module)."""
    with _LOCK:
        return list(_REGISTRY)


def row_stride(t: torch.Tensor, what: str) -> int:
    """Row stride of a 2-D operand whose rows are contiguous (the kernels take
    any row stride >= the row length, so row-strided views pass uncopied).
    The stride of a size-1 dim is never used and is not checked."""
    if t.dim() != 2:
        raise ValueError(f"{what}: need a 2-D tensor, got shape {tuple(t.shape)}")
    rows, cols = t.shape
    s0 = t.stride(0) if rows > 1 else cols
    s1 = t.stride(1) if cols > 1 else 1
    if s1 != 1 or s0 < cols:
        raise ValueError(f"{what}: need contiguous rows, got shape {tuple(t.shape)} strides {t.stride()}")
    return s0


def stack_strides(t: torch.Tensor, what: str) -> tuple:
    """(row stride, stack stride) of a 3-D (L, rows, cols) operand whose
    rows are contiguous and whose L matrices do not overlap: any row stride
    >= cols and stack stride >= rows * row stride passes uncopied (one
    layer's slice of a stacked, row-padded factor leaf, for one).  The
    stride of a size-1 dim is never used and is not checked."""
    if t.dim() != 3:
        raise ValueError(f"{what}: need a 3-D tensor, got shape {tuple(t.shape)}")
    L, rows, cols = t.shape
    ld = row_stride(t[0], what) if L else cols
    s = t.stride(0) if L > 1 else rows * ld
    if s < rows * ld:
        raise ValueError(f"{what}: stacked matrices overlap, shape {tuple(t.shape)} strides {t.stride()}")
    return ld, s


def check_vector_layout(what: str, *ts: torch.Tensor) -> None:
    """The attention kernels read their tiles in 16-byte vectors: each
    operand must start 16-byte aligned with a last dim of whole vectors."""
    for t in ts:
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} ({t.dtype}) must start 16-byte "
                             f"aligned with a last dim of a multiple of 16 bytes")


def padded_rows(rows: int, cols: int, dtype, device) -> torch.Tensor:
    """Uninitialized (rows, cols) tensor whose row stride is a multiple of 8
    elements (16 bytes for bf16), so the GEMM tiles load it in 16-byte
    vectors when it is read back as an operand."""
    ld = -(-cols // 8) * 8
    return torch.empty((rows, ld), dtype=dtype, device=device)[:, :cols]


def padded_stack(L: int, rows: int, cols: int, dtype, device) -> torch.Tensor:
    """Uninitialized (L, rows, cols) tensor, each matrix stored as by
    :func:`padded_rows` (row stride a multiple of 8 elements), back to back."""
    ld = -(-cols // 8) * 8
    return torch.empty((L, rows, ld), dtype=dtype, device=device)[..., :cols]


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dim is contiguous with a row stride that is a
    multiple of 8 elements, else a copy in such storage (a view of the same
    shape and values).  Works on stacked (L, rows, cols) tensors too, whose
    per-layer slices then stay aligned."""
    if t.dim() >= 2 and t.stride(-1) == 1 and t.stride(-2) % 8 == 0 and t.stride(-2) >= t.shape[-1] \
            and all(t.stride(i) == t.shape[i + 1] * t.stride(i + 1) for i in range(t.dim() - 2)):
        return t
    cols = t.shape[-1]
    ld = -(-cols // 8) * 8
    out = torch.empty(t.shape[:-1] + (ld,), dtype=t.dtype, device=t.device)[..., :cols]
    out.copy_(t)
    return out


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launch plans' input)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


class _CopyCount:
    """Operands a wrapper copied into 16-byte aligned rows before a launch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded by: _lock

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


# every operand the TMA kernels' wrappers (sketch_matmul, lowrank_matmul,
# lowrank_matmul_batched) copied because TMA could not read it in place
ALIGN_COPIES = _CopyCount()


def tma_ready(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` itself when TMA can read it in place (16-byte aligned base, row
    stride and, for a 3-D stack, stack stride: multiples of 8 elements), else
    a counted copy in such storage (:func:`aligned_rows`)."""
    if t.dim() == 3:
        ld, st = stack_strides(t, what)
        ok = ld % 8 == 0 and st % 8 == 0
    else:
        ok = row_stride(t, what) % 8 == 0
    if t.data_ptr() % 16 == 0 and ok:
        return t
    ALIGN_COPIES.add()
    out = aligned_rows(t)
    if out is t:  # aligned strides on a misaligned base: a fresh allocation is aligned
        out = aligned_rows(t.clone())
    return out
