"""Kernel dispatch: one policy layer between the model code and the kernels.

The port's counterpart of ``repro/runtime/dispatch.py``.  Model code calls
shape-only entry points (``lowrank_apply``, ``dense_apply``,
``flash_attention``, ``decode_attention``, ``paged_decode_attention``,
``sketch_matmul``, ``logits_apply``, ``ssd_scan``); the backend is chosen
here, in one place:

* ``backend="auto"`` (the default): on a CUDA tensor the hand-written
  kernel, always — the reference's TPU-only thresholds (``DECODE_MIN_SEQ``
  and the 14 MiB VMEM fit test) are not carried over, so no shape quietly
  runs the plain version on the card.  On a CPU tensor the plain PyTorch
  version (``repro_torch.kernels.ref``).
* ``backend="reference"``: the plain version everywhere.  Only chosen
  explicitly (tests, ``chip_smoke.py``'s comparison phase).

    from repro_torch.runtime.dispatch import use_dispatch

    with use_dispatch(backend="reference"):
        logits, cache = model.prefill(params, batch, max_len)

PyTorch runs eagerly, so the hit counters count CALLS per (op, path, shape)
— the reference's count traced call sites.  A call made while a CUDA graph
is being captured (inside :func:`recording_capture`) is recorded for that
graph instead, and whoever replays the graph adds its calls once per replay
(:func:`add_replays`), so the counts stay calls that ran.
``format_counters`` prints them the way the JAX launcher does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import aligned_rows
from repro_torch.kernels.decode_attention import decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.lowrank_matmul import lowrank_matmul as _lowrank_kernel
from repro_torch.kernels.lowrank_matmul_batched import lowrank_matmul_batched as _lowrank_batched_kernel
from repro_torch.kernels.paged_decode_attention import paged_decode_attention as _paged_decode_kernel
from repro_torch.kernels.sketch_matmul import sketch_matmul as _sketch_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

__all__ = [
    "BACKENDS",
    "PATH_TWO_GEMM",
    "PATH_FUSED",
    "PATH_FUSED_BATCHED",
    "DispatchConfig",
    "active_dispatch",
    "use_dispatch",
    "choose_lowrank_path",
    "lowrank_apply",
    "dense_apply",
    "sketch_matmul",
    "logits_apply",
    "flash_attention",
    "decode_attention",
    "choose_paged_decode_path",
    "paged_decode_attention",
    "ssd_scan",
    "counters",
    "counters_by_path",
    "reset_counters",
    "format_counters",
    "recording_capture",
    "add_replays",
]

BACKENDS = ("auto", "reference")

# low-rank execution paths (what the auto table chooses between)
PATH_TWO_GEMM = "two_gemm"  # the plain (x @ A) @ B
PATH_FUSED = "fused"  # the lowrank_matmul CUDA kernel
PATH_FUSED_BATCHED = "fused_batched"  # the lowrank_matmul_batched CUDA kernel (stacked factors)
PATH_KERNEL = "kernel"  # the other ops' CUDA kernels
PATH_REFERENCE = "reference"  # the other ops' plain versions


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """backend: "auto" (kernels on the card) or "reference" (plain versions)."""

    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")

    @classmethod
    def from_arch(cls, cfg, **kw) -> "DispatchConfig":
        return cls(backend=getattr(cfg, "kernels", "auto"), **kw)

    def replace(self, **kw) -> "DispatchConfig":
        return dataclasses.replace(self, **kw)


_state = threading.local()
_DEFAULT = DispatchConfig()


def active_dispatch() -> DispatchConfig:
    return getattr(_state, "dispatch", None) or _DEFAULT


@contextlib.contextmanager
def use_dispatch(config: Optional[DispatchConfig] = None, **kw):
    """Install a DispatchConfig for the dynamic extent (this thread only)."""
    if config is None:
        config = DispatchConfig(**kw)
    elif kw:
        config = config.replace(**kw)
    prev = getattr(_state, "dispatch", None)
    _state.dispatch = config
    try:
        yield config
    finally:
        _state.dispatch = prev


# --------------------------------------------------------------------------- #
# hit counters: (op, path, shape-signature) -> calls
# --------------------------------------------------------------------------- #
_COUNTS: Counter = Counter()  # guarded by: _COUNTS_LOCK
_COUNTS_LOCK = threading.Lock()


def _record(op: str, path: str, sig: tuple):
    capture = getattr(_state, "capture", None)
    if capture is not None:  # recorded into a CUDA graph, not run
        capture[(op, path, sig)] += 1
        return
    with _COUNTS_LOCK:
        _COUNTS[(op, path, sig)] += 1


@contextlib.contextmanager
def recording_capture():
    """Collect the calls made in this extent (this thread) into the yielded
    Counter instead of the hit counters: the extent captures a CUDA graph,
    whose calls run only when it is replayed."""
    prev = getattr(_state, "capture", None)
    _state.capture = Counter()
    try:
        yield _state.capture
    finally:
        _state.capture = prev


def add_replays(calls: Counter, n: int = 1):
    """Count ``n`` replays of a graph whose capture recorded ``calls``."""
    with _COUNTS_LOCK:
        for key, c in calls.items():
            _COUNTS[key] += c * n


def counters() -> dict:
    """{(op, path, shape_sig): calls}."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def counters_by_path() -> dict:
    """{(op, path): calls} aggregated over shapes."""
    agg: Counter = Counter()
    for (op, path, _sig), n in counters().items():
        agg[(op, path)] += n
    return dict(agg)


def reset_counters():
    with _COUNTS_LOCK:
        _COUNTS.clear()


def format_counters() -> str:
    rows = sorted(counters().items(), key=lambda kv: (kv[0][0], kv[0][1], str(kv[0][2])))
    if not rows:
        return "(no dispatched ops recorded)"
    return "\n".join(f"{op:16s} {path:14s} {str(sig):32s} x{n}" for (op, path, sig), n in rows)


# --------------------------------------------------------------------------- #
# selection
# --------------------------------------------------------------------------- #
def _use_kernel(device: torch.device, config: DispatchConfig) -> bool:
    return config.backend == "auto" and device.type == "cuda"


def _lowrank_dims(x_shape, a_shape, b_shape):
    """(n_stack_dims, L, M, K, r, N) for a possibly-stacked factored apply
    (``repro/runtime/dispatch.py::_lowrank_dims``): A (L..., K, r),
    B (L..., r, N) and x (L..., M..., K); the leading stack dims flatten to
    one L and x's remaining leading dims to one M."""
    nl = len(a_shape) - 2
    if len(b_shape) != len(a_shape):
        raise ValueError(f"A/B rank mismatch: A {tuple(a_shape)}, B {tuple(b_shape)}")
    if nl and (tuple(a_shape[:nl]) != tuple(b_shape[:nl]) or tuple(x_shape[:nl]) != tuple(a_shape[:nl])):
        raise ValueError(f"stacked lowrank apply: leading dims disagree "
                         f"(x {tuple(x_shape)}, A {tuple(a_shape)}, B {tuple(b_shape)})")
    if x_shape[-1] != a_shape[-2] or b_shape[-2] != a_shape[-1]:
        raise ValueError(f"lowrank apply: x {tuple(x_shape)}, A {tuple(a_shape)}, B {tuple(b_shape)}")
    L = math.prod(a_shape[:nl]) if nl else 1
    M = math.prod(x_shape[nl:-1]) if len(x_shape) - nl > 1 else 1
    return nl, L, M, a_shape[-2], a_shape[-1], b_shape[-1]


def choose_lowrank_path(
    x_shape,
    a_shape,
    b_shape,
    *,
    device_type: str,
    config: Optional[DispatchConfig] = None,
) -> str:
    """The auto table: on ``cuda`` under ``auto`` the fused kernel (the
    batched one for stacked factors), for every rank; otherwise
    (``reference``, or the CPU) the plain two-GEMM form.  The reference's
    dense-rematerialization path is not carried over: no rank that
    ``compress_tree`` emits reaches break-even.  Nor is its VMEM fit test:
    at phi3.5-moe's expert ranks (``fused_vmem_bytes(1229, 6400, bf16)``,
    ~28 MB > 14 MiB) the reference falls back to two GEMMs, the port runs
    its kernel."""
    config = config or active_dispatch()
    nl = _lowrank_dims(x_shape, a_shape, b_shape)[0]
    if config.backend == "auto" and device_type == "cuda":
        return PATH_FUSED_BATCHED if nl else PATH_FUSED
    return PATH_TWO_GEMM


# --------------------------------------------------------------------------- #
# execution entry points
# --------------------------------------------------------------------------- #
def dense_apply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ W with fp32 accumulation, in x's dtype.

    The reference leaves dense products to XLA, and the port leaves them to
    ``torch.matmul``: on the card a bf16 GEMM accumulates in fp32; on the
    CPU the operands are upcast first so that holds there too.
    """
    _record("dense", "torch", (x.shape[-1], w.shape[-1]))
    if x.device.type == "cuda":
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def lowrank_apply(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """y = (x @ A) @ B via whichever path the dispatch table selects.

    2-D factors: x (..., K), A (K, r), B (r, N); leading x dims flatten.
    Stacked factors: A (L..., K, r), B (L..., r, N) with x (L..., M..., K)
    (the expert-stacked case).  Every path canonicalizes the stacked case
    to (L, M, K) @ (L, K, r) @ (L, r, N) first, as the reference does; the
    reshapes are views of row-padded factor leaves, never copies.
    """
    config = active_dispatch()
    path = choose_lowrank_path(x.shape, A.shape, B.shape, device_type=x.device.type, config=config)
    nl, L, M, K, r, N = _lowrank_dims(x.shape, A.shape, B.shape)
    _record("lowrank_matmul", path, (L, M, K, r, N))
    out_shape = x.shape[:-1] + (N,)
    if nl:
        xc, Ac, Bc = x.reshape(L, M, K), A.reshape(L, K, r), B.reshape(L, r, N)
        if path == PATH_FUSED_BATCHED:
            y = _lowrank_batched_kernel(xc, Ac, Bc)
        else:
            y = _ref.lowrank_matmul_ref(xc, Ac, Bc)
        return y.reshape(out_shape)
    x2 = x.reshape(M, K)
    if path == PATH_FUSED:
        y = _lowrank_kernel(x2, A, B)
    else:
        y = _ref.lowrank_matmul_ref(x2, A, B)
    return y.reshape(out_shape)


def sketch_matmul(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """op(a) @ b with fp32 accumulation — RSI's sketch GEMMs."""
    config = active_dispatch()
    if _use_kernel(a.device, config):
        _record("sketch_matmul", PATH_KERNEL, (tuple(a.shape), tuple(b.shape), trans_a))
        return _sketch_kernel(a, b, trans_a=trans_a, out_dtype=out_dtype)
    _record("sketch_matmul", PATH_REFERENCE, (tuple(a.shape), tuple(b.shape), trans_a))
    return _ref.sketch_matmul_ref(a, b, trans_a=trans_a, out_dtype=out_dtype)


def logits_apply(x: torch.Tensor, table: torch.Tensor, *, tied: bool = True) -> torch.Tensor:
    """fp32 logits with fp32 accumulation and no rounding: ``x @ table.T``
    against the tied (V, d) embedding table, or ``x @ table`` against an
    untied dense (d, V) head (``tied=False``; the reference's
    ``jnp.matmul(x, head, preferred_element_type=f32)``).

    On the card this is the sketch GEMM with an fp32 output; both forms are
    computed transposed, ``table @ x.T`` or ``head.T @ x.T`` with the head
    read in place (the table streams once through the GEMM's tall side; x
    is the skinny operand, not 8 rows of a 256-row tile) — a bf16 GEMM
    rounded to bf16 and then upcast could flip greedy argmaxes, and
    upcasting the table each step would move 1 GB.
    """
    config = active_dispatch()
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    V = table.shape[0] if tied else table.shape[1]
    sig = (x2.shape[0], d, V)
    kernel = _use_kernel(x.device, config)
    _record("logits", PATH_KERNEL if kernel else PATH_REFERENCE, sig)
    gemm = _sketch_kernel if kernel else _ref.sketch_matmul_ref
    if tied:
        out = gemm(table, aligned_rows(x2.T) if kernel else x2.T, out_dtype=torch.float32).T
    elif kernel:
        out = gemm(table, aligned_rows(x2.T), trans_a=True, out_dtype=torch.float32).T
    else:
        out = gemm(x2, table, out_dtype=torch.float32)
    return out.reshape(x.shape[:-1] + (V,))


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0):
    """Prefill attention: q (B,Sq,H,hd), k/v (B,Skv,KV,hd), GQA by grouping."""
    config = active_dispatch()
    sig = (tuple(q.shape), k.shape[2], causal, window)
    if _use_kernel(q.device, config):
        _record("flash_attention", PATH_KERNEL, sig)
        return _flash_kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
    _record("flash_attention", PATH_REFERENCE, sig)
    return _ref.chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid):
    """One-token GQA attention over a cache (the serving decode hot path).

    q: (B, 1, H, hd); k_cache: (B, S, KV, hd); v_cache: (B, S, KV, vd);
    valid: (B, S) bool strict per-slot mask.  Fully-masked rows give zeros.
    """
    config = active_dispatch()
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    sig = (B, S, KV, H // KV, hd)
    if _use_kernel(q.device, config):
        _record("decode_attention", PATH_KERNEL, sig)
        return _decode_kernel(q, k_cache, v_cache, valid)
    _record("decode_attention", PATH_REFERENCE, sig)
    return _ref.decode_attention_ref(q, k_cache, v_cache, valid)


def choose_paged_decode_path(*, device_type: str, config: Optional[DispatchConfig] = None) -> str:
    """The auto table of block-table decode attention: on ``cuda`` under
    ``auto`` the kernel, for every depth (the reference's TPU-only
    ``DECODE_MIN_SEQ`` threshold is not carried over); otherwise the plain
    gather-then-attend version."""
    config = config or active_dispatch()
    if config.backend == "auto" and device_type == "cuda":
        return PATH_KERNEL
    return PATH_REFERENCE


def paged_decode_attention(q, k_pool, v_pool, block_table, n_valid):
    """One-token GQA attention through a paged KV pool (continuous batching).

    q: (B, 1, H, hd); pools: (P, page, KV, hd/vd) physical pages shared by
    every slot; block_table: (B, n_tbl) int32 page ids; n_valid: (B,) int32
    valid logical positions.  Fully-masked rows give zeros on both paths.
    """
    path = choose_paged_decode_path(device_type=q.device.type)
    B, _, H, hd = q.shape
    P, page, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    n_tbl = block_table.shape[1]
    _record("paged_decode_attention", path, (B, P, page, n_tbl, KV, H // KV, hd))
    if path == PATH_KERNEL:
        return _paged_decode_kernel(q, k_pool, v_pool, block_table, n_valid)
    return _ref.paged_decode_attention_ref(q, k_pool, v_pool, block_table, n_valid)


def ssd_scan(x, dt, B_in, C_in, A, *, chunk: int, round_xbar: bool):
    """Mamba2 SSD chunked scan of a prefill: x (B, L, nh, hd) raw, dt
    (B, L, nh) fp32 after softplus, B_in/C_in (B, L, s), A (nh,) fp32.
    Returns (y in x's dtype, final_state (B, nh, hd, s) fp32).

    Two ways to form x̄ = x * dt.  ``round_xbar`` (what ``mamba2_forward``
    passes) rounds it to x's dtype before the scan, as the
    reference model does (``repro/models/ssm.py:148``) and as its XLA
    dispatch path does (``repro/runtime/dispatch.py:384``).  Without it x̄
    stays fp32, the TPU kernel's contract (``repro/kernels/ssd_scan.py:47``).
    They agree in fp32 and differ in bf16.  On ``cuda`` under ``auto`` the
    kernel (its own fixed chunk, tail padded); otherwise the plain chunked
    version with the reference's chunk rule for ``chunk``."""
    config = active_dispatch()
    Bsz, L, nh, hd = x.shape
    sig = (Bsz, L, nh, hd, B_in.shape[-1])
    if _use_kernel(x.device, config):
        _record("ssd_scan", PATH_KERNEL, sig)
        return _ssd_kernel(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)
    _record("ssd_scan", PATH_REFERENCE, sig)
    return _ref.ssd_scan_plain(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)
