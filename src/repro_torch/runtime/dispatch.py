"""Kernel dispatch: one policy layer between the model code and the kernels.

The port's counterpart of ``repro/runtime/dispatch.py``.  Model code calls
shape-only entry points (``lowrank_apply``, ``dense_apply``,
``flash_attention``, ``decode_attention``, ``paged_decode_attention``,
``sketch_matmul``, ``logits_apply``, ``ssd_scan``, and the absorbed MLA
path's products ``mla_product`` / ``mla_materialize``); the backend is
chosen here, in one place:

* ``backend="auto"`` (the default): on a CUDA tensor the hand-written
  kernel, always — the reference's TPU-only thresholds (``DECODE_MIN_SEQ``
  and the 14 MiB VMEM fit test) are not carried over, so no shape quietly
  runs the plain version on the card.  On a CPU tensor the plain PyTorch
  version (``repro_torch.kernels.ref``).
* ``backend="reference"``: the plain version everywhere.  Only chosen
  explicitly (tests, ``chip_smoke.py``'s comparison phase).

Prompt rows (:func:`prefill_rows`, entered by the model's prefill and chunk
programs) reach the low-rank kernel with ``prefill=True``: its batch-
invariant plan, so a row's bits do not depend on which rows share its call
(``kernels/lowrank_matmul.py``).

    from repro_torch.runtime.dispatch import use_dispatch

    with use_dispatch(backend="reference"):
        logits, cache = model.prefill(params, batch, max_len)

Gradients.  Under grad mode, an op whose operand requires grad runs through
its ``torch.autograd.Function`` (:class:`LowrankFn`, :class:`FlashFn`,
:class:`LogitsFn`, :class:`SsdScanFn`): on a CUDA tensor its forward is the
hand-written kernel, on a CPU tensor the plain version, and its backward is
the same plain-PyTorch code on both (``kernels/ref.py``'s twins of the
reference's XLA backward passes; the reference has no Pallas backward), so
the CPU tests run the backward the card runs.  Backend ``reference`` takes
no Function: autograd runs through the plain version itself.  The kernels
with no backward (the two decode kernels, the sketch GEMM outside the
logits, and the absorbed MLA products, all off the training path) raise
under grad (:func:`check_no_backward`) rather than return a tensor cut off
from the graph or fall back to the plain version.

PyTorch runs eagerly, so the hit counters count CALLS per (op, path, shape)
— the reference's count traced call sites.  A call made while a CUDA graph
is being captured (inside :func:`recording_capture`) is recorded for that
graph instead, and whoever replays the graph adds its calls once per replay
(:func:`add_replays`), so the counts stay calls that ran.
``format_counters`` prints them the way the JAX launcher does, and
:func:`kernel_calls` sums the kernels' calls by op.

The dry world (``roofline/dry.py::dry_world``: every tensor a fake) is the
card to this module: every tensor there takes the card's branch, and each
kernel call is recorded with its cost (``roofline/kernel_cost.py``) and
computed by the kernel's plain version, which the op counter does not
count; no kernel library is built or loaded there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
from repro_torch.roofline import dry, kernel_cost

__all__ = [
    "BACKENDS",
    "PATH_TWO_GEMM",
    "PATH_FUSED",
    "PATH_FUSED_BATCHED",
    "DispatchConfig",
    "active_dispatch",
    "use_dispatch",
    "bound_to_dispatch",
    "prefill_rows",
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
    "MLA_OP",
    "mla_product",
    "mla_materialize",
    "counters",
    "counters_by_path",
    "kernel_calls",
    "reset_counters",
    "format_counters",
    "recording_capture",
    "add_replays",
    "check_no_backward",
    "LowrankFn",
    "FlashFn",
    "LogitsFn",
    "SsdScanFn",
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


def bound_to_dispatch(fn):
    """``fn`` run under the DispatchConfig active now, whichever thread calls
    it later.  Activation checkpointing re-runs a forward inside the
    backward, which autograd runs on its own thread for CUDA tensors, where
    this thread's config is not installed: the recomputation must take the
    forward's paths (its saved tensors are checked against them)."""
    config = active_dispatch()

    def run(*args, **kw):
        with use_dispatch(config):
            return fn(*args, **kw)

    return run


@contextlib.contextmanager
def prefill_rows():
    """Mark the calls of this extent (this thread) as prompt rows: the model's
    prefill and chunk programs.  The low-rank kernel then computes every row
    the same way at every M (no skinny kernel, a K split fixed by K and N),
    so a prompt's bits do not depend on which prompts share its micro-batch.
    Usable as a decorator."""
    prev = getattr(_state, "prefill", False)
    _state.prefill = True
    try:
        yield
    finally:
        _state.prefill = prev


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


# the paths on which an op launches a hand-written kernel
_KERNEL_PATHS = (PATH_FUSED, PATH_FUSED_BATCHED, PATH_KERNEL)


def kernel_calls() -> dict:
    """{op: kernel calls} of the hit counters, by the dispatch's op names,
    the stacked low-rank apply as ``lowrank_matmul_batched`` (its own
    kernel)."""
    agg: Counter = Counter()
    for (op, path, _sig), n in counters().items():
        if path in _KERNEL_PATHS:
            agg["lowrank_matmul_batched" if path == PATH_FUSED_BATCHED else op] += n
    return dict(sorted(agg.items()))


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
def _on_card(device_type: str) -> bool:
    """Whether a tensor on ``device_type`` takes the card's branch: it lies
    on the card, or in the dry world."""
    return device_type == "cuda" or dry.active()


def _use_kernel(device: torch.device, config: DispatchConfig) -> bool:
    return config.backend == "auto" and _on_card(device.type)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _via_function(config: DispatchConfig, *ts) -> bool:
    """Whether an op with a backward runs through its autograd Function: under
    ``auto``, with grad mode on and an operand that requires grad."""
    return config.backend == "auto" and _needs_grad(*ts)


def check_no_backward(op: str, *ts, device_type: str, config: Optional[DispatchConfig] = None) -> None:
    """Raise where ``op``, which has no backward, would run its kernel on
    ``device_type`` (``cuda`` under ``auto``) while grad mode is on and an
    operand requires grad: the kernel's output would carry no gradient."""
    config = config or active_dispatch()
    if config.backend == "auto" and _on_card(device_type) and _needs_grad(*ts):
        raise RuntimeError(f"{op}: its kernel has no backward, and an operand requires grad; "
                           "run it under torch.no_grad() (it is off the training path)")


# --------------------------------------------------------------------------- #
# the kernels' calls: the wrapper, or in the dry world the recorded cost and the plain version
# --------------------------------------------------------------------------- #
def _lowrank_launch(x, A, B, *, prefill: bool, return_xa: bool = False):
    if dry.active():
        (M, K), (r, N) = x.shape, B.shape
        return dry.kernel("lowrank_matmul", kernel_cost.lowrank_matmul(M, K, r, N, x.element_size()),
                          lambda: _ref.lowrank_matmul_ref(x, A, B, return_xa=return_xa))
    return _lowrank_kernel(x, A, B, prefill=prefill, return_xa=return_xa)


def _batched_launch(x, A, B, *, return_xa: bool = False):
    """The dry world counts every row of every expert live: the routing is data."""
    if dry.active():
        (L, M, K), (r, N) = x.shape, B.shape[-2:]
        return dry.kernel("lowrank_matmul_batched",
                          kernel_cost.lowrank_matmul_batched(L, M, K, r, N, x.element_size()),
                          lambda: _ref.lowrank_matmul_ref(x, A, B, return_xa=return_xa))
    return _lowrank_batched_kernel(x, A, B, return_xa=return_xa)


def _sketch_launch(a, b, *, trans_a: bool = False, out_dtype: Optional[torch.dtype] = None,
                   op: str = "sketch_matmul"):
    if dry.active():
        (C, D), ell = a.shape, b.shape[1]
        out_size = (out_dtype or a.dtype).itemsize
        return dry.kernel(op, kernel_cost.sketch_matmul(C, D, ell, a.element_size(), trans_a=trans_a,
                                                                out_itemsize=out_size),
                          lambda: _ref.sketch_matmul_ref(a, b, trans_a=trans_a, out_dtype=out_dtype))
    return _sketch_kernel(a, b, trans_a=trans_a, out_dtype=out_dtype)


def _flash_launch(q, k, v, *, causal: bool, window: Optional[int], q_offset: int, return_lse: bool = False):
    if dry.active():
        (B, Sq, H, hd), (Skv, KV), vd = q.shape, k.shape[1:3], v.shape[-1]
        return dry.kernel("flash_attention",
                          kernel_cost.flash_attention(B, Sq, Skv, H, KV, hd, q.element_size(), causal=causal,
                                                              window=window, q_offset=q_offset, vd=vd),
                          lambda: _ref.chunked_attention_ref(q, k, v, causal=causal, window=window,
                                                             q_offset=q_offset, return_lse=return_lse))
    return _flash_kernel(q, k, v, causal=causal, window=window, q_offset=q_offset, return_lse=return_lse)


def _ssd_launch(x, dt, B_in, C_in, A, *, chunk: int, round_xbar: bool):
    if dry.active():
        (Bsz, L, nh, hd), s = x.shape, B_in.shape[-1]
        return dry.kernel("ssd_scan", kernel_cost.ssd_scan(Bsz, L, nh, hd, s, x.element_size()),
                          lambda: _ref.ssd_scan_plain(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar))
    return _ssd_kernel(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)


# --------------------------------------------------------------------------- #
# autograd Functions: the kernel (CUDA) or plain (CPU) forward, a plain backward
# --------------------------------------------------------------------------- #
class LowrankFn(torch.autograd.Function):
    """y = (x @ A) @ B, 2-D or stacked (L, ...).  Saves x, A, B and the
    forward's rounded ``x @ A``; the backward is
    ``ref.lowrank_matmul_bwd_ref``."""

    @staticmethod
    def forward(ctx, x, A, B, stacked: bool, prefill: bool):
        if stacked:
            y, xa = _batched_launch(x, A, B, return_xa=True)
        else:
            y, xa = _lowrank_launch(x, A, B, prefill=prefill, return_xa=True)
        ctx.save_for_backward(x, A, B, xa)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, A, B, xa = ctx.saved_tensors
        return (*_ref.lowrank_matmul_bwd_ref(x, A, B, xa, dy), None, None)


class FlashFn(torch.autograd.Function):
    """Prefill attention.  The forward also writes each row's fp32 lse, which
    the backward (``ref.flash_bwd_ref``, the twin of ``_flash_bwd``) reads to
    recompute the probabilities chunk by chunk."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], q_offset: int):
        out, lse = _flash_launch(q, k, v, causal=causal, window=window, q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, q_offset = ctx.mask
        dq, dk, dv = _ref.flash_bwd_ref(*ctx.saved_tensors, dout, causal=causal, window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None


class LogitsFn(torch.autograd.Function):
    """fp32 logits of rows x2 (M, d) against the tied table (V, d) or an
    untied head (d, V) (:func:`logits_apply`'s forward); the backward is
    ``ref.logits_bwd_ref``, which upcasts the bf16 table a block of vocab
    rows at a time."""

    @staticmethod
    def forward(ctx, x2, table, tied: bool, kernel: bool, op: str = "logits"):
        ctx.save_for_backward(x2, table)
        ctx.tied = tied
        return _logits_forward(x2, table, tied, kernel, op)

    @staticmethod
    def backward(ctx, dlogits):
        x2, table = ctx.saved_tensors
        return (*_ref.logits_bwd_ref(x2, table, dlogits, tied=ctx.tied), None, None, None)


class SsdScanFn(torch.autograd.Function):
    """Mamba2's SSD scan; returns (y, final state).  The backward re-runs the
    plain ``ref.ssd_scan_plain`` on the saved inputs under grad and
    backpropagates through it.  On the card the forward is the kernel, whose
    own 64-step chunk differs from the plain version's chunk rule in
    summation order only, so the gradient is that of the same function,
    summed in the plain version's order."""

    @staticmethod
    def forward(ctx, x, dt, B_in, C_in, A, chunk: int, round_xbar: bool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, B_in, C_in, A)
        ctx.scan = (chunk, round_xbar)
        return _ssd_launch(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)

    @staticmethod
    def backward(ctx, dy, dstate):
        chunk, round_xbar = ctx.scan
        ins = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, state = _ref.ssd_scan_plain(*ins, chunk=chunk, round_xbar=round_xbar)
        pairs = [(o, g) for o, g in ((y, dy), (state, dstate)) if g is not None]
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True)
                     if pairs and wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in ins), None, None)


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
    rank floor (``fused_min_rank``, 2) is not carried over: the kernel runs
    rank 1, which a rank tier (``core.lowrank.slice_rank``) can reach.  Nor
    is its dense-rematerialization path: no rank that ``compress_tree``
    emits reaches break-even.  Nor is its VMEM fit test:
    at phi3.5-moe's expert ranks (``fused_vmem_bytes(1229, 6400, bf16)``,
    ~28 MB > 14 MiB) the reference falls back to two GEMMs, the port runs
    its kernel."""
    config = config or active_dispatch()
    nl = _lowrank_dims(x_shape, a_shape, b_shape)[0]
    if config.backend == "auto" and _on_card(device_type):
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
    if _on_card(x.device.type):
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
    prefill = getattr(_state, "prefill", False)
    if nl:
        xc, Ac, Bc = x.reshape(L, M, K), A.reshape(L, K, r), B.reshape(L, r, N)
        if _via_function(config, xc, Ac, Bc):
            y = LowrankFn.apply(xc, Ac, Bc, True, prefill)
        elif path == PATH_FUSED_BATCHED:
            y = _batched_launch(xc, Ac, Bc)
        else:
            y = _ref.lowrank_matmul_ref(xc, Ac, Bc)
        return y.reshape(out_shape)
    x2 = x.reshape(M, K)
    if _via_function(config, x2, A, B):
        y = LowrankFn.apply(x2, A, B, False, prefill)
    elif path == PATH_FUSED:
        y = _lowrank_launch(x2, A, B, prefill=prefill)
    else:
        y = _ref.lowrank_matmul_ref(x2, A, B)
    return y.reshape(out_shape)


def sketch_matmul(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """op(a) @ b with fp32 accumulation — RSI's sketch GEMMs (no backward:
    RSI runs without grad)."""
    config = active_dispatch()
    check_no_backward("sketch_matmul", a, b, device_type=a.device.type, config=config)
    if _use_kernel(a.device, config):
        _record("sketch_matmul", PATH_KERNEL, (tuple(a.shape), tuple(b.shape), trans_a))
        return _sketch_launch(a, b, trans_a=trans_a, out_dtype=out_dtype)
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
    if _via_function(config, x2, table):
        out = LogitsFn.apply(x2, table, tied, kernel)
    else:
        out = _logits_forward(x2, table, tied, kernel)
    return out.reshape(x.shape[:-1] + (V,))


def _logits_forward(x2: torch.Tensor, table: torch.Tensor, tied: bool, kernel: bool,
                    op: str = "logits") -> torch.Tensor:
    """(M, V) fp32 logits of the rows x2 (M, d): the sketch kernel or its plain version."""
    gemm = functools.partial(_sketch_launch, op=op) if kernel else _ref.sketch_matmul_ref
    if tied:
        return gemm(table, aligned_rows(x2.T) if kernel else x2.T, out_dtype=torch.float32).T
    if kernel:
        return gemm(table, aligned_rows(x2.T), trans_a=True, out_dtype=torch.float32).T
    return gemm(x2, table, out_dtype=torch.float32)


FACTOR_OP = "lowrank_factor"  # the op name the split products of a row-parallel factored linear count under


def factor_apply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``x @ w`` for ONE factor of a row-parallel factored linear
    (``core/lowrank.py::apply_linear``), whose sum over "model" sits between
    its two products: on the card the sketch GEMM with an fp32 output, ``w``
    read in place as an untied head is (:func:`logits_apply`'s form, its
    autograd Function and plain backward); the plain version elsewhere."""
    config = active_dispatch()
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    kernel = _use_kernel(x.device, config)
    _record(FACTOR_OP, PATH_KERNEL if kernel else PATH_REFERENCE, (x2.shape[0], d, w.shape[-1]))
    if _via_function(config, x2, w):
        out = LogitsFn.apply(x2, w, False, kernel, "sketch_matmul")
    else:
        out = _logits_forward(x2, w, False, kernel, "sketch_matmul")
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0):
    """Prefill attention: q (B,Sq,H,hd), k (B,Skv,KV,hd), v (B,Skv,KV,vd) ->
    (B,Sq,H,vd), GQA by grouping; the scale is hd**-0.5 (MLA: vd != hd)."""
    config = active_dispatch()
    sig = (tuple(q.shape), k.shape[2], causal, window) + ((v.shape[-1],) if v.shape[-1] != q.shape[-1] else ())
    if _via_function(config, q, k, v):
        _record("flash_attention", PATH_KERNEL if _use_kernel(q.device, config) else PATH_REFERENCE, sig)
        return FlashFn.apply(q, k, v, causal, window, q_offset)
    if _use_kernel(q.device, config):
        _record("flash_attention", PATH_KERNEL, sig)
        return _flash_launch(q, k, v, causal=causal, window=window, q_offset=q_offset)
    _record("flash_attention", PATH_REFERENCE, sig)
    return _ref.chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


# --------------------------------------------------------------------------- #
# the absorbed MLA path (decode and chunk prefill): torch ops, as the
# reference leaves them to XLA outside any Pallas kernel
# --------------------------------------------------------------------------- #
MLA_OP = "mla_absorbed"  # the op name these products are counted under


def mla_product(eq: str, a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum(eq, a, b)`` with fp32 accumulation, the result in ``out_dtype``
    (the reference's ``preferred_element_type=f32`` then ``astype``).

    On the card a product whose operands and result share a 16-bit dtype is
    one bf16 batched GEMM (fp32 accumulation, rounded once); any other runs
    on fp32 copies of the operands.  Counted as ``(MLA_OP, "torch", ...)``,
    so the "no linear outside the kernels" gate names these products.  The
    absorbed path serves decode and chunks only: on the card it raises under
    grad (:func:`check_no_backward`)."""
    check_no_backward(MLA_OP, a, b, device_type=a.device.type)
    _record(MLA_OP, "torch", (eq, tuple(a.shape), tuple(b.shape)))
    if _on_card(a.device.type) and a.dtype == b.dtype == out_dtype:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(out_dtype)


def mla_materialize(w) -> torch.Tensor:
    """The dense ``wkv_b`` of the absorbed path: a factored leaf is
    materialized on every call (``core.lowrank.materialize``, fp32 product
    rounded to the factors' dtype), as the reference does, so a rank tier's
    sliced factors take effect; a dense leaf passes through uncounted."""
    from repro_torch.core import lowrank

    if not lowrank.is_lowrank(w):
        return w
    check_no_backward(MLA_OP, w["a"], w["b"], device_type=w["a"].device.type)
    _record(MLA_OP, "torch", ("materialize", tuple(w["a"].shape), tuple(w["b"].shape)))
    return lowrank.materialize(w)


def decode_attention(q, k_cache, v_cache, valid, *, return_lse: bool = False):
    """One-token GQA attention over a cache (the serving decode hot path).

    q: (B, 1, H, hd); k_cache: (B, S, KV, hd); v_cache: (B, S, KV, vd);
    valid: (B, S) bool strict per-slot mask.  Fully-masked rows give zeros.
    ``return_lse``: also each head's fp32 log-sum-exp (B, H) (the tensor-parallel
    decode over a cache split across ranks combines by it).
    """
    config = active_dispatch()
    check_no_backward("decode_attention", q, k_cache, v_cache, device_type=q.device.type, config=config)
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    sig = (B, S, KV, H // KV, hd)
    if _use_kernel(q.device, config):
        _record("decode_attention", PATH_KERNEL, sig)
        if dry.active():  # a dry decode sits at its cache's last position: every row valid
            vd = v_cache.shape[-1]
            return dry.kernel("decode_attention",
                              kernel_cost.decode_attention(B, S, H, KV, hd, q.element_size(), n_rows=B * S,
                                                                   vd=vd),
                              lambda: _ref.decode_attention_ref(q, k_cache, v_cache, valid, return_lse=return_lse))
        return _decode_kernel(q, k_cache, v_cache, valid, return_lse=return_lse)
    _record("decode_attention", PATH_REFERENCE, sig)
    return _ref.decode_attention_ref(q, k_cache, v_cache, valid, return_lse=return_lse)


def choose_paged_decode_path(*, device_type: str, config: Optional[DispatchConfig] = None) -> str:
    """The auto table of block-table decode attention: on ``cuda`` under
    ``auto`` the kernel, for every depth (the reference's TPU-only
    ``DECODE_MIN_SEQ`` threshold is not carried over); otherwise the plain
    gather-then-attend version."""
    config = config or active_dispatch()
    if config.backend == "auto" and _on_card(device_type):
        return PATH_KERNEL
    return PATH_REFERENCE


def paged_decode_attention(q, k_pool, v_pool, block_table, n_valid):
    """One-token GQA attention through a paged KV pool (continuous batching).

    q: (B, 1, H, hd); pools: (P, page, KV, hd/vd) physical pages shared by
    every slot; block_table: (B, n_tbl) int32 page ids; n_valid: (B,) int32
    valid logical positions.  Fully-masked rows give zeros on both paths.
    """
    check_no_backward("paged_decode_attention", q, k_pool, v_pool, device_type=q.device.type)
    path = choose_paged_decode_path(device_type=q.device.type)
    B, _, H, hd = q.shape
    P, page, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    n_tbl = block_table.shape[1]
    _record("paged_decode_attention", path, (B, P, page, n_tbl, KV, H // KV, hd))
    if path == PATH_KERNEL and dry.active():  # every page of the table counted valid: the lengths are data
        return dry.kernel("paged_decode_attention",
                          kernel_cost.paged_decode_attention(B, n_tbl, H, KV, hd, q.element_size(),
                                                                     n_rows=B * n_tbl * page),
                          lambda: _ref.paged_decode_attention_ref(q, k_pool, v_pool, block_table, n_valid))
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
    if _via_function(config, x, dt, B_in, C_in, A):
        _record("ssd_scan", PATH_KERNEL if _use_kernel(x.device, config) else PATH_REFERENCE, sig)
        return SsdScanFn.apply(x, dt, B_in, C_in, A, chunk, round_xbar)
    if _use_kernel(x.device, config):
        _record("ssd_scan", PATH_KERNEL, sig)
        return _ssd_launch(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)
    _record("ssd_scan", PATH_REFERENCE, sig)
    return _ref.ssd_scan_plain(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)
