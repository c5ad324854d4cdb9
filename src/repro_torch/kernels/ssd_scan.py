"""Wrapper of the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

``ssd_scan(x, dt, B_in, C_in, A)`` -> (y, final_state): x (B, L, nh, hd)
raw, dt (B, L, nh) fp32 after softplus, B_in/C_in (B, L, s) in x's dtype,
A (nh,) fp32 and negative; y in x's dtype, the state (B, nh, hd, s) fp32.
Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` and,
in the model, the reference's ``models/ssm.py::_ssd_chunk_scan``.

``round_xbar`` picks the contract for x̄ = x * dt: rounded to x's dtype
before the scan (the model's, ``repro/models/ssm.py:148``) or kept in fp32
(the TPU kernel's); the two agree in fp32.  The kernel walks chunks of its
own fixed length; ``chunk`` (default 128, as ``ssd_scan_pallas``'s) feeds
the reference's chunk rule, which only the plain version follows (the two
differ in summation order only).

On a CPU tensor the plain version (``ref.ssd_scan_plain``) runs; on a CUDA
tensor the kernel launches or this raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, KernelLib, P

__all__ = ["KERNEL", "MAX_STATE", "ssd_scan"]

MAX_STATE = 256  # largest state dim the kernel's shared-memory layout takes
_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
KERNEL = KernelLib("ssd_scan", {"ssd_scan_bf16": _ARGS, "ssd_scan_f32": _ARGS})


def _d_tile(batch: int, nh: int, hd: int, n_sms: int) -> int:
    """Head-dim columns per block: 32, unless that leaves SMs idle (fewer
    blocks than SMs) and 16 divides hd."""
    return 32 if hd % 32 == 0 and batch * nh * (hd // 32) >= n_sms else 16


def ssd_scan(x, dt, B_in, C_in, A, *, chunk: int = 128, round_xbar: bool = False):
    """Returns (y (B, L, nh, hd) in x's dtype, final_state (B, nh, hd, s) fp32)."""
    ts = (x, dt, B_in, C_in, A)
    if all(t.device.type == "cpu" for t in ts):
        return ref.ssd_scan_plain(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)
    if any(t.device != x.device for t in ts) or x.device.type != "cuda":
        raise ValueError(f"ssd_scan: operands on {[str(t.device) for t in ts]}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not (x.dtype == B_in.dtype == C_in.dtype):
        raise TypeError(f"ssd_scan: x, B_in, C_in dtypes {x.dtype}, {B_in.dtype}, {C_in.dtype}; "
                        "need one of bf16/fp32 for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be fp32, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, L, nh, hd), got {tuple(x.shape)}")
    Bsz, L, nh, hd = x.shape
    s = B_in.shape[-1]
    if dt.shape != (Bsz, L, nh) or B_in.shape != (Bsz, L, s) or C_in.shape != (Bsz, L, s) or A.shape != (nh,):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, B_in {tuple(B_in.shape)}, "
                         f"C_in {tuple(C_in.shape)}, A {tuple(A.shape)}")
    if L < 1 or hd % 16 or not 1 <= s <= MAX_STATE:
        raise ValueError(f"ssd_scan: L {L} >= 1, hd {hd} a multiple of 16 and state {s} in [1, {MAX_STATE}] needed")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan: operands must be contiguous")
    y = torch.empty_like(x)
    state = torch.empty((Bsz, nh, hd, s), dtype=torch.float32, device=x.device)
    tile = _d_tile(Bsz, nh, hd, torch.cuda.get_device_properties(x.device).multi_processor_count)
    entry = "ssd_scan_f32" if x.dtype == torch.float32 else "ssd_scan_bf16"
    KERNEL.launch(entry, x.device, x.data_ptr(), dt.data_ptr(), B_in.data_ptr(), C_in.data_ptr(), A.data_ptr(),
                  y.data_ptr(), state.data_ptr(), Bsz, L, nh, hd, s, int(round_xbar), tile)
    return y, state
