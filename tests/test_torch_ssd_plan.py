"""The SSD scan kernel's launch plan and its precision scheme (``kernels/ssd_scan.py``).

The kernel runs on the card only (tests/test_torch_gpu.py).  What is held
here is what it is given and how it multiplies:

* The plan (:func:`ssd_plan`), a function of the shapes and the card's SM
  count alone: the columns a block divide hd, the padded state width is a
  multiple of 16 at least s, a block fits in shared memory, the blocks cover
  every (sequence, head, column) once, a cluster holds column tiles of one
  head, the column tile follows the plan's rule, and the main-path plans are
  pinned.
* The bf16 kernel's arithmetic, emulated in plain torch on the CPU: its
  64-step chunks, bf16 operands multiplied exactly with fp32 accumulation,
  and every fp32-valued operand (the decayed scores, the state, the
  weighted B) split into a bf16 hi and lo part.  The emulation is held to
  the plain version (``ref``) within the kernel's own tolerances (state
  1e-4 of its max, fp32 y 1e-4), and against the same emulation with those
  operands rounded once to bf16, whose state error is printed beside it.
"""

import inspect
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

H100_SMS = 132

# (B, L, nh, hd, s) of the main paths: zamba2-1.2b's prefill (one prompt, the engine's batch of
# four short ones) and mamba2-130m's
MAIN = {"zamba2 (1, 512)": (1, 512, 64, 64, 64), "zamba2 (4, 256)": (4, 256, 64, 64, 64),
        "mamba2 (1, 512)": (1, 512, 24, 64, 128)}
PINNED = {  # (cols, threads, s_pad, grid, cluster) at 132 SMs
    ("zamba2 (1, 512)", torch.bfloat16): (32, 256, 64, (2, 64, 1), 2),
    ("zamba2 (4, 256)", torch.bfloat16): (32, 256, 64, (2, 64, 4), 2),
    ("mamba2 (1, 512)", torch.bfloat16): (16, 256, 128, (4, 24, 1), 4),
    ("zamba2 (1, 512)", torch.float32): (16, 256, 64, (4, 64, 1), 1),
    ("mamba2 (1, 512)", torch.float32): (16, 256, 128, (4, 24, 1), 1),
}
# (B, L, nh, hd, s) swept at each dtype and SM count
SWEEP = list(itertools.product((1, 3), (1, 97), (1, 5, 24, 64), (16, 32, 64, 128), (1, 8, 16, 64, 100, 128, 256)))


def _check_plan(B, L, nh, hd, s, dtype, n_sms):
    plan = ssd.ssd_plan(B, L, nh, hd, s, dtype, n_sms)
    assert hd % plan.cols == 0
    assert plan.grid == (hd // plan.cols, nh, B)
    assert plan.s_pad >= s
    if dtype == torch.bfloat16:
        assert plan.s_pad % 16 == 0 and plan.s_pad - s < 16
        assert plan.cols in ssd.COLS and not (plan.cols == 32 and plan.s_pad > 128)
        assert plan.smem == ssd.mma_smem(plan.cols, plan.s_pad)
    else:
        assert plan.s_pad == s and plan.cols in ssd.COLS
        assert plan.smem == ssd.fma_smem(plan.cols, s)
    assert plan.smem <= ssd.SMEM_MAX
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    return plan


def test_ssd_plan_is_a_function_of_the_shapes():
    assert list(inspect.signature(ssd.ssd_plan).parameters) == ["B", "L", "nh", "hd", "s", "dtype", "n_sms"]
    for B, L, nh, hd, s in MAIN.values():
        p = ssd.ssd_plan(B, L, nh, hd, s, torch.bfloat16, H100_SMS)
        assert p == ssd.ssd_plan(B, L, nh, hd, s, torch.bfloat16, H100_SMS)
        assert all(ssd.ssd_plan(B, L2, nh, hd, s, torch.bfloat16, H100_SMS) == p for L2 in (1, 63, 64, 4096))


@pytest.mark.parametrize("name", sorted(MAIN))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_plan_main_paths(name, dtype):
    plan = _check_plan(*MAIN[name], dtype, H100_SMS)
    want = PINNED.get((name, dtype))
    if want is not None:
        assert (plan.cols, plan.threads, plan.s_pad, plan.grid, plan.cluster) == want
    B, _, nh, hd, _ = MAIN[name]
    print(f"{name} {dtype}: {plan}, {B * nh * (hd // plan.cols)} blocks on {H100_SMS} SMs")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_sms", [1, 78, H100_SMS, 1000])
def test_ssd_plan_sweep(dtype, n_sms):
    """Over a sweep of shapes: every block (sequence b, head h, column tile)
    appears once and the tiles of a head cover its hd columns once; the
    column tile and the cluster follow the plan's rules."""
    bf16 = dtype == torch.bfloat16
    for B, L, nh, hd, s in SWEEP:
        plan = _check_plan(B, L, nh, hd, s, dtype, n_sms)
        gx, gy, gz = plan.grid
        cols = sorted(c for x in range(gx) for c in range(x * plan.cols, (x + 1) * plan.cols))
        assert cols == list(range(hd))
        assert gy * gz == nh * B
        cands = [c for c in ssd.COLS
                 if hd % c == 0 and not (bf16 and c == 32 and plan.s_pad > 128)
                 and (ssd.mma_smem(c, plan.s_pad) if bf16 else ssd.fma_smem(c, s)) <= ssd.SMEM_MAX]
        if bf16:  # the narrowest tile whose grid fits one block an SM, else the widest
            fitting = [c for c in cands if B * nh * (hd // c) <= n_sms]
            assert plan.cols == (min(fitting) if fitting else max(cands))
            assert (hd // plan.cols) % plan.cluster == 0 and 1 <= plan.cluster <= 4
            assert plan.cluster == max(c for c in (1, 2, 3, 4) if (hd // plan.cols) % c == 0)
        else:  # the widest tile that still gives every SM a block, else the narrowest
            filling = [c for c in cands if B * nh * (hd // c) >= n_sms]
            assert plan.cols == (max(filling) if filling else min(cands))
            assert plan.cluster == 1


# --------------------------------------------------------------------------- #
# the bf16 kernel's arithmetic, emulated
# --------------------------------------------------------------------------- #
def _split(v, split):
    """bf16 hi + lo of fp32 values (the kernel's operand split), or hi alone."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float() if split else hi


def _emulate(x, dt, B_in, C_in, A, *, round_xbar, split):
    """The bf16 kernel's sums at chunk 64, in fp32 on the CPU: C B^T, C state^T
    and the products with x exact in fp32 (bf16 operands); the decayed
    scores (C_t . B_u) exp(l_t - l_u) w_u, the state and B_u exp(l_last - l_u)
    w_u enter as hi + lo (``split``) or rounded once to bf16.  x enters as
    bf16(x dt) under round_xbar, else raw with w_u = dt_u folded into the
    other operand.  Returns (y fp32, final state fp32)."""
    Bsz, L, nh, hd = x.shape
    s, Q = B_in.shape[-1], ssd.CHUNK
    Lp = -(-L // Q) * Q
    pad = Lp - L

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))

    xf, dtf, Bf, Cf = padded(x), padded(dt), padded(B_in), padded(C_in)
    X = (xf * dtf[..., None]).to(torch.bfloat16).float() if round_xbar else xf
    w = torch.ones_like(dtf) if round_xbar else dtf  # (B, Lp, nh)
    state = torch.zeros((Bsz, nh, hd, s))
    ys = []
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    for c in range(Lp // Q):
        sl = slice(c * Q, (c + 1) * Q)
        Xc, Bc, Cc, wc = X[:, sl], Bf[:, sl], Cf[:, sl], w[:, sl]
        lc = torch.cumsum(dtf[:, sl] * A.float(), dim=1)  # (B, Q, nh)
        g = torch.einsum("bts,bus->btu", Cc, Bc)  # exact products, fp32 sums
        seg = lc[:, :, None, :] - lc[:, None, :, :]  # (B, t, u, nh)
        decay = torch.exp(torch.where(tri[None, :, :, None], seg, torch.full_like(seg, -1e30)))
        M = _split(g[..., None] * decay * wc[:, None, :, :], split)  # (B, t, u, nh)
        y_intra = torch.einsum("btuh,buhd->bthd", M, Xc)
        y_state = torch.einsum("bts,bhds->bthd", Cc, _split(state, split)) * torch.exp(lc)[..., None]
        v = wc * torch.exp(lc[:, -1:, :] - lc)  # (B, Q, nh)
        Bw = _split(Bc[:, :, None, :] * v[..., None], split)  # (B, u, nh, s)
        state = state * torch.exp(lc[:, -1])[:, :, None, None] + torch.einsum("buhs,buhd->bhds", Bw, Xc)
        ys.append(y_intra + y_state)
    return torch.cat(ys, dim=1)[:, :L], state


def _inputs(B, L, nh, hd, s, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, L, nh, hd)).astype(np.float32)).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((B, L, nh)).astype(np.float32)))
    Bm = torch.from_numpy((rng.standard_normal((B, L, s)) / s**0.5).astype(np.float32)).to(torch.bfloat16)
    Cm = torch.from_numpy((rng.standard_normal((B, L, s)) / s**0.5).astype(np.float32)).to(torch.bfloat16)
    A = -torch.linspace(1.0, 16.0, nh)
    return x, dt, Bm, Cm, A


# zamba2's and mamba2's head shapes (hd, s), two heads (the first and the slowest decay), four
# chunks with a ragged last one
@pytest.mark.parametrize("hd,s", [(64, 64), (64, 128)], ids=["zamba2", "mamba2"])
@pytest.mark.parametrize("round_xbar", [True, False])
def test_ssd_split_precision(hd, s, round_xbar):
    x, dt, Bm, Cm, A = _inputs(1, 230, 2, hd, s)
    A = A.flip(0)  # head 0 decays slowest (A = -1): the longest memory
    want_y, want_s = ref.ssd_chunk_scan_ref(ref.ssd_xbar(x, dt, round_xbar), dt, Bm, Cm, A, 256,
                                            out_dtype=torch.float32)
    y, st = _emulate(x, dt, Bm, Cm, A, round_xbar=round_xbar, split=True)
    y_r, st_r = _emulate(x, dt, Bm, Cm, A, round_xbar=round_xbar, split=False)
    scale_s, scale_y = float(want_s.abs().max()), float(want_y.abs().max())
    err_s, err_y = float((st - want_s).abs().max()) / scale_s, float((y - want_y).abs().max()) / scale_y
    err_s_r, err_y_r = float((st_r - want_s).abs().max()) / scale_s, float((y_r - want_y).abs().max()) / scale_y
    print(f"hd {hd} s {s} round_xbar {round_xbar}: state error / max |state| split {err_s:.2e}, "
          f"plain bf16 rounding {err_s_r:.2e}; y error / max |y| split {err_y:.2e}, rounding {err_y_r:.2e}")
    assert err_s <= 1e-4 and err_y <= 1e-4
    assert err_s * 10 < err_s_r and err_y * 10 < err_y_r
