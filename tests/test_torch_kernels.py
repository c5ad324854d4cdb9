"""The port's kernels, held against the reference's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version (the CUDA
kernels build and run only on a card); the same seeded numpy inputs go
through the JAX Pallas kernel in interpret mode (as tests/test_kernels.py
and tests/test_decode_kernel.py run it) and through repro.kernels.ref.
Cases: ragged ranks, transposed sketch operands, GQA ratios, ragged and
fully-masked decode rows, causal/window/q_offset prefill masks.

Tolerances: fp32 2e-5 (the two frameworks sum in different orders);
bf16 3e-2 (one bf16 ulp is 2^-8 relative, and both sides round the same
intermediates but may land on neighbouring values).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.lowrank_matmul import lowrank_matmul_pallas  # noqa: E402
from repro.kernels.sketch_matmul import sketch_matmul_pallas  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.lowrank_matmul import lowrank_matmul  # noqa: E402
from repro_torch.kernels.sketch_matmul import sketch_matmul  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _np(shape, seed, scale=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x / (shape[-1] ** 0.25 if scale is None else scale)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _close(got_torch, want_jax, dtype):
    np.testing.assert_allclose(got_torch.float().numpy(), np.asarray(want_jax, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(64, 128, 32), (100, 257, 65), (33, 70, 200)])
@pytest.mark.parametrize("trans_a", [False, True])
def test_sketch_matmul_matches_pallas(M, K, N, trans_a, dtype):
    a_np = _np((K, M) if trans_a else (M, K), 0)
    ja, ta = _pair(a_np, dtype)
    jb, tb = _pair(_np((K, N), 1), dtype)
    got = sketch_matmul(ta, tb, trans_a=trans_a)
    ja_op = ja.T if trans_a else ja
    want = sketch_matmul_pallas(ja_op, jb, bm=32, bn=32, bk=64, interpret=True)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (M, N)
    _close(got, want, dtype)
    _close(got, jref.sketch_matmul_ref(ja_op, jb), dtype)


def test_sketch_matmul_fp32_output_is_unrounded():
    ja, ta = _pair(_np((48, 96), 2), "bfloat16")
    jb, tb = _pair(_np((96, 5), 3), "bfloat16")
    got = sketch_matmul(ta, tb, out_dtype=torch.float32)
    want = jnp.matmul(ja, jb, preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,r,N", [(64, 128, 16, 64), (100, 250, 37, 48), (4, 96, 29, 200)])
def test_lowrank_matmul_matches_pallas(M, K, r, N, dtype):
    jx, tx = _pair(_np((M, K), 4), dtype)
    jA, tA = _pair(_np((K, r), 5), dtype)
    jB, tB = _pair(_np((r, N), 6), dtype)
    got = lowrank_matmul(tx, tA, tB)
    want = lowrank_matmul_pallas(jx, jA, jB, bm=32, bk=64, interpret=True)
    _close(got, want, dtype)
    _close(got, jref.lowrank_matmul_ref(jx, jA, jB), dtype)


def _decode_inputs(B, S, KV, G, hd, dtype, seed):
    jq, tq = _pair(_np((B, 1, KV * G, hd), seed), dtype)
    jk, tk = _pair(_np((B, S, KV, hd), seed + 1), dtype)
    jv, tv = _pair(_np((B, S, KV, hd), seed + 2), dtype)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_decode_attention_matches_pallas(G, dtype):
    B, S, KV, hd = 3, 64, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(B, S, KV, G, hd, dtype, 10)
    n_valid = np.array([S, 23, 0])  # full, ragged, and a fully-masked row
    valid = np.arange(S)[None, :] < n_valid[:, None]
    got = decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(valid), bs=32, interpret=True)
    _close(got, want, dtype)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid)), dtype)
    assert torch.all(got[2] == 0) and not torch.isnan(got).any()


def test_decode_attention_never_reads_masked_positions():
    B, S, KV, G, hd = 2, 40, 2, 4, 16
    (_, _, _), (tq, tk, tv) = _decode_inputs(B, S, KV, G, hd, "float32", 20)
    valid = torch.arange(S)[None, :] < torch.tensor([[7], [31]])
    poison = ~valid[:, :, None, None]
    got = decode_attention(tq, tk.masked_fill(poison, 1e4), tv.masked_fill(poison, 1e4), valid)
    np.testing.assert_allclose(got.numpy(), decode_attention(tq, tk, tv, valid).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "S,KV,G,window,q_offset",
    [(64, 2, 4, None, 0), (40, 1, 2, None, 0), (64, 2, 2, 16, 0), (24, 2, 1, None, 8)],
)
def test_flash_attention_matches_reference_prefill(S, KV, G, window, q_offset, dtype):
    """The port's prefill kernel computes the reference model's prefill
    attention (_flash_fwd_pass): GQA grouping, causal, window, q_offset."""
    B, hd = 2, 16
    jq, tq = _pair(_np((B, S, KV * G, hd), 30), dtype)
    Skv = S + q_offset
    jk, tk = _pair(_np((B, Skv, KV, hd), 31), dtype)
    jv, tv = _pair(_np((B, Skv, KV, hd), 32), dtype)
    got = flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    want = chunked_attention(jq, jk, jv, causal=True, window=window, q_offset=q_offset)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,KV,G,window,q_offset", [(64, 2, 4, None, 0), (24, 2, 1, 8, 8)])
def test_flash_attention_lse_matches_reference_forward(S, KV, G, window, q_offset, dtype):
    """``return_lse``: the wrapper's row log-sum-exp (the training forward's,
    which the backward reads) is the lse of the reference's
    ``_flash_fwd_pass`` in its (B, KV, G, Sq) layout, and the output is the
    same bits as without it.  lse is fp32 on both sides: rtol 1e-5 in fp32,
    and in bf16 (whose scores come from bf16 q and k) 3e-2 of its scale."""
    from repro.models.attention import _flash_fwd_pass

    B, hd = 2, 16
    jq, tq = _pair(_np((B, S, KV * G, hd), 33), dtype)
    jk, tk = _pair(_np((B, S + q_offset, KV, hd), 34), dtype)
    jv, tv = _pair(_np((B, S + q_offset, KV, hd), 35), dtype)
    out, lse = flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset, return_lse=True)
    assert torch.equal(out, flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset))
    want_out, want_lse = _flash_fwd_pass(jq, jk, jv, True, window, 2048, 1024, q_offset)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, KV, G, S)
    _close(out, want_out, dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=3e-2 * float(np.abs(want_lse).max()))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_at_g1(dtype):
    """At G = 1 the port's kernel is held against flash_attention_pallas.  The
    Pallas kernel scales the fp32 scores after the dot while the port (like
    the reference model) rounds the scaled q to the input dtype before it:
    identical in fp32 up to summation order, within a bf16 ulp of q in bf16
    (covered by the 3e-2 tolerance)."""
    B, S, H, hd = 2, 64, 2, 16
    jq, tq = _pair(_np((B, S, H, hd), 40), dtype)
    jk, tk = _pair(_np((B, S, H, hd), 41), dtype)
    jv, tv = _pair(_np((B, S, H, hd), 42), dtype)
    got = flash_attention(tq, tk, tv, causal=True)
    want = flash_attention_pallas(jq, jk, jv, causal=True, bq=32, bkv=32, interpret=True)
    _close(got, want, dtype)
    _close(tref.flash_attention_ref(tq, tk, tv), jref.flash_attention_ref(jq, jk, jv), dtype)


def test_wrappers_refuse_mixed_devices_and_dtypes():
    x = torch.zeros(4, 8)
    with pytest.raises((TypeError, ValueError)):
        sketch_matmul(x.to(torch.bfloat16).to("meta"), x.to(torch.bfloat16))


@pytest.mark.parametrize("rank", [1, 37, 615, 1638])
def test_lowrank_path_table(rank):
    """On a CUDA tensor `auto` takes the fused kernel for every rank (no VMEM
    fit test, no rank floor); `reference` and the CPU take the two-GEMM
    plain version, at any token count."""
    K, N = 2048, 8192
    for M in (4, 4096):
        shapes = ((M, K), (K, rank), (rank, N))
        assert dispatch.choose_lowrank_path(*shapes, device_type="cuda") == dispatch.PATH_FUSED
        ref_cfg = dispatch.DispatchConfig(backend="reference")
        assert dispatch.choose_lowrank_path(*shapes, device_type="cuda", config=ref_cfg) == dispatch.PATH_TWO_GEMM
        assert dispatch.choose_lowrank_path(*shapes, device_type="cpu") == dispatch.PATH_TWO_GEMM


def test_dispatch_counts_calls_per_path():
    dispatch.reset_counters()
    x = torch.randn(3, 16)
    with dispatch.use_dispatch(backend="reference"):
        dispatch.lowrank_apply(x, torch.randn(16, 4), torch.randn(4, 8))
        dispatch.sketch_matmul(torch.randn(16, 8), torch.randn(8, 2))
    by_path = dispatch.counters_by_path()
    assert by_path[("lowrank_matmul", dispatch.PATH_TWO_GEMM)] == 1
    assert by_path[("sketch_matmul", "reference")] == 1
    assert "lowrank_matmul" in dispatch.format_counters()
