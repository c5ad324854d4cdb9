"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and nvcc (the kernels build for
sm_90a at first use) and skip anywhere else.  No JAX here — the machine
with the card has none; the plain versions are held against the JAX
reference by the other tests/test_torch_*.py files.  Run on a card with

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances, relative to the largest reference value: bf16 1e-2 for the
GEMMs and 2e-2 for attention (outputs, the rounded x@A and the rounded p
may land one bf16 ulp, 2^-8, apart where sums in another order straddle a
rounding boundary); fp32 1e-4 (summation order only).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import aligned_rows
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lowrank_matmul import lowrank_matmul
from repro_torch.kernels.sketch_matmul import sketch_matmul

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEMM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _close(got, want, rel):
    want = want.float()
    err = float((got.float() - want).abs().max())
    assert err <= rel * float(want.abs().max()), (err, float(want.abs().max()))


def _rand(shape, seed, dtype, device):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) / shape[-1] ** 0.25
    return torch.from_numpy(x).to(device, DTYPES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("M,K,N", [(130, 250, 77), (2048, 512, 154)])
def test_gpu_sketch_matmul(cuda, M, K, N, trans_a, dtype):
    a = _rand((K, M) if trans_a else (M, K), 1, dtype, cuda)
    b = _rand((K, N), 2, dtype, cuda)
    _close(sketch_matmul(a, b, trans_a=trans_a), ref.sketch_matmul_ref(a, b, trans_a=trans_a), GEMM_TOL[dtype])
    if dtype == "bfloat16":
        got = sketch_matmul(a, b, trans_a=trans_a, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        _close(got, ref.sketch_matmul_ref(a, b, trans_a=trans_a, out_dtype=torch.float32), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 70])  # both sides of the split-K (M <= 8) path
@pytest.mark.parametrize("K,r,N", [(250, 37, 96), (512, 154, 512)])
def test_gpu_lowrank_matmul(cuda, M, K, r, N, dtype):
    x = _rand((M, K), 3, dtype, cuda)
    for A, B in (
        (_rand((K, r), 4, dtype, cuda), _rand((r, N), 5, dtype, cuda)),  # ragged row strides
        (aligned_rows(_rand((K, r), 4, dtype, cuda)), aligned_rows(_rand((r, N), 5, dtype, cuda))),
    ):
        _close(lowrank_matmul(x, A, B), ref.lowrank_matmul_ref(x, A, B), GEMM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,G", [(45, 4), (200, 1), (300, 8)])
def test_gpu_decode_attention(cuda, S, G, dtype):
    B, KV, hd = 3, 2, 64
    q, k, v = (_rand(s, 6 + i, dtype, cuda) for i, s in enumerate([(B, 1, KV * G, hd), (B, S, KV, hd),
                                                                      (B, S, KV, hd)]))
    valid = torch.arange(S, device=cuda)[None, :] < torch.tensor([[S], [S // 3], [0]], device=cuda)
    got = decode_attention(q, k, v, valid)
    _close(got, ref.decode_attention_ref(q, k, v, valid), ATTN_TOL[dtype])
    assert bool((got[2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,q_offset", [(70, None, 0), (128, 32, 0), (40, None, 24)])
def test_gpu_flash_attention(cuda, S, window, q_offset, dtype):
    B, H, KV, hd = 2, 8, 2, 64
    q = _rand((B, S, H, hd), 9, dtype, cuda)
    k, v = _rand((B, S + q_offset, KV, hd), 10, dtype, cuda), _rand((B, S + q_offset, KV, hd), 11, dtype, cuda)
    got = flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset)
    _close(got, want, ATTN_TOL[dtype])
