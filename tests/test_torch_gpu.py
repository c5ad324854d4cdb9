"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the serving engine's captured decode block against the same block run
eagerly.

Marked ``gpu``: they need a CUDA device and nvcc (the kernels build for
sm_90a at first use) and skip anywhere else.  No JAX here — the machine
with the card has none; the plain versions are held against the JAX
reference by the other tests/test_torch_*.py files.  Run on a card with

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances, relative to the largest reference value: bf16 1e-2 for the
GEMMs and 2e-2 for attention (outputs, the rounded x@A and the rounded p
may land one bf16 ulp, 2^-8, apart where sums in another order straddle a
rounding boundary); fp32 1e-4 (summation order only).  The SSD scan: y
as the GEMMs (bf16 1e-2, fp32 1e-4) and its fp32 final state 1e-4 in both
(the kernel's fixed 64-step chunks against the reference's chunk rule
change only the summation order; x̄ is formed by the same one multiply;
the bf16 kernel's fp32-valued operands enter its tensor-core products as
bf16 hi and lo parts, ~16 significant bits).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import aligned_rows
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lowrank_matmul import lowrank_matmul
from repro_torch.kernels.lowrank_matmul_batched import lowrank_matmul_batched
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.sketch_matmul import ALIGN_COPIES, sketch_matmul
from repro_torch.kernels.ssd_scan import ssd_scan

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
@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("M,K,N", [
    (2048, 8192, 615),  # RSI's W @ Y at l = 615; under trans_a its W^T @ X (M = 8192)
    (256, 1000, 130),   # K not a multiple of the 64-deep k-block
    (300, 2048, 64),    # N at the 64-wide tile
])
def test_gpu_sketch_matmul_rsi_storage(cuda, M, K, N, trans_a):
    """bf16 operands in the storage RSI gives them (aligned_rows: Y at row
    stride 616): no copy before the launch, and the result within tolerance,
    bf16 and fp32 out.  Under trans_a the stored operand is (K, M), so
    (2048, 8192, 615) is RSI's W^T @ X with W stored (2048, 8192) and M = 8192."""
    if trans_a:
        M, K = K, M
    a = _rand((K, M) if trans_a else (M, K), 21, "bfloat16", cuda)
    b = aligned_rows(_rand((K, N), 22, "bfloat16", cuda))
    before = ALIGN_COPIES.count
    _close(sketch_matmul(a, b, trans_a=trans_a), ref.sketch_matmul_ref(a, b, trans_a=trans_a), GEMM_TOL["bfloat16"])
    got = sketch_matmul(a, b, trans_a=trans_a, out_dtype=torch.float32)
    _close(got, ref.sketch_matmul_ref(a, b, trans_a=trans_a, out_dtype=torch.float32), 1e-4)
    assert ALIGN_COPIES.count == before


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 4, 8])
def test_gpu_sketch_matmul_skinny_f32out(cuda, N):
    """The tied-logits form: a tall table times a skinny x^T (in the storage
    logits_apply gives it), fp32 out, with a ragged last row tile."""
    a = _rand((5000, 2048), 23, "bfloat16", cuda)
    b = aligned_rows(_rand((2048, N), 24, "bfloat16", cuda))
    before = ALIGN_COPIES.count
    got = sketch_matmul(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5000, N)
    _close(got, ref.sketch_matmul_ref(a, b, out_dtype=torch.float32), 1e-4)
    assert ALIGN_COPIES.count == before


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 70])
def test_gpu_logits_apply_untied(cuda, M):
    """The untied head's fp32 logits on the card (computed as head^T @ x^T,
    the head read in place), against the plain x @ head; no operand copied."""
    from repro_torch.runtime import dispatch

    x = _rand((M, 512), 29, "bfloat16", cuda)
    head = _rand((512, 5000), 30, "bfloat16", cuda)
    before = ALIGN_COPIES.count
    got = dispatch.logits_apply(x, head, tied=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, 5000)
    _close(got, ref.sketch_matmul_ref(x, head, out_dtype=torch.float32), 1e-4)
    assert ALIGN_COPIES.count == before


@pytest.mark.gpu
def test_gpu_sketch_matmul_copies_unaligned(cuda):
    """A bf16 operand TMA cannot read in place (row stride 77) is copied into
    aligned rows first, counted once; the aligned one is read in place."""
    a = _rand((130, 256), 25, "bfloat16", cuda)  # row stride 256: aligned
    b = _rand((256, 77), 26, "bfloat16", cuda)   # row stride 77: not a multiple of 8
    before = ALIGN_COPIES.count
    _close(sketch_matmul(a, b), ref.sketch_matmul_ref(a, b), GEMM_TOL["bfloat16"])
    assert ALIGN_COPIES.count == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("trans_a", [False, True])
def test_gpu_sketch_matmul_deterministic(cuda, trans_a):
    """Two launches give the same bits (the split-K cluster sums in rank order)."""
    a = _rand((2048, 8192), 27, "bfloat16", cuda)
    b = aligned_rows(_rand((2048 if trans_a else 8192, 615), 28, "bfloat16", cuda))
    assert torch.equal(sketch_matmul(a, b, trans_a=trans_a), sketch_matmul(a, b, trans_a=trans_a))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 70])  # both sides of the skinny (M <= 8) path
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
@pytest.mark.parametrize("L,M,K,r,N", [(1, 128, 250, 37, 96), (4, 128, 512, 154, 320), (3, 70, 96, 29, 200),
                                       (16, 9, 64, 16, 64)])
def test_gpu_lowrank_matmul_batched(cuda, L, M, K, r, N, dtype):
    """The batched kernel against its plain version: contiguous stacks (ragged
    row strides), row-padded factors, and each layer's (E, K, r) view of an
    (L, E, K, r) leaf read in place through its row and stack strides."""
    x = _rand((L, M, K), 13, dtype, cuda)
    A, B = _rand((L, K, r), 14, dtype, cuda), _rand((L, r, N), 15, dtype, cuda)
    _close(lowrank_matmul_batched(x, A, B), ref.lowrank_matmul_ref(x, A, B), GEMM_TOL[dtype])
    A2, B2 = aligned_rows(A), aligned_rows(B)
    _close(lowrank_matmul_batched(x, A2, B2), ref.lowrank_matmul_ref(x, A, B), GEMM_TOL[dtype])
    leaf_a = aligned_rows(_rand((2, L, K, r), 16, dtype, cuda))
    leaf_b = aligned_rows(_rand((2, L, r, N), 17, dtype, cuda))
    for layer in range(2):
        A3, B3 = leaf_a[layer], leaf_b[layer]
        assert A3.data_ptr() == leaf_a.data_ptr() + layer * leaf_a.stride(0) * leaf_a.element_size()
        _close(lowrank_matmul_batched(x, A3, B3), ref.lowrank_matmul_ref(x, A3, B3), GEMM_TOL[dtype])
    # every stack entry is its own 2-D product
    y = lowrank_matmul_batched(x, A2, B2)
    for i in range(L):
        _close(y[i], ref.lowrank_matmul_ref(x[i], A[i], B[i]), GEMM_TOL[dtype])


@pytest.mark.gpu
def test_gpu_lowrank_matmul_batched_refuses_bad_operands(cuda):
    x, A, B = (_rand(s, 18, "bfloat16", cuda) for s in ((2, 8, 16), (2, 16, 4), (2, 4, 8)))
    with pytest.raises(ValueError, match="operands on"):
        lowrank_matmul_batched(x, A.cpu(), B)
    with pytest.raises(TypeError):
        lowrank_matmul_batched(x, A.float(), B)
    with pytest.raises(ValueError):
        lowrank_matmul_batched(x, A[:, :8], B)
    with pytest.raises(ValueError):
        lowrank_matmul_batched(x[0], A[0], B[0])
    with pytest.raises(ValueError, match="contiguous rows"):
        lowrank_matmul_batched(x, A.transpose(1, 2).contiguous().transpose(1, 2), B)


# the main path's 2-D low-rank shapes (K, r, N): llama's wq/wo, wk/wv, w_gate/w_up, w_down at
# alpha 0.3, phi3.5-moe's compressed attention projection and untied head, zamba2's w_x and w_dt
LOWRANK_MAIN = [(2048, 615, 2048), (2048, 154, 512), (2048, 615, 8192), (8192, 615, 2048), (4096, 1229, 4096),
                (4096, 1229, 32064), (2048, 615, 4096), (2048, 20, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 256])
@pytest.mark.parametrize("K,r,N", LOWRANK_MAIN)
def test_gpu_lowrank_matmul_main_shapes(cuda, M, K, r, N, dtype):
    """The 2-D kernel at the main path's shapes (decode M <= 8 on the skinny
    kernel, the engine's 256-row chunk on the wgmma tiles), factors in the
    storage the model keeps them in (row-padded), against its plain version."""
    x = _rand((M, K), 40, dtype, cuda)
    A, B = aligned_rows(_rand((K, r), 41, dtype, cuda)), aligned_rows(_rand((r, N), 42, dtype, cuda))
    before = ALIGN_COPIES.count
    _close(lowrank_matmul(x, A, B), ref.lowrank_matmul_ref(x, A, B), GEMM_TOL[dtype])
    assert ALIGN_COPIES.count == before  # read in place: nothing copied for TMA


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 8, 256, 1024])
def test_gpu_lowrank_matmul_deterministic(cuda, M):
    """Two launches give the same bits: the k-splits of the skinny kernel and
    of the wgmma tiles are summed in cluster-rank order."""
    x = _rand((M, 2048), 43, "bfloat16", cuda)
    A, B = aligned_rows(_rand((2048, 615), 44, "bfloat16", cuda)), aligned_rows(_rand((615, 8192), 45, "bfloat16", cuda))
    assert torch.equal(lowrank_matmul(x, A, B), lowrank_matmul(x, A, B))


# prompt rows at every call size the engine gives them: alone, in chunks, in micro-batches
PREFILL_M = (1, 3, 8, 16, 64, 256, 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,r,N", [(2048, 615, 8192), (8192, 615, 2048), (2048, 154, 512), (3072, 922, 9216)])
def test_gpu_lowrank_matmul_prefill_rows_batch_invariant(cuda, K, r, N, dtype):
    """A prompt row's bits do not depend on the call's M: the rows that calls
    of M 1-1024 (``prefill=True``, at row offsets 0 and 8) share with one
    1032-row call are torch.equal to it, on tiles that change with M (llama's
    w_gate: 128 x 64 up to M 256, then 128 x 256 and 256 x 160) and one K
    split; each call also within tolerance of the plain version."""
    x = _rand((1032, K), 46, dtype, cuda)
    A, B = aligned_rows(_rand((K, r), 47, dtype, cuda)), aligned_rows(_rand((r, N), 48, dtype, cuda))
    full = lowrank_matmul(x, A, B, prefill=True)
    for M in PREFILL_M:
        for off in (0, 8):
            part = lowrank_matmul(x[off:off + M], A, B, prefill=True)
            assert torch.equal(part, full[off:off + M]), (M, off)
        _close(part, ref.lowrank_matmul_ref(x[8:8 + M], A, B), GEMM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.5, 0.25, 1e-6])
def test_gpu_lowrank_sliced_tiers_read_in_place(cuda, frac, dtype):
    """A rank tier's factors are prefix views of the stored ones
    (``core.lowrank.slice_rank``): both low-rank kernels take them in place,
    nothing copied for TMA (the 2-D A's column slice keeps its padded row
    stride; the batched B keeps its expert stride r x N), and match their
    plain versions at decode and prefill M."""
    from repro_torch.core.lowrank import lowrank_params, slice_rank

    K, r, N, E = 512, 154, 320, 4
    leaf = lowrank_params(_rand((K, r), 50, dtype, cuda), _rand((r, N), 51, dtype, cuda))
    stack = lowrank_params(_rand((2, E, K, r), 52, dtype, cuda), _rand((2, E, r, N), 53, dtype, cuda))
    tier = slice_rank({"w": leaf, "experts": stack}, frac)
    A, B = tier["w"]["a"], tier["w"]["b"]
    k = A.shape[-1]
    assert k == max(1, min(r, math.ceil(frac * r)))
    assert A.data_ptr() == leaf["a"].data_ptr() and B.data_ptr() == leaf["b"].data_ptr()
    before = ALIGN_COPIES.count
    for M in (1, 8, 70):
        x = _rand((M, K), 54, dtype, cuda)
        for prefill in (False, True):
            _close(lowrank_matmul(x, A, B, prefill=prefill), ref.lowrank_matmul_ref(x, A, B), GEMM_TOL[dtype])
    for layer in range(2):
        SA, SB = tier["experts"]["a"][layer], tier["experts"]["b"][layer]
        assert SB.stride(0) == stack["b"].stride(1)  # the expert stride of the stored rank
        x = _rand((E, 64, K), 55 + layer, dtype, cuda)
        _close(lowrank_matmul_batched(x, SA, SB), ref.lowrank_matmul_ref(x, SA, SB), GEMM_TOL[dtype])
    assert ALIGN_COPIES.count == before


def _capacity_rows(E, C, K, counts, seed, device, dtype="bfloat16", negative_zero=False):
    """An (E, C, K) MoE capacity buffer: expert e's first counts[e] rows hold
    values, the rest exact zeros (-0.0 where ``negative_zero``, as 0 x a
    negative value gives); and the same buffer with every row filled."""
    full = _rand((E, C, K), seed, dtype, device)
    live = torch.arange(C, device=device)[None, :] < torch.as_tensor(counts, device=device)[:, None]
    zero = torch.zeros((), dtype=full.dtype, device=device)
    sparse = torch.where(live[..., None], full, -zero if negative_zero else zero)
    return sparse, full, live


def _phi_decode_counts(E=16, slots=8, top_k=2, seed=0, skewed=False):
    """Assignments per expert at phi3.5-moe's decode occupancy: 8 slots x top-2
    distinct experts drawn with numpy (seed 0), or all on two experts."""
    if skewed:
        counts = np.zeros(E, dtype=np.int64)
        counts[[3, 11]] = slots
        return counts
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(E, size=top_k, replace=False) for _ in range(slots)])
    return np.bincount(ids.reshape(-1), minlength=E)


@pytest.mark.gpu
@pytest.mark.parametrize("occupancy", ["decode", "skewed", "full"])
def test_gpu_lowrank_matmul_batched_phi_decode(cuda, occupancy):
    """The batched kernel at phi3.5-moe's decode w_gate (16 experts x C 128,
    4096 -> 1229 -> 6400, one layer's view of a row-padded leaf) at three
    occupancies, against its plain version; rows past each count are zero
    in both."""
    E, C, K, r, N = 16, 128, 4096, 1229, 6400
    counts = np.full(E, C) if occupancy == "full" else _phi_decode_counts(skewed=occupancy == "skewed")
    x, _, live = _capacity_rows(E, C, K, counts, 46, cuda)
    A = aligned_rows(_rand((1, E, K, r), 47, "bfloat16", cuda))[0]
    B = aligned_rows(_rand((1, E, r, N), 48, "bfloat16", cuda))[0]
    before = ALIGN_COPIES.count
    got = lowrank_matmul_batched(x, A, B)
    assert ALIGN_COPIES.count == before
    want = ref.lowrank_matmul_ref(x, A, B)
    _close(got, want, GEMM_TOL["bfloat16"])
    assert bool((got[~live] == 0).all()) and bool((want[~live] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("negative_zero", [False, True])
@pytest.mark.parametrize("L,C,K,r,N", [(16, 128, 4096, 1229, 6400), (6, 320, 512, 154, 320), (4, 128, 250, 37, 96)])
def test_gpu_lowrank_matmul_batched_skips_zero_rows(cuda, L, C, K, r, N, negative_zero):
    """Tiles with no live row are skipped: the live rows of a call in which
    the other rows are zero equal, bit for bit, the same rows of a call in
    which every row is live, and the zero rows come out exactly zero."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 3, size=L)
    counts[0], counts[-1] = 0, C  # an empty expert and a full one
    sparse, full, live = _capacity_rows(L, C, K, counts, 49, cuda, negative_zero=negative_zero)
    A, B = aligned_rows(_rand((L, K, r), 50, "bfloat16", cuda)), aligned_rows(_rand((L, r, N), 51, "bfloat16", cuda))
    y_sparse, y_full = lowrank_matmul_batched(sparse, A, B), lowrank_matmul_batched(full, A, B)
    assert torch.equal(y_sparse[live], y_full[live])
    assert bool((y_sparse[~live] == 0).all())
    _close(y_sparse, ref.lowrank_matmul_ref(sparse, A, B), GEMM_TOL["bfloat16"])


@pytest.mark.gpu
def test_gpu_lowrank_matmul_batched_deterministic_and_graph_replay(cuda):
    """Two launches give the same bits, and a CUDA graph captured around one
    call replays, after the routing changed in place (other live experts,
    none, all), what an eager call on the same inputs returns: the plan
    depends on the shapes alone and liveness is found on the device."""
    from repro_torch.kernels import lowrank_matmul_batched as batched_mod

    E, C, K, r, N = 16, 128, 4096, 1229, 6400
    x, full, _ = _capacity_rows(E, C, K, _phi_decode_counts(), 52, cuda)
    A = aligned_rows(_rand((E, K, r), 53, "bfloat16", cuda))
    B = aligned_rows(_rand((E, r, N), 54, "bfloat16", cuda))
    assert torch.equal(lowrank_matmul_batched(x, A, B), lowrank_matmul_batched(x, A, B))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lowrank_matmul_batched(x, A, B)
    graph = torch.cuda.CUDAGraph()
    captured = batched_mod.KERNEL.captured
    with torch.cuda.graph(graph, stream=side):
        out = lowrank_matmul_batched(x, A, B)
    assert batched_mod.KERNEL.captured == captured + 1
    for counts in (_phi_decode_counts(seed=3), _phi_decode_counts(skewed=True), np.zeros(E), np.full(E, C)):
        live = torch.arange(C, device=cuda)[None, :] < torch.as_tensor(counts, device=cuda)[:, None]
        x.copy_(torch.where(live[..., None], full, torch.zeros((), dtype=full.dtype, device=cuda)))
        graph.replay()
        assert torch.equal(out, lowrank_matmul_batched(x, A, B))


def _holes(B, S, device, seed=0):
    """A (B, S) mask with fully-masked 16-position tiles between live ones
    (the kernel skips those tiles), ragged live tiles, and a fully-masked
    last row."""
    rng = np.random.default_rng(seed)
    tile_live = rng.random((B, -(-S // 16))) < 0.4
    tile_live[:, 0] = True
    m = np.repeat(tile_live, 16, axis=1)[:, :S] & (rng.random((B, S)) < 0.7)
    m[:, 0] = True
    m[-1] = False
    return torch.from_numpy(m).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["prefix", "holes"])
@pytest.mark.parametrize("S,G,hd,vd", [(45, 4, 64, 64), (200, 1, 64, 64), (300, 8, 64, 64), (260, 4, 128, 128),
                                       (150, 4, 80, 80), (200, 4, 128, 64), (120, 2, 64, 128), (300, 3, 64, 64),
                                       (300, 6, 64, 64), (1100, 4, 64, 64), (1100, 1, 128, 128), (90, 16, 16, 16),
                                       (70, 2, 32, 320)])
def test_gpu_decode_attention(cuda, S, G, hd, vd, mask, dtype):
    """The flat kernel against its plain version: hd 80 (a half mma step),
    vd != hd, G = 1, 2, 3, 4, 6, 8 and 16 (two head chunks), vd 320 (two
    feature chunks), S = 1100 (more 64-position splits than one cluster
    holds: warps walk several tiles); a prefix mask, and a mask with
    fully-masked tiles between live ones.  The last row is fully masked."""
    B, KV = 3, 2
    q, k, v = (_rand(s, 6 + i, dtype, cuda) for i, s in enumerate([(B, 1, KV * G, hd), (B, S, KV, hd),
                                                                      (B, S, KV, vd)]))
    if mask == "prefix":
        valid = torch.arange(S, device=cuda)[None, :] < torch.tensor([[S], [S // 3], [0]], device=cuda)
    else:
        valid = _holes(B, S, cuda)
    got = decode_attention(q, k, v, valid)
    assert tuple(got.shape) == (B, 1, KV * G, vd)
    _close(got, ref.decode_attention_ref(q, k, v, valid), ATTN_TOL[dtype])
    assert bool((got[2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["prefix", "holes"])
@pytest.mark.parametrize("S,G,hd,vd", [(45, 4, 64, 64), (300, 8, 64, 64), (150, 4, 80, 80), (90, 16, 16, 16),
                                       (70, 2, 32, 320), (2048, 4, 64, 64)])
def test_gpu_decode_attention_lse(cuda, S, G, hd, vd, mask, dtype):
    """The lse variant (the tensor-parallel decode's combine reads it)
    against its plain version: the output as the kernel without the flag
    gives it, bit for bit, and each head's fp32 log-sum-exp within 1e-4
    (fp32 scores) or 2e-2 (bf16 q and K rounded before their product),
    absolute; a fully-masked row gives -inf.  Two halves of the cache's
    slots, attended apart and combined by their lse, give the whole's
    output within the attention tolerance."""
    B, KV = 3, 2
    q, k, v = (_rand(s, 6 + i, dtype, cuda) for i, s in enumerate([(B, 1, KV * G, hd), (B, S, KV, hd),
                                                                      (B, S, KV, vd)]))
    if mask == "prefix":
        valid = torch.arange(S, device=cuda)[None, :] < torch.tensor([[S], [S // 3], [0]], device=cuda)
    else:
        valid = _holes(B, S, cuda)
    out, lse = decode_attention(q, k, v, valid, return_lse=True)
    assert torch.equal(out, decode_attention(q, k, v, valid))
    want_out, want_lse = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
    _close(out, want_out, ATTN_TOL[dtype])
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, KV * G)
    assert bool(torch.isneginf(lse[2]).all()) and bool(torch.isneginf(want_lse[2]).all())
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert float((lse[:2] - want_lse[:2]).abs().max()) <= tol
    h = S // 2
    parts = [decode_attention(q, k[:, sl].contiguous(), v[:, sl].contiguous(), valid[:, sl].contiguous(),
                              return_lse=True) for sl in (slice(0, h), slice(h, S))]
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(l - m) for _, l in parts]
    num = sum(o.float() * wi[:, None, :, None] for (o, _), wi in zip(parts, w))
    comb = num / (w[0] + w[1])[:, None, :, None]
    _close(comb[:2].to(out.dtype), want_out[:2], ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,q_offset,hd", [(70, None, 0, 64), (128, 32, 0, 64), (40, None, 24, 64),
                                                  (200, None, 0, 128), (70, None, 16, 128)])
def test_gpu_flash_attention(cuda, S, window, q_offset, hd, dtype):
    B, H, KV = 2, 8, 2
    q = _rand((B, S, H, hd), 9, dtype, cuda)
    k, v = _rand((B, S + q_offset, KV, hd), 10, dtype, cuda), _rand((B, S + q_offset, KV, hd), 11, dtype, cuda)
    got = flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 4, 6, 8])
@pytest.mark.parametrize("S", [70, 200])  # not multiples of the 64-row tile
def test_gpu_flash_attention_bf16_tiles(cuda, S, G, hd):
    """The bf16 kernel at every head dim and at G = 1, 3, 4, 6, 8, causal.  A
    64-row tile packs 64 / GP positions of GP heads, GP the largest power of
    two dividing G: G itself at 1, 4, 8; at 3 and 6 (GP 1 and 2) a KV head's
    group spans 3 blocks."""
    B, KV = 2, 2
    q = _rand((B, S, KV * G, hd), 30, "bfloat16", cuda)
    k, v = _rand((B, S, KV, hd), 31, "bfloat16", cuda), _rand((B, S, KV, hd), 32, "bfloat16", cuda)
    _close(flash_attention(q, k, v, causal=True), ref.chunked_attention_ref(q, k, v, causal=True),
           ATTN_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("G,hd", [(1, 64), (4, 128), (8, 64)])
def test_gpu_flash_attention_q_offset(cuda, G, hd, window, dtype):
    """A chunk of 70 queries at q_offset 230 over a 300-position cache (Skv > Sq)."""
    B, KV, Sq, Skv = 2, 2, 70, 300
    q = _rand((B, Sq, KV * G, hd), 33, dtype, cuda)
    k, v = _rand((B, Skv, KV, hd), 34, dtype, cuda), _rand((B, Skv, KV, hd), 35, dtype, cuda)
    got = flash_attention(q, k, v, causal=True, window=window, q_offset=Skv - Sq)
    want = ref.chunked_attention_ref(q, k, v, causal=True, window=window, q_offset=Skv - Sq)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,q_offset", [(256, None, 0), (200, 48, 0), (70, None, 230), (70, 48, 230),
                                               (5000, 4096, 0)])
def test_gpu_flash_attention_hd80(cuda, S, window, q_offset, dtype):
    """h2o-danube's head dim 80 (five 32-byte swizzle chunks a row, an n80
    wgmma) at its 32/8 heads: the static prefill's (4, 256), a ragged
    windowed prompt, a chunk at q_offset over a longer cache, and a prompt
    past the 4096 window (one batch row), whose blocks skip the key tiles
    before their reach."""
    B = 1 if S > 1000 else 4
    H, KV, hd = 32, 8, 80
    q = _rand((B, S, H, hd), 40, dtype, cuda)
    k, v = _rand((B, S + q_offset, KV, hd), 41, dtype, cuda), _rand((B, S + q_offset, KV, hd), 42, dtype, cuda)
    got = flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset)
    _close(got, want, ATTN_TOL[dtype])
    assert torch.equal(got, flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset))


# the non-causal shapes of cross-attention and whisper's encoder (batch cut where the
# sequence is long): (B, Sq, Skv, H = KV, head_dim)
NONCAUSAL = {"whisper_encoder": (1, 1500, 1500, 12, 64), "whisper_cross_prefill": (2, 70, 1500, 12, 64),
             "whisper_cross_decode": (8, 1, 1500, 12, 64), "vlm_cross_prefill": (2, 70, 1600, 32, 128),
             "vlm_cross_decode": (8, 1, 1600, 32, 128), "one_key": (2, 64, 1, 12, 64),
             "one_key_past_a_tile": (2, 64, 65, 12, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(NONCAUSAL))
def test_gpu_flash_attention_noncausal(cuda, shape, dtype):
    """The non-causal path (cross-attention, whisper's encoder) at G = 1:
    1500 and 1600 keys (the last key tile partly out of range), one query
    (one live row of a 64-row tile), one key and 65; two launches give the
    same bits."""
    B, Sq, Skv, H, hd = NONCAUSAL[shape]
    q = _rand((B, Sq, H, hd), 60, dtype, cuda)
    k, v = _rand((B, Skv, H, hd), 61, dtype, cuda), _rand((B, Skv, H, hd), 62, dtype, cuda)
    got = flash_attention(q, k, v, causal=False)
    _close(got, ref.chunked_attention_ref(q, k, v, causal=False), ATTN_TOL[dtype])
    assert torch.equal(got, flash_attention(q, k, v, causal=False))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["whisper_cross_decode", "vlm_cross_decode"])
def test_gpu_flash_attention_cross_decode_graph_replay(cuda, shape, dtype):
    """Cross-attention at decode as the engine's captured block runs it: one
    flash launch captured over a fixed query buffer and fixed keys, replayed
    after new queries (and new keys) were copied in place, equals an eager
    launch on the same inputs bit for bit."""
    from repro_torch.kernels import flash_attention as flash_mod

    B, Sq, Skv, H, hd = NONCAUSAL[shape]
    q = _rand((B, Sq, H, hd), 63, dtype, cuda)
    k, v = _rand((B, Skv, H, hd), 64, dtype, cuda), _rand((B, Skv, H, hd), 65, dtype, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention(q, k, v, causal=False)  # build and warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = flash_mod.KERNEL.captured
    with torch.cuda.graph(graph, stream=side):
        out = flash_attention(q, k, v, causal=False)
    assert flash_mod.KERNEL.captured == captured + 1  # one launch a call
    for seed in range(3):
        q.copy_(_rand((B, Sq, H, hd), 70 + seed, dtype, cuda))
        if seed == 2:
            k.copy_(_rand((B, Skv, H, hd), 80, dtype, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_attention(q, k, v, causal=False))
        _close(out, ref.chunked_attention_ref(q, k, v, causal=False), ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,q_offset", [(4, 256, 128, 0), (2, 70, 16, 230), (1, 200, 16, 0)])
def test_gpu_flash_attention_mla(cuda, B, S, H, q_offset, dtype):
    """deepseek-v2's MLA prefill: q/k head dim 192 (nope 128 + rope 64), v
    head dim 128, one query head a KV head (G 1): the static prefill's (4,
    256) at all 128 heads, a chunk at q_offset over a longer cache, and a
    ragged prompt; the output takes v's head dim, the scale q's; two launches
    give the same bits.  Any other (q/k, v) pair raises."""
    q = _rand((B, S, H, 192), 50, dtype, cuda)
    k = _rand((B, S + q_offset, H, 192), 51, dtype, cuda)
    v = _rand((B, S + q_offset, H, 128), 52, dtype, cuda)
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    assert tuple(got.shape) == (B, S, H, 128) and got.dtype == q.dtype
    _close(got, ref.chunked_attention_ref(q, k, v, causal=True, q_offset=q_offset), ATTN_TOL[dtype])
    assert torch.equal(got, flash_attention(q, k, v, causal=True, q_offset=q_offset))
    for qd, vd in ((192, 64), (128, 64), (96, 96)):
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q[..., :qd].contiguous(), k[..., :qd].contiguous(), v[..., :vd].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("proj", ["w_gate", "w_down"])
@pytest.mark.parametrize("occupancy", ["decode", "full"])
def test_gpu_lowrank_matmul_batched_deepseek(cuda, occupancy, proj):
    """The batched kernel over one deepseek-v2 layer's 160 experts x C 128
    (the capacity floor) at rank 461: w_gate 5120 -> 1536, w_down 1536 ->
    5120, with every capacity row live, and at the decode occupancy (8
    tokens x top-6 distinct experts, numpy seed 0), against its plain
    version; rows past each count are zero in both."""
    E, C, r = 160, 128, 461
    K, N = (5120, 1536) if proj == "w_gate" else (1536, 5120)
    counts = np.full(E, C) if occupancy == "full" else _phi_decode_counts(E=E, slots=8, top_k=6)
    x, _, live = _capacity_rows(E, C, K, counts, 53, cuda)
    A = aligned_rows(_rand((1, E, K, r), 54, "bfloat16", cuda))[0]
    B = aligned_rows(_rand((1, E, r, N), 55, "bfloat16", cuda))[0]
    got = lowrank_matmul_batched(x, A, B)
    want = ref.lowrank_matmul_ref(x, A, B)
    _close(got, want, GEMM_TOL["bfloat16"])
    assert bool((got[~live] == 0).all()) and bool((want[~live] == 0).all())
    assert torch.equal(got, lowrank_matmul_batched(x, A, B))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_decode_attention_wrapped_ring_hd80(cuda, dtype):
    """The decode over h2o-danube's ring once it has wrapped: 8 slots of 4096
    positions, every slot valid (the prefix mask of n_valid = min(pos + 1,
    W) = W), 32/8 heads at head dim 80; and a ring still filling beside it."""
    B, W, H, KV, hd = 8, 4096, 32, 8, 80
    q = _rand((B, 1, H, hd), 43, dtype, cuda)
    k, v = _rand((B, W, KV, hd), 44, dtype, cuda), _rand((B, W, KV, hd), 45, dtype, cuda)
    for n_valid in ([W] * B, [W, W, 1, 4095, W, 100, W, 0]):
        valid = torch.arange(W, device=cuda)[None, :] < torch.tensor(n_valid, device=cuda)[:, None]
        got = decode_attention(q, k, v, valid)
        _close(got, ref.decode_attention_ref(q, k, v, valid), ATTN_TOL[dtype])
        assert torch.equal(got, decode_attention(q, k, v, valid))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_row_masked_in_first_tile(cuda, dtype):
    """At G = 1 a block holds positions 64-127; with window 16 its first key
    tile (0-63) is fully masked for the rows past position 78, whose state
    (m = -1e30) the next tile's correction factor must zero, not turn NaN."""
    B, H, S, hd = 1, 2, 128, 64
    q, k, v = (_rand((B, S, H, hd), 36 + i, dtype, cuda) for i in range(3))
    got = flash_attention(q, k, v, causal=True, window=16)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, ref.chunked_attention_ref(q, k, v, causal=True, window=16), ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "paged_decode_attention"])
@pytest.mark.parametrize("G,hd", [(4, 64), (4, 128), (1, 64)])
def test_gpu_flash_attention_deterministic(cuda, G, hd, kernel):
    """Two launches on the same inputs give the same bits (the engine's graph ==
    eager gates rely on it): the flash kernel at the main path's (4, 256)
    shapes, the decode kernels at the engine's 8 slots x 640 positions (their
    cluster combines its partials in rank order)."""
    if kernel == "flash_attention":
        B, S, KV = 4, 256, 32 // G
        q = _rand((B, S, 32, hd), 39, "bfloat16", cuda)
        k, v = _rand((B, S, KV, hd), 40, "bfloat16", cuda), _rand((B, S, KV, hd), 41, "bfloat16", cuda)
        assert torch.equal(flash_attention(q, k, v, causal=True), flash_attention(q, k, v, causal=True))
        return
    q, k, v, bt, n_valid = _paged_case(64, 10, G, "bfloat16", cuda, hd=hd)
    if kernel == "paged_decode_attention":
        fn = lambda: paged_decode_attention(q, k, v, bt, n_valid)  # noqa: E731
    else:
        flat_k, flat_v = ref.gather_pages(k, bt), ref.gather_pages(v, bt)
        valid = torch.arange(flat_k.shape[1], device=cuda)[None, :] < n_valid[:, None]
        fn = lambda: decode_attention(q, flat_k, flat_v, valid)  # noqa: E731
    assert torch.equal(fn(), fn())


def _ssd_inputs(B, L, nh, hd, s, dtype, device, seed=20):
    """Raw x, dt after softplus (fp32), B/C and a negative A as the model
    makes them (A = -exp(log(linspace(1, 16, nh))))."""
    rng = np.random.default_rng(seed)
    x = _rand((B, L, nh, hd), seed, dtype, device)
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((B, L, nh)).astype(np.float32))).to(device)
    Bm, Cm = _rand((B, L, s), seed + 1, dtype, device), _rand((B, L, s), seed + 2, dtype, device)
    A = -torch.linspace(1.0, 16.0, nh, device=device)
    return x, dt, Bm, Cm, A


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("round_xbar", [False, True])
@pytest.mark.parametrize("B,L,nh,hd,s", [(1, 512, 64, 64, 64), (4, 256, 64, 64, 64), (1, 509, 24, 64, 128),
                                         (2, 40, 24, 64, 128), (3, 97, 4, 16, 16), (2, 200, 5, 32, 100),
                                         (1, 1, 2, 16, 8)])
def test_gpu_ssd_scan(cuda, B, L, nh, hd, s, round_xbar, dtype):
    """y and the final state against the plain chunked version (the
    reference's chunk rule: a prime L falls to Q = 1 there), under both x̄
    contracts; in fp32 also against the sequential oracle."""
    x, dt, Bm, Cm, A = _ssd_inputs(B, L, nh, hd, s, dtype, cuda)
    y, state = ssd_scan(x, dt, Bm, Cm, A, chunk=256, round_xbar=round_xbar)
    assert y.dtype == x.dtype and state.dtype == torch.float32 and tuple(state.shape) == (B, nh, hd, s)
    want_y, want_s = ref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=256, round_xbar=round_xbar)
    _close(y, want_y, GEMM_TOL[dtype])
    _close(state, want_s, 1e-4)
    if dtype == "float32" and L <= 256:
        seq_y, seq_s = ref.ssd_scan_ref(ref.ssd_xbar(x, dt, round_xbar), dt, Bm, Cm, A)
        _close(y, seq_y, 1e-4)
        _close(state, seq_s, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,nh,hd,s", [(1, 512, 64, 64, 64), (1, 512, 24, 64, 128), (2, 97, 4, 64, 256)])
def test_gpu_ssd_scan_deterministic(cuda, B, L, nh, hd, s, dtype):
    """Two calls on the same inputs return the same bits (a fixed summation
    order, no atomics), under both x̄ contracts."""
    x, dt, Bm, Cm, A = _ssd_inputs(B, L, nh, hd, s, dtype, cuda)
    for round_xbar in (True, False):
        y1, s1 = ssd_scan(x, dt, Bm, Cm, A, round_xbar=round_xbar)
        y2, s2 = ssd_scan(x, dt, Bm, Cm, A, round_xbar=round_xbar)
        assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("round_xbar", [False, True])
@pytest.mark.parametrize("case,B,L,nh,hd,s,dt_scale", [
    ("long", 1, 2048, 64, 64, 64, 1.0),  # 32 chunks of state carry
    ("long", 1, 2048, 24, 64, 128, 1.0),
    ("steep", 2, 300, 8, 64, 128, 5.0),  # dt |A| ~3-60 a step on average: exp(l) underflows inside a chunk
    ("steep", 1, 130, 4, 32, 256, 5.0),
])
def test_gpu_ssd_scan_long_and_steep(cuda, case, B, L, nh, hd, s, dt_scale, round_xbar, dtype):
    """A long sequence (the state carried over 32 chunks), and steep decay
    (the scores' t < u half, l_t - l_u > 0, would overflow if it were
    exponentiated before the mask): finite, and within the tolerances of
    test_gpu_ssd_scan."""
    x, dt, Bm, Cm, A = _ssd_inputs(B, L, nh, hd, s, dtype, cuda)
    dt = dt * dt_scale
    y, state = ssd_scan(x, dt, Bm, Cm, A, chunk=256, round_xbar=round_xbar)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(state).all())
    want_y, want_s = ref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=256, round_xbar=round_xbar)
    _close(y, want_y, GEMM_TOL[dtype])
    _close(state, want_s, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,nh,hd,s", [(1, 130, 4, 64, 128), (2, 70, 3, 32, 100), (1, 64, 2, 64, 64)])
def test_gpu_ssd_scan_wide_tiles(cuda, B, L, nh, hd, s, dtype, monkeypatch):
    """The 32-column tile, which the plan takes where the call alone fills
    the card (as if the card had one SM): TMA boxes at s 64 and 128, element
    loads at s 100."""
    import repro_torch.kernels.ssd_scan as ssd_mod

    monkeypatch.setattr(ssd_mod, "sm_count", lambda index: 1)
    assert ssd_mod.ssd_plan(B, L, nh, hd, s, DTYPES[dtype], 1).cols == 32
    x, dt, Bm, Cm, A = _ssd_inputs(B, L, nh, hd, s, dtype, cuda)
    for round_xbar in (True, False):
        y, state = ssd_scan(x, dt, Bm, Cm, A, chunk=256, round_xbar=round_xbar)
        want_y, want_s = ref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=256, round_xbar=round_xbar)
        _close(y, want_y, GEMM_TOL[dtype])
        _close(state, want_s, 1e-4)


@pytest.mark.gpu
def test_gpu_ssd_scan_refuses_bad_operands(cuda):
    x, dt, Bm, Cm, A = _ssd_inputs(2, 8, 2, 16, 8, "bfloat16", cuda)
    with pytest.raises(ValueError, match="operands on"):
        ssd_scan(x, dt.cpu(), Bm, Cm, A)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, Bm.float(), Cm, A)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.bfloat16(), Bm, Cm, A)
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :4], Bm, Cm, A)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_scan(x[..., :8], dt, Bm, Cm, A)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(0, 1).contiguous().transpose(0, 1), dt, Bm, Cm, A)


def _paged_case(page, n_tbl, G, dtype, device, *, seed=12, hd=64, vd=None):
    """A pool with pages at permuted physical ids, a finite-poison trash page,
    ragged n_valid (crossing page boundaries) and one fully-masked row."""
    B, KV = 4, 2
    rng = np.random.default_rng(seed)
    P = B * n_tbl + 1
    q = _rand((B, 1, KV * G, hd), seed, dtype, device)
    k, v = _rand((P, page, KV, hd), seed + 1, dtype, device), _rand((P, page, KV, vd or hd), seed + 2, dtype, device)
    k[-1], v[-1] = 1e4, -1e4  # the trash page: finite poison, never attended
    bt = torch.from_numpy(rng.permutation(P - 1)[: B * n_tbl].reshape(B, n_tbl).astype(np.int32)).to(device)
    S = n_tbl * page
    n_valid = torch.tensor([S, max(1, S // 3 + 1), 0, page + 1 if page < S else S], dtype=torch.int32,
                           device=device)
    bt[1, -1] = P - 1  # a table entry past n_valid on the trash page
    return q, k, v, bt, n_valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page,n_tbl,G,hd,vd", [
    (1, 37, 4, 64, 64), (4, 9, 1, 64, 64), (16, 5, 4, 64, 64), (64, 3, 4, 64, 64), (128, 2, 8, 64, 64),
    (48, 3, 4, 64, 64), (64, 5, 4, 128, 128), (16, 9, 4, 128, 128),
    (64, 5, 4, 80, 80), (16, 9, 4, 128, 64), (32, 6, 2, 64, 128),  # hd 80; vd != hd
    (64, 5, 3, 64, 64), (32, 10, 6, 64, 64), (16, 8, 16, 16, 16),  # G = 3, 6, 16
    (1, 1100, 4, 64, 64), (48, 23, 4, 64, 64), (128, 9, 1, 128, 128),  # pages 1, 48, 128 past one cluster
])
def test_gpu_paged_decode_attention(cuda, page, n_tbl, G, hd, vd, dtype):
    """The paged kernel against its plain version (ragged n_valid: partly
    valid last tiles and splits, a table entry past n_valid on the trash
    page, one empty slot), at pages 1-128, hd 80, vd != hd, G = 1-16, and
    tables longer than one cluster's 32 warp tiles."""
    q, k, v, bt, n_valid = _paged_case(page, n_tbl, G, dtype, cuda, hd=hd, vd=vd)
    got = paged_decode_attention(q, k, v, bt, n_valid)
    assert tuple(got.shape) == (4, 1, 2 * G, vd)
    _close(got, ref.paged_decode_attention_ref(q, k, v, bt, n_valid), ATTN_TOL[dtype])
    assert bool((got[2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,hd", [(4, 64), (4, 128), (1, 64)])
def test_gpu_paged_decode_bitwise_equals_flat_at_page_64(cuda, dtype, G, hd):
    """At page 64 the paged kernel's tiles, their order and its arithmetic
    are the flat kernel's: on the same logical cache the outputs are equal
    bit for bit (hd 64 and 128, and G = 1)."""
    q, k, v, bt, n_valid = _paged_case(64, 10, G, dtype, cuda, hd=hd)
    flat_k, flat_v = ref.gather_pages(k, bt), ref.gather_pages(v, bt)
    valid = torch.arange(flat_k.shape[1], device=cuda)[None, :] < n_valid[:, None]
    got = paged_decode_attention(q, k, v, bt, n_valid)
    assert torch.equal(got, decode_attention(q, flat_k, flat_v, valid))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["decode_attention", "paged_decode_attention"])
def test_gpu_decode_graph_replay_equals_eager(cuda, kernel, dtype):
    """A CUDA graph captured around one decode launch, replayed after the
    mask or n_valid changed in place (more and fewer live tiles, an empty
    slot, a full one), returns what an eager launch on the same inputs
    returns, bit for bit: the grid depends on the shapes alone and the
    kernel reads the mask and the table at run time."""
    from repro_torch.kernels import decode_attention as flat_mod
    from repro_torch.kernels import paged_decode_attention as paged_mod

    q, k, v, bt, n_valid = _paged_case(64, 10, 4, dtype, cuda, hd=64)
    S = bt.shape[1] * 64
    flat_k, flat_v = ref.gather_pages(k, bt), ref.gather_pages(v, bt)
    valid = torch.arange(S, device=cuda)[None, :] < n_valid[:, None]
    if kernel == "paged_decode_attention":
        fn, lib = (lambda: paged_decode_attention(q, k, v, bt, n_valid)), paged_mod.KERNEL  # noqa: E731
    else:
        fn, lib = (lambda: decode_attention(q, flat_k, flat_v, valid)), flat_mod.KERNEL  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # build and warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = lib.captured
    with torch.cuda.graph(graph):
        out = fn()
    assert lib.captured == captured + 1  # one launch a call
    for nv in ([S, 1, 0, 65], [17, S, 300, 0], [0, 0, 0, 0], [S, S, S, S], [64, 63, 129, 640]):
        n_valid.copy_(torch.tensor(nv, dtype=torch.int32))
        valid.copy_(torch.arange(S, device=cuda)[None, :] < n_valid[:, None])
        valid[1, 5:200] = False  # fully-masked tiles between live ones (the flat kernel's mask only)
        if kernel == "paged_decode_attention":
            valid.copy_(torch.arange(S, device=cuda)[None, :] < n_valid[:, None])
        graph.replay()
        assert torch.equal(out, fn())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "mamba2-130m",
                                  "h2o-danube-1.8b", "llama-3.2-vision-11b", "whisper-small"])
@pytest.mark.parametrize("page_size,chunk", [(None, None), (4, 5)])
def test_gpu_engine_graph_equals_eager(cuda, page_size, chunk, arch):
    """The captured decode block (greedy and sampled variants, one request of
    each kind per engine) emits what the same body run eagerly emits.  The
    reduced phi3.5-moe runs RSI-compressed, so its expert stacks go through
    the batched kernel, inside the graph as well.  The ssm and hybrid
    families prefill through the SSD scan kernel (the chunk is inert there)
    and decode their recurrent state inside the graph.  The vlm and audio
    requests carry their own image or frames, and their cross-attention
    runs the flash kernel at Sq = 1 inside the graph."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.data.synthetic import modality_extras
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import lowrank_matmul_batched as batched_mod
    from repro_torch.kernels import paged_decode_attention as paged_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.model import build_model
    from repro_torch.serving import Engine, Request, SamplingParams

    model = build_model(get_arch(arch, reduced=True), device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    moe = model.cfg.family == "moe"
    if moe:
        params, _ = compress_tree(params, CompressionPolicy(alpha=0.3, q=2, min_dim=16),
                                  generator=torch.Generator(device=cuda).manual_seed(1))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in (9, 4, 12)]
    sampling = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20, seed=5), SamplingParams(seed=1)]
    out = {}
    for graph in (True, False):
        eng = Engine(model, params, n_slots=2, max_len=24, page_size=page_size, prefill_chunk=chunk,
                     decode_block=4, cuda_graph=graph)
        before = paged_mod.KERNEL.launches
        before_batched = batched_mod.KERNEL.launches
        before_ssd = ssd_mod.KERNEL.launches
        before_flash = flash_mod.KERNEL.launches
        extras = [modality_extras(model.cfg, np.random.default_rng(i)) for i in range(len(prompts))]
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=10, sampling=s, extras=e))
                for p, s, e in zip(prompts, sampling, extras)]
        while eng.has_work:
            eng.step()
        assert all(r.status == "ok" and len(r.tokens) == 10 for r in reqs)
        assert (eng.graph_replays > 0) == graph
        if page_size is not None and model.cfg.family != "ssm" and model.cfg.sliding_window is None:
            assert paged_mod.KERNEL.launches > before
        if model.cfg.family in ("ssm", "hybrid"):
            assert ssd_mod.KERNEL.launches == before_ssd + model.cfg.n_layers * len(eng.prefill_batches)
        if moe:
            assert batched_mod.KERNEL.launches > before_batched
        if model.cfg.family in ("vlm", "audio"):  # the prefill's calls and every decode step's
            assert flash_mod.KERNEL.launches > before_flash + eng.steps
        out[graph] = [r.tokens for r in reqs]
    assert out[True] == out[False]


@pytest.mark.gpu
@pytest.mark.parametrize("page_size", [None, 4])
def test_gpu_engine_swa_ring_wraps_graph_equals_eager(cuda, page_size):
    """Reduced h2o-danube (window 32) with prompts below, at and past the
    window and 30 new tokens each, so every ring wraps inside the captured
    block: graph tokens == eager tokens, each request's tokens those of
    greedy_generate alone, the flash kernel launched with the window and the
    flat decode kernel over the ring (no page reserved)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models.model import build_model
    from repro_torch.runtime import dispatch
    from repro_torch.serving import Engine, Request
    from repro_torch.train.serve_step import greedy_generate

    model = build_model(get_arch("h2o-danube-1.8b", reduced=True), device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    W = model.cfg.sliding_window
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in (20, W, W + 9, W + 9, 3)]
    out = {}
    for graph in (True, False):
        eng = Engine(model, params, n_slots=4, max_len=W + 40, page_size=page_size, decode_block=4,
                     cuda_graph=graph)
        before = (flash_mod.KERNEL.launches, decode_mod.KERNEL.launches)
        dispatch.reset_counters()
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=30)) for p in prompts]
        while eng.has_work:
            eng.step()
        assert all(r.status == "ok" and len(r.tokens) == 30 for r in reqs)
        assert (eng.graph_replays > 0) == graph and eng.peak_pages_in_use == 0
        assert flash_mod.KERNEL.launches > before[0] and decode_mod.KERNEL.launches > before[1]
        assert all(k[2][3] == W for k in dispatch.counters() if k[0] == "flash_attention")
        out[graph] = [r.tokens for r in reqs]
    assert out[True] == out[False]
    for p, toks in zip(prompts, out[True]):
        batch = {"tokens": torch.as_tensor(p[None], device=cuda)}
        assert greedy_generate(model, params, batch, steps=30, max_len=W + 40)[0].tolist() == toks


@pytest.mark.gpu
def test_gpu_engine_capture_runs_with_the_cyclic_gc_off(cuda):
    """The decode block is captured with Python's cyclic garbage collector off
    (a dead engine's graph freed inside a capture invalidates it), and the
    collector is on again after it."""
    import gc

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serving import Engine, Request

    model = build_model(get_arch("llama3.2-1b", reduced=True), device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    eng = Engine(model, params, n_slots=2, max_len=24, decode_block=4, cuda_graph=True)
    seen = []
    body = eng._block_body

    def spy(tier, greedy):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return body(tier, greedy)

    eng._block_body = spy
    assert gc.isenabled()
    reqs = [eng.submit(Request(prompt=np.arange(1, n + 1), max_new_tokens=6)) for n in (5, 9)]
    while eng.has_work:
        eng.step()
    assert all(r.status == "ok" and len(r.tokens) == 6 for r in reqs)
    assert eng.graph_replays > 0 and seen == [False]
    assert gc.isenabled()


@pytest.mark.gpu
@pytest.mark.parametrize("poison", [False, True])
def test_gpu_engine_tiers_and_poison_under_the_graph(cuda, poison):
    """Engine stage 4 under the captured block (reduced llama3.2-1b, RSI at
    alpha 0.5): tiers (1.0, 0.5) at once give the eager run's tokens, with
    one capture per (tier, greedy); a nan_logits fault rides the packed
    state, so the armed engine captures the same graphs, errors the
    poisoned uid alone and leaves every other stream as the eager run's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving import Engine, FaultInjector, Request

    model = build_model(get_arch("llama3.2-1b", reduced=True), device=cuda)
    gen = torch.Generator(device=cuda)
    params, _ = compress_tree(model.init(gen.manual_seed(0)), CompressionPolicy(alpha=0.5, q=2, min_dim=16),
                              generator=gen.manual_seed(1))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, size=(n,)) for n in (5, 9, 7, 12)]

    def run(graph, armed):
        # the engine's global decode steps advance by a block per active tier:
        # two tiers make each engine step's window [8 k, 8 k + 4); step 9 lands
        # in the second engine step's tier-1 block, where uid 1 decodes
        inj = FaultInjector(nan_logits=(1, 9) if armed else None)
        eng = Engine(model, params, n_slots=4, max_len=40, page_size=4, decode_block=4, cuda_graph=graph,
                     tiers=(1.0, 0.5), injector=inj)
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=14, tier=i % 2)) for i, p in enumerate(prompts)]
        while eng.has_work:
            eng.step()
        return reqs, eng

    want, _ = run(False, False)
    got, eng = run(True, poison)
    assert sorted(eng._graphs) == [(0, True), (1, True)] and eng.graph_replays > 0
    for i, (a, b) in enumerate(zip(got, want)):
        if poison and i == 1:
            assert a.status == "error" and 0 < len(a.tokens) < 14 and a.tokens == b.tokens[: len(a.tokens)]
        else:
            assert a.status == "ok" and a.tokens == b.tokens


@pytest.mark.gpu
def test_gpu_engine_graph_capture_in_a_fresh_process(cuda):
    """The captured decode block's engine tests alone, in a fresh interpreter:
    nothing else of this file has captured a graph or used cuBLAS there
    first, which is where a capture on a stream the warm-up did not run on
    used to be invalidated."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_gpu.py", "-m", "gpu", "-q",
                          "-p", "no:cacheprovider", "-k", "engine_graph_equals_eager"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=1800)
    # exit 0: every selected test ran and passed (pytest exits 5 when it selects none)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-3000:]


@pytest.mark.gpu
def test_gpu_cluster_replicas_capture_concurrently_and_restart(cuda):
    """Two replicas of one reduced, compressed llama3.2-1b on the card, each
    stepped by its own thread on its own stream, capture their decode blocks
    as they first need them (one capture at a time, ``engine.GRAPH_LOCK``,
    in thread-local capture mode while the other replica runs): every root
    equals one engine's tokens.  Then replica 0 is killed at its third step
    and restarted while replica 1 serves; the restarted engine captures its
    own block and replays it, and every failed-over root resumes bit for bit
    (its credited prefix the single engine's, its tail a fresh engine's on
    the continuation)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.models.model import build_model
    from repro_torch.runtime.fault_tolerance import ReplicaKilled
    from repro_torch.serving import Cluster, Engine, FailoverBudget, FaultInjector, Request

    model = build_model(get_arch("llama3.2-1b", reduced=True), device=cuda)
    gen = torch.Generator(device=cuda)
    params, _ = compress_tree(model.init(gen.manual_seed(0)), CompressionPolicy(alpha=0.3, q=2, min_dim=16),
                              generator=gen.manual_seed(1))
    kw = dict(n_slots=2, max_len=48, page_size=8, prefill_chunk=8, decode_block=4, share_prefix=True)
    rng = np.random.default_rng(0)
    trace = [(rng.integers(0, model.cfg.vocab, size=int(rng.integers(4, 20))), int(rng.integers(10, 24)))
             for _ in range(10)]

    def build(items):
        return [Request(prompt=p.copy(), max_new_tokens=n) for p, n in items]

    def single(items):
        reqs = build(items)
        Engine(model, params, **kw).run(reqs)
        return [list(r.tokens) for r in reqs]

    refs = single(trace)
    inj = FaultInjector()
    clu = Cluster(lambda rid: Engine(model, params, **kw), 2, heartbeat_ms=60000.0, injector=inj,
                  budget=FailoverBudget(max_failovers=3, base_ms=10.0), probation_s=0.05, straggler_min_s=1e9)
    try:
        reqs = build(trace)
        clu.run(reqs, timeout_s=300.0)
        assert [list(r.tokens) for r in reqs] == refs
        assert all(r.eng.graph_replays > 0 for r in clu.replicas)

        for r in clu.replicas:
            r.eng.reset_prefix_cache()
        inj.kill_replica = (0, clu.replicas[0].step_count + 3)  # the local step count runs on across runs
        reqs = build(trace)
        clu.run(reqs, timeout_s=300.0)
        with clu.replicas[0].health_lock:
            assert isinstance(clu.replicas[0].step_error, ReplicaKilled)
        points = clu.stats()["resume_points"]
        assert points
        for i, r in enumerate(reqs):
            assert r.status == "ok"
            split = (points.get(r.uid) or [None])[0]
            if split is None:
                assert list(r.tokens) == refs[i]
                continue
            assert list(r.tokens)[:split] == refs[i][:split]
            cont = (np.concatenate([trace[i][0], np.asarray(r.tokens[:split], np.int64)]), trace[i][1] - split)
            assert list(r.tokens)[split:] == single([cont])[0]

        inj.kill_replica = None
        survivor, state = clu.replicas[1].eng, {"restarted": False, "late": False}
        late = build(trace[:2])

        def during():  # on the monitor thread: restart while replica 1 serves
            if not state["restarted"] and survivor.n_active > 0:
                clu.restart_replica(0)
                state["restarted"] = True
            elif state["restarted"] and not state["late"] and clu.replicas[0].state == "healthy":
                for r in late:
                    clu.submit(r)
                state["late"] = True
            return False

        survivor.reset_prefix_cache()
        more = build(trace[2:6])
        clu.run(more, stop=during, timeout_s=300.0)
        if not state["late"]:
            clu.run(late, timeout_s=300.0)
        assert state["restarted"] and clu.stats()["rejoins"] == 1
        assert [list(r.tokens) for r in more + late] == refs[2:6] + refs[:2]
        assert clu.replicas[0].eng.graph_replays > 0
    finally:
        clu.close()


# --------------------------------------------------------------------------- #
# the paper's experiments and the rest of the core on the card
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
def test_gpu_fig4_1_auto_matches_reference(cuda):
    """Fig 4.1 at its default 1024 x 6272, fp32: the sketch kernel (auto)
    against the plain GEMMs (reference) from the same Omegas (the same
    generator seeds on the card) and start vector: errors rtol 1e-3."""
    from repro_torch.experiments import fig4_1
    from repro_torch.kernels import sketch_matmul as sketch_mod
    from repro_torch.runtime.dispatch import use_dispatch

    before = sketch_mod.KERNEL.launches
    got = fig4_1.run(trials=1, qs=(1, 4), device=cuda)
    # a warm-up and one trial per cell, 2q sketch launches each
    assert sketch_mod.KERNEL.launches - before == sum(2 * 2 * q for q in (1, 4)) * 3
    with use_dispatch(backend="reference"):
        want = fig4_1.run(trials=1, qs=(1, 4), device=cuda)
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["k"], g["q"]) == (w["k"], w["q"])
        assert abs(g["normalized_error"] - w["normalized_error"]) <= 1e-3 * w["normalized_error"], (g, w)
        assert g["normalized_error"] >= 0.99
    for k in (50, 100, 200):
        by_q = {r["q"]: r["normalized_error"] for r in got["rows"] if r["k"] == k}
        assert by_q[4] < by_q[1]


@pytest.mark.gpu
def test_gpu_certify_head_matches_cpu(cuda):
    """A Theorem 3.2 certificate computed on the card equals the CPU's on
    the same inputs and start vector (fields rtol 1e-4: fp32 power method,
    summation order only)."""
    from repro_torch.core import certify_head, certify_tier, rsi_factors

    g = torch.Generator().manual_seed(0)
    W = torch.randn((10, 512), generator=g) * 0.3
    calib = torch.randn((2048, 512), generator=g)
    omega = torch.randn((512, 4), generator=g)
    v0 = torch.randn((512,), generator=g)
    certs = {}
    for dev in ("cpu", cuda):
        A, B = rsi_factors(W.to(dev), 4, 4, omega=omega)
        head = certify_head(W.to(dev), A @ B, calib.to(dev), rank=4, q=4, v0=v0)
        tier = certify_tier(A, B, 2, q=4, v0=v0)
        certs[str(dev)] = (head, tier)
    for (cpu_c, gpu_c) in zip(certs["cpu"], certs[str(cuda)]):
        for f in ("spectral_error", "feature_radius", "prob_deviation_bound"):
            np.testing.assert_allclose(getattr(gpu_c, f), getattr(cpu_c, f), rtol=1e-4)


@pytest.mark.gpu
def test_gpu_energy_rank_matches_cpu(cuda):
    """The energy rule's rank on the card equals the CPU's on a stated
    matrix (s_i = 2^(-i/16) on 256 x 1024, whose cumulative energy lies far
    from each threshold), and both equal the exact answer."""
    from repro_torch.core import CompressionPolicy, compress_tree, synth_spectrum_matrix

    s = 2.0 ** (-torch.arange(256, dtype=torch.float32) / 16.0)
    W = synth_spectrum_matrix(256, 1024, s, generator=torch.Generator().manual_seed(3))
    probe = (256 * 1024 - 1) // (256 + 1024)
    c2 = torch.cumsum(s[:probe].double() ** 2, 0)
    c2 = c2 / c2[-1]
    for energy in (0.6, 0.9, 0.97):
        assert float(torch.min(torch.abs(c2 - energy))) > 5e-4  # no rank within rounding of the threshold
        exact = int(torch.searchsorted(c2, torch.tensor([energy], dtype=torch.float64))[0]) + 1
        ranks = []
        for dev in ("cpu", cuda):
            pol = CompressionPolicy(rank_rule="energy", energy=energy, q=2, min_dim=8, break_even_only=False)
            _, rep = compress_tree({"w": W.to(dev)}, pol, generator=torch.Generator(device=dev).manual_seed(1))
            ranks.append(rep.layers[0].rank)
        assert ranks == [exact, exact], (energy, ranks, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,H", [(3, 24), (8, 64)])  # minitron-4b's 24/8 heads, qwen2-72b's 64/8
def test_gpu_flash_attention_dense_archs(cuda, G, H, dtype):
    """The prefill at minitron-4b's and qwen2-72b's heads, head_dim 128: G = 3
    packs one head a tile row block (GP = 1), G = 8 packs all eight."""
    B, S, hd = 2, 200, 128
    KV = H // G
    q = _rand((B, S, H, hd), 40, dtype, cuda)
    k, v = _rand((B, S, KV, hd), 41, dtype, cuda), _rand((B, S, KV, hd), 42, dtype, cuda)
    _close(flash_attention(q, k, v, causal=True), ref.chunked_attention_ref(q, k, v, causal=True), ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["decode_attention", "paged_decode_attention"])
def test_gpu_decode_attention_g3_hd128(cuda, kernel, dtype):
    """Flat and paged decode at minitron-4b's G = 3, head_dim 128, against the
    plain versions; at page 64 the paged kernel is the flat one bit for bit."""
    q, k, v, bt, n_valid = _paged_case(64, 10, 3, dtype, cuda, hd=128)
    flat_k, flat_v = ref.gather_pages(k, bt), ref.gather_pages(v, bt)
    valid = torch.arange(flat_k.shape[1], device=cuda)[None, :] < n_valid[:, None]
    flat = decode_attention(q, flat_k, flat_v, valid)
    if kernel == "decode_attention":
        _close(flat, ref.decode_attention_ref(q, flat_k, flat_v, valid), ATTN_TOL[dtype])
        return
    got = paged_decode_attention(q, k, v, bt, n_valid)
    _close(got, ref.paged_decode_attention_ref(q, k, v, bt, n_valid), ATTN_TOL[dtype])
    assert torch.equal(got, flat)


@pytest.mark.gpu
@pytest.mark.parametrize("graph", [True, False])
def test_gpu_engine_shared_prefix_equals_unshared(cuda, graph):
    """Reduced minitron-4b (G = 3) on the card, prefill chunk = the page, every
    prompt longer than one chunk: shared and unshared engines emit the same
    greedy tokens, with pages shared, a COW fork (a follower whose whole
    prompt is the indexed prefix) and a session follow-up that matches past
    its first prompt."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serving import Engine, Request

    model = build_model(get_arch("minitron-4b", reduced=True), device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    sys = rng.integers(0, 512, size=8)
    prompts = [np.concatenate([sys, rng.integers(0, 512, size=n)]) for n in (3, 6, 0)]
    extra = rng.integers(0, 512, size=5)
    out = {}
    for share in (False, True):
        eng = Engine(model, params, n_slots=3, max_len=40, page_size=4, prefill_chunk=4, decode_block=4,
                     share_prefix=share, cuda_graph=graph)
        first = eng.submit(Request(prompt=prompts[0], max_new_tokens=9))
        while not first.tokens:
            eng.step()
        rest = [eng.submit(Request(prompt=p, max_new_tokens=6)) for p in prompts[1:]]
        while eng.has_work:
            eng.step()
        follow = np.concatenate([prompts[0], np.asarray(first.tokens), extra])
        turn2 = eng.submit(Request(prompt=follow, max_new_tokens=5))
        while eng.has_work:
            eng.step()
        out[share] = [r.tokens for r in [first, *rest, turn2]]
        if share:
            assert eng.shared_page_hits > 0 and eng.cow_forks >= 1
            assert turn2.prefill_skipped > prompts[0].size
        assert eng.pages_in_use == 0
    assert out[True] == out[False]


# --------------------------------------------------------------------------- #
# training: the autograd Functions (kernel forward, plain backward) and the restart
# --------------------------------------------------------------------------- #
def _grad_pair(fn, inputs):
    """(outputs, input grads) of ``fn`` through the Functions (backend auto) and
    through the plain versions (backend reference), one shared cotangent."""
    from repro_torch.runtime.dispatch import use_dispatch

    res = []
    cot = None
    for backend in ("auto", "reference"):
        leaves = [t.detach().requires_grad_() for t in inputs]
        with use_dispatch(backend=backend):
            out = fn(*leaves)
        out = list(out) if isinstance(out, tuple) else [out]
        cot = cot or [torch.randn(o.shape, device=o.device, generator=torch.Generator(device=o.device).manual_seed(7),
                                  dtype=torch.float32).to(o.dtype) for o in out]
        res.append((out, torch.autograd.grad(out, leaves, cot)))
    return res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["lowrank", "lowrank_batched", "flash", "flash_window", "logits_tied", "ssd"])
def test_gpu_train_function_grads_match_plain(cuda, op, dtype):
    """Each training Function on the card against autograd through its plain
    version: outputs and gradients within the attention tolerance (bf16: the
    twins round d(xA) and ds to bf16 where plain autograd keeps fp32)."""
    import torch.nn.functional as F

    from repro_torch.core.lowrank import lowrank_params
    from repro_torch.runtime import dispatch

    dt = DTYPES[dtype]
    if op in ("lowrank", "lowrank_batched"):
        lead = (4,) if op == "lowrank_batched" else ()
        f = lowrank_params(_rand(lead + (256, 37), 1, dtype, cuda), _rand(lead + (37, 192), 2, dtype, cuda))
        args, fn = (_rand(lead + (96, 256), 0, dtype, cuda), f["a"], f["b"]), dispatch.lowrank_apply
    elif op.startswith("flash"):
        window = 24 if op == "flash_window" else None
        args = (_rand((2, 64, 8, 64), 3, dtype, cuda), _rand((2, 64, 2, 64), 4, dtype, cuda),
                _rand((2, 64, 2, 64), 5, dtype, cuda))
        fn = lambda q, k, v: dispatch.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
    elif op == "logits_tied":
        args, fn = (_rand((32, 256), 6, dtype, cuda), _rand((1000, 256), 7, dtype, cuda)), dispatch.logits_apply
    else:
        args = (_rand((2, 40, 4, 32), 8, dtype, cuda), _rand((2, 40, 4), 9, "float32", cuda),
                _rand((2, 40, 16), 10, dtype, cuda), _rand((2, 40, 16), 11, dtype, cuda),
                torch.log(torch.linspace(1.0, 8.0, 4, device=cuda)))
        fn = lambda x, d, b, c, a: dispatch.ssd_scan(x, F.softplus(d), b, c, -torch.exp(a), chunk=16,  # noqa: E731
                                                     round_xbar=True)
    (got, g_got), (want, g_want) = _grad_pair(fn, args)
    for a, b in zip(got + list(g_got), want + list(g_want)):
        _close(a, b, ATTN_TOL[dtype])
        assert a.dtype == b.dtype and bool(torch.isfinite(a.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_lse_leaves_out_unchanged(cuda, dtype):
    """The lse output is the plain forward's, and requesting it leaves the
    output's bits as they were."""
    q, k, v = (_rand((2, 96, 8, 64), 12, dtype, cuda), _rand((2, 96, 2, 64), 13, dtype, cuda),
               _rand((2, 96, 2, 64), 14, dtype, cuda))
    out, lse = flash_attention(q, k, v, causal=True, window=40, return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v, causal=True, window=40))
    _, want = ref.flash_fwd_ref(q, k, v, causal=True, window=40)
    _close(lse, want, 1e-4)


@pytest.mark.gpu
def test_gpu_train_restart_is_bitwise(cuda, tmp_path):
    """Reduced llama3.2-1b in bf16, compressed: a run failed at step 3 and
    resumed from the step-2 checkpoint ends on the bits of an uninterrupted
    four-step run (the embedding's backward sums in a fixed order)."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.runtime.fault_tolerance import TrainLoopRunner
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = get_arch("llama3.2-1b", reduced=True)
    model = build_model(cfg, device=cuda)
    g = lambda s: torch.Generator(device=cuda).manual_seed(s)  # noqa: E731
    params, _ = compress_tree(model.init(g(0)), CompressionPolicy(alpha=0.5, q=2, min_dim=32), generator=g(1))
    opt = opt_mod.adamw(opt_mod.constant_schedule(1e-4))
    step = make_train_step(model, opt)
    data = SyntheticLM(cfg, batch=4, seq=32, seed=0)
    to_dev = lambda b: {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}  # noqa: E731

    def fresh():
        return TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))

    want, _ = TrainLoopRunner(step, data.at_step, None).run(fresh(), 4, shard_fn=to_dev)
    c = ckpt.Checkpointer(str(tmp_path), codec="raw")
    with pytest.raises(RuntimeError, match="injected"):
        TrainLoopRunner(step, data.at_step, c, save_every=2).run(fresh(), 4, shard_fn=to_dev, fail_at=lambda s: s == 3)
    c.wait()
    restored, _ = ckpt.restore(fresh(), str(tmp_path))
    got, _ = TrainLoopRunner(step, data.at_step, None).run(restored, 4, shard_fn=to_dev, start_step=2)
    for (pa, a), (_, b) in zip(sorted(_flat(want.params)), sorted(_flat(got.params))):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), pa


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.gpu
def test_gpu_nccl_refuses_two_ranks_on_one_card(cuda):
    """NCCL takes one rank a card: two ranks on one device raise before any
    process starts (no quiet switch to gloo); one rank runs."""
    import torch_ranks
    from repro_torch.runtime import distributed

    with pytest.raises(RuntimeError, match="one rank per card"):
        distributed.spawn(torch_ranks.rank_of, 2, (2,), ("data",), "cuda:0", backend="nccl")
    if torch.cuda.device_count() == 1:
        with pytest.raises(RuntimeError, match="one rank per card"):
            distributed.spawn(torch_ranks.rank_of, 2, (2,), ("data",), "cuda", backend="nccl")
    assert distributed.spawn(torch_ranks.rank_of, 1, (1,), ("data",), "cuda", backend="nccl") == [0]
