"""The low-rank kernels' launch plans (``kernels/lowrank_matmul.py``).

Both low-rank kernels launch each stage under a plan that the wrappers
compute in Python from the shapes and the card's SM count alone, so a
captured CUDA graph replays the same grid whatever the data (for the
batched kernel: whatever the routing).  The kernels run on the card only
(tests/test_torch_gpu.py); what is held here is the plan they are given:
every output column is covered once, every 64-row k-block of K falls in
exactly one split of a cluster in rank order, a block fits in shared
memory, a cluster is portable (at most 8 blocks), the skinny kernel's
blocks are resident in one wave, and the plan is a function of the shapes.
"""

import inspect

import pytest

from repro_torch.kernels import lowrank_matmul as lm
from repro_torch.kernels import lowrank_matmul_batched as lmb

H100_SMS = 132
M_ALL = list(range(1, 10)) + [256, 1024]

# (K, r, N) of every compressed linear on the port's main paths at alpha 0.3, and ragged ones
SHAPES = {
    "llama wq/wo": (2048, 615, 2048),
    "llama wk/wv": (2048, 154, 512),
    "llama w_gate/w_up": (2048, 615, 8192),
    "llama w_down": (8192, 615, 2048),
    "phi wq/wo": (4096, 1229, 4096),
    "phi wk/wv": (4096, 308, 1024),
    "phi head": (4096, 1229, 32064),
    "zamba2 w_z/w_x": (2048, 615, 4096),
    "zamba2 w_B/w_C/w_dt": (2048, 20, 64),
    "zamba2 w_out": (4096, 615, 2048),
    "zamba2 head": (2048, 615, 32000),
    "mamba2 w_z/w_x": (768, 231, 1536),
    "mamba2 w_B/w_C": (768, 39, 128),
    "mamba2 w_out": (1536, 231, 768),
    "ragged r 37, N 96": (250, 37, 96),
    "ragged 512/154/512": (512, 154, 512),
    "ragged 96/29/200": (96, 29, 200),
    "one k-block": (64, 16, 64),
}
# (L, M, K, r, N) of the batched kernel: phi3.5-moe's expert stacks at the decode capacity
# (128 rows an expert) and at a 512-token prefill's (640), and ragged stacks
BATCHED = {
    "phi decode w_gate/w_up": (16, 128, 4096, 1229, 6400),
    "phi decode w_down": (16, 128, 6400, 1229, 4096),
    "phi prefill w_gate/w_up": (16, 640, 4096, 1229, 6400),
    "phi prefill w_down": (16, 640, 6400, 1229, 4096),
    "reduced phi": (4, 128, 256, 77, 512),
    "ragged r 37, N 96": (1, 128, 250, 37, 96),
    "ragged 4 x 128": (4, 128, 512, 154, 320),
    "ragged 3 x 70": (3, 70, 96, 29, 200),
    "ragged 16 x 9": (16, 9, 64, 16, 64),
    "ragged 6 x 320": (6, 320, 512, 154, 320),
}


def _check_splits(K, splits):
    """Every k-block of K in exactly one split, the splits in rank order, none empty."""
    nkb = max(1, -(-K // lm.BK))
    assert 1 <= splits <= lm.MAX_SPLITS and splits <= nkb
    ranges = [lm.split_range(nkb, splits, z) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == nkb
    assert all(lo < hi for lo, hi in ranges)
    assert all(ranges[z][1] == ranges[z + 1][0] for z in range(splits - 1))  # rank order, no gap or overlap
    rows = [k for lo, hi in ranges for k in range(lo * lm.BK, min(K, hi * lm.BK))]
    assert rows == list(range(K))
    return ranges


def _check_columns(N, bn):
    tiles = [(j * bn, min(N, (j + 1) * bn)) for j in range(-(-N // bn))]
    cols = [c for lo, hi in tiles for c in range(lo, hi)]
    assert cols == list(range(N))


def _check_stage(M, K, N, plan, L=1, esz=2):
    """One stage, (M, K) @ (K, N) over a stack of L, under its plan."""
    ranges = _check_splits(K, plan.splits)
    _check_columns(N, plan.bn)
    if plan.bm == 0:  # the skinny kernel
        assert M <= lm.SKINNY_MAX_M and L == 1
        assert plan.bn in lm.SKINNY_BNS
        nk = max(hi - lo for lo, hi in ranges)
        assert lm.skinny_smem(plan.bn, nk, esz) <= lm.SMEM_MAX
        blocks = -(-N // plan.bn) * plan.splits
        assert blocks <= 65535 * plan.splits
        return blocks, lm.skinny_per_sm(plan.bn, nk, esz)
    if esz == 4:  # fp32 above the skinny kernel: the FMA tiles, no split
        assert plan == lm.FMA_TILES and L == 1
        return None, None
    assert (plan.bm, plan.bn) in lm.TILES
    assert lm.tile_smem(plan.bm, plan.bn) <= lm.SMEM_MAX
    mt = -(-M // plan.bm)
    assert mt <= 65535 and L * plan.splits <= 65535
    rows = [m for i in range(mt) for m in range(i * plan.bm, min(M, (i + 1) * plan.bm))]
    assert rows == list(range(M))  # every output row covered once
    return L * mt * -(-N // plan.bn) * plan.splits, lm.tile_per_sm(plan.bm, plan.bn)


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("M", M_ALL)
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_lowrank_plan_covers_every_column_and_k_row_once(shape, M, esz):
    K, r, N = SHAPES[shape]
    p1, p2 = lm.lowrank_plans(M, K, r, N, H100_SMS, esz)
    # M <= 8 runs the skinny kernel, larger M the wgmma tiles (bf16) or the FMA tiles (fp32)
    assert (p1.bm == 0) == (p2.bm == 0) == (M <= lm.SKINNY_MAX_M)
    for (k, n), plan in (((K, r), p1), ((r, N), p2)):
        blocks, per_sm = _check_stage(M, k, n, plan, esz=esz)
        if plan.bm == 0:
            # one wave: every block of the launch resident at once
            assert blocks <= H100_SMS * per_sm


@pytest.mark.parametrize("shape", list(BATCHED), ids=list(BATCHED))
def test_batched_plan_covers_every_column_and_k_row_once(shape):
    L, M, K, r, N = BATCHED[shape]
    p1, p2 = lm.batched_plans(L, M, K, r, N, H100_SMS)
    for (k, n), plan in (((K, r), p1), ((r, N), p2)):
        assert plan.bm > 0  # the expert stacks always run the wgmma tiles
        _check_stage(M, k, n, plan, L=L)
        if M <= max(bm for bm, _ in lm.TILES):
            # one tile row covers an expert's whole capacity: each factor tile is read by one cluster
            assert -(-M // plan.bm) == 1
    # the liveness pass's scratch: one byte per (expert, 64-row granule, 512-column part)
    assert lmb.live_flag_bytes(L, M, K) == L * -(-M // 64) * -(-K // 512)


def test_tile_configs_fit_the_sm():
    """The three wgmma tiles fit a block's 227 KB with their 4-stage ring; the
    128 x 64 tile runs two blocks an SM, the others one (gemm_wgmma.cuh::Cfg)."""
    assert [lm.tile_per_sm(bm, bn) for bm, bn in lm.TILES] == [2, 1, 1]
    assert all(lm.tile_smem(bm, bn) <= lm.SMEM_MAX for bm, bn in lm.TILES)
    # the epilogue parks an fp32 BM x (BN + 4) tile in the ring
    assert all(bm * (bn + 4) * 4 <= lm.TILE_STAGES * (bm + bn) * lm.BK * 2 for bm, bn in lm.TILES)


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("bn", lm.SKINNY_BNS)
def test_skinny_ring_holds_32_kb_in_flight(bn, esz):
    """A skinny block streams its factor through a ring of up to 64 KB (at
    most 16 stages, the kernel's barrier count): at least 32 KB in flight
    wherever its K run is that long."""
    for nk in range(1, 129):
        stages = lm.skinny_stages(bn, nk, esz)
        assert 1 <= stages <= min(nk, 16)
        if nk * lm.BK * bn * esz >= 32768:
            assert stages * lm.BK * bn * esz >= 32768


def test_plans_depend_on_shapes_alone():
    """The plans take shapes and the card's SM count, never the data, so the
    main path's calls launch fixed grids (the engine's graph replays them).
    At the main path's shapes on the H100's 132 SMs: llama's decode stages
    as 32-column tiles in clusters of 8 over K = 2048 (160 blocks) and one
    block a tile over r = 615 (256 blocks); the engine's 256-row chunk on
    128 x 64 tiles split 7 ways over K = 2048 (not 40 blocks); phi's expert
    stacks on 128 x 256 tiles, one tile row per expert's 128 rows."""
    params = list(inspect.signature(lm.skinny_plan).parameters)
    assert params == ["K", "N", "sms", "esz"]
    assert list(inspect.signature(lm.tile_plan).parameters) == ["M", "K", "N", "sms", "L"]
    G = lm.GemmPlan
    assert lm.lowrank_plans(4, 2048, 615, 8192, H100_SMS) == (G(0, 32, 8), G(0, 32, 1))
    assert lm.lowrank_plans(8, 2048, 615, 8192, H100_SMS) == lm.lowrank_plans(4, 2048, 615, 8192, H100_SMS)
    assert lm.lowrank_plans(8, 8192, 615, 2048, H100_SMS) == (G(0, 32, 8), G(0, 32, 2))
    p1, p2 = lm.lowrank_plans(256, 2048, 615, 8192, H100_SMS)
    assert p1 == G(128, 64, 7) and -(-256 // 128) * -(-615 // 64) * 7 == 140
    assert lm.batched_plans(16, 128, 4096, 1229, 6400, H100_SMS) == (G(128, 256, 2), G(128, 256, 1))
    # recomputed from scratch: the same plan (no state kept between calls)
    lm.skinny_plan.cache_clear()
    lm.tile_plan.cache_clear()
    assert lm.lowrank_plans(4, 2048, 615, 8192, H100_SMS) == (G(0, 32, 8), G(0, 32, 1))
    assert lm.batched_plans(16, 128, 4096, 1229, 6400, H100_SMS) == (G(128, 256, 2), G(128, 256, 1))


@pytest.mark.parametrize("sms", [1, 8, 78, 114, 132])
def test_plans_hold_on_other_cards(sms):
    """Smaller cards (an H100 PCIe has 114 SMs) still get valid plans."""
    for K, r, N in SHAPES.values():
        for M in (4, 256):
            for esz in (2, 4):
                for (k, n), plan in zip(((K, r), (r, N)), lm.lowrank_plans(M, K, r, N, sms, esz)):
                    _check_stage(M, k, n, plan, esz=esz)
    for L, M, K, r, N in BATCHED.values():
        for (k, n), plan in zip(((K, r), (r, N)), lm.batched_plans(L, M, K, r, N, sms)):
            _check_stage(M, k, n, plan, L=L)
