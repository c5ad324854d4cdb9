"""The decode kernels' launch plan (``kernels/decode_attention.py::decode_plan``).

The flat and the paged flash-decode kernels run one launch a call over a
cluster of blocks whose shape the wrappers compute in Python from the
shapes (and the card's SM count) alone, so a captured CUDA graph replays
the same grid whatever the mask or ``n_valid`` hold.  The kernels run on
the card only (tests/test_torch_gpu.py); what is held here is the plan they
are given: it is a function of the shapes, the flat and paged plans agree,
the warps' tiles cover every position once, a block fits in shared memory,
and a call's blocks are resident at once where one block a cluster allows.
"""

import inspect

import pytest

from repro_torch.kernels import decode_attention as flat
from repro_torch.kernels import paged_decode_attention as paged

H100_SMS = 132
SHAPES = [(64, 64), (128, 128), (80, 80), (128, 64), (64, 256), (16, 16), (512, 512), (64, 320)]
LENGTHS = [1, 15, 16, 17, 45, 200, 288, 300, 512, 640, 1100, 4096, 5120, 32768]


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("hd,vd", SHAPES)
@pytest.mark.parametrize("S", LENGTHS)
def test_decode_plan_covers_every_position_once(S, hd, vd, esz):
    for groups in (1, 256):
        _check_plan(S, hd, vd, esz, groups)


def warp_tiles(S, plan):
    """The position ranges each warp of a cluster walks, by (rank, warp), as
    the kernel deals them: tile t to warp t mod (clusters x warps)."""
    n_tiles, n_warps = -(-S // flat.TILE), plan.clusters * plan.warps
    return [[(t * flat.TILE, min(S, (t + 1) * flat.TILE)) for t in range(u, n_tiles, n_warps)]
            for u in range(n_warps)]


def _check_plan(S, hd, vd, esz, groups):
    plan = flat.decode_plan(S, hd, vd, esz, groups, H100_SMS)
    assert 1 <= plan.clusters <= flat.MAX_CLUSTER and 1 <= plan.warps <= flat.MAX_WARPS
    assert plan.stages in (1, 2)
    assert flat.smem_bytes(plan.warps, plan.stages, hd, vd, esz) <= flat.SMEM_MAX
    resident = H100_SMS * flat.blocks_per_sm(plan.warps, plan.stages, hd, vd, esz)
    assert plan.clusters == 1 or plan.clusters * groups <= resident
    tiles = warp_tiles(S, plan)
    assert len(tiles) == plan.clusters * plan.warps
    covered = sorted(p for warp in tiles for lo, hi in warp for p in range(lo, hi))
    assert covered == list(range(S))
    # every block has work: no rank of the cluster is idle
    assert all(any(tiles[r * plan.warps + w] for w in range(plan.warps)) for r in range(plan.clusters))
    # a ring of two stages wherever a warp walks more than one tile and one warp's two stages fit
    most = max(len(w) for w in tiles)
    assert plan.stages == (min(2, most) if flat.smem_bytes(1, 2, hd, vd, esz) <= flat.SMEM_MAX else 1)


@pytest.mark.parametrize("hd,vd", [(64, 64), (128, 128), (80, 80), (128, 64)])
@pytest.mark.parametrize("esz", [2, 4])
def test_decode_plan_flat_and_paged_agree_at_page_64(hd, vd, esz):
    for groups in (1, 64, 256):
        for n_tbl in range(1, 41):
            assert paged.paged_plan(n_tbl, 64, hd, vd, esz, groups, H100_SMS) == \
                flat.decode_plan(64 * n_tbl, hd, vd, esz, groups, H100_SMS)
        # and at every page size over the same logical length: the tiles are cut by position alone
        for page, n_tbl in ((1, 640), (16, 40), (48, 14), (128, 5)):
            assert paged.paged_plan(n_tbl, page, hd, vd, esz, groups, H100_SMS) == \
                flat.decode_plan(page * n_tbl, hd, vd, esz, groups, H100_SMS)


def test_decode_plan_depends_on_shapes_alone():
    """The plan takes shapes and the card's SM count, never the mask, n_valid
    or the block table, so the main path's calls launch fixed grids (the
    engine's graph replays them).  At the main path's shapes on the H100's
    132 SMs: the static path's S = 288 over 4 x 8 (batch, KV head) groups
    (one tile a warp, 5 blocks of 4 warps), the engines' 640 over 8 x 8 at
    hd 64 and 128 (two tiles a warp, two stages), zamba2's 8 x 32 at G = 1
    (five tiles a warp over 2 blocks: 5 blocks a cluster would not all be
    resident at once), and a row past one cluster's 32 warps."""
    assert list(inspect.signature(flat.decode_plan).parameters) == ["S", "hd", "vd", "esz", "groups", "sms"]
    assert list(inspect.signature(paged.paged_plan).parameters) == ["n_tbl", "page", "hd", "vd", "esz", "groups",
                                                                    "sms"]
    assert flat.plan_groups(8, 32, 1, 64) == 256 and flat.plan_groups(4, 2, 16, 320) == 32
    assert flat.decode_plan(288, 64, 64, 2, flat.plan_groups(4, 8, 4, 64), H100_SMS) == flat.DecodePlan(5, 4, 1)
    for hd in (64, 128):
        assert flat.decode_plan(640, hd, hd, 2, flat.plan_groups(8, 8, 4, hd), H100_SMS) == flat.DecodePlan(5, 4, 2)
    assert flat.decode_plan(640, 64, 64, 2, flat.plan_groups(8, 32, 1, 64), H100_SMS) == flat.DecodePlan(2, 4, 2)
    assert flat.decode_plan(1100, 64, 64, 2, flat.plan_groups(3, 2, 4, 64), H100_SMS) == flat.DecodePlan(6, 4, 2)


def test_decode_plan_fits_wide_heads_with_fewer_warps():
    """Wide fp32 heads take fewer warps a block rather than more shared
    memory than a block may have; dims no block can hold raise."""
    assert flat.decode_plan(640, 512, 512, 4, 64, H100_SMS).warps == 2
    assert flat.decode_plan(640, 800, 800, 4, 64, H100_SMS).warps == 1
    with pytest.raises(ValueError, match="shared memory"):
        flat.decode_plan(640, 4096, 4096, 4, 64, H100_SMS)
