"""The dry-run's building blocks against the reference, on the CPU.

The shape cells, the registry's cell functions, the batch templates and the
analytic parameter counts equal the reference's exactly; the roofline terms
equal the reference's given its constants (floating point, rtol 1e-12); the
dry mesh's collective bytes equal the reference's ``analyze_hlo`` on a
one-instruction HLO of the same collective (exactly: both apply the same
ring formula to the same byte count) and its collectives return what live
gloo ranks return; ``kernel_cost`` reproduces the bounds of ``PERF.md``
section 6's kernel table to the table's rounding; the op counter's peak,
FLOPs and bytes are exact on a tiny program; and the dry world loads no
kernel library and allocates no real tensor.
"""

import ctypes
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.models.model import analytic_param_count as j_param_count  # noqa: E402
from repro.models.model import batch_spec_template as j_template  # noqa: E402
from repro.roofline.analysis import roofline_terms as j_roofline_terms  # noqa: E402
from repro.roofline.hlo_stats import analyze_hlo  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.model import analytic_param_count, batch_spec_template  # noqa: E402
from repro_torch.roofline import dry, kernel_cost, op_stats  # noqa: E402
from repro_torch.roofline.analysis import NVLINK_BW, axis_bandwidth, roofline_terms  # noqa: E402
from repro_torch.runtime import dispatch, distributed  # noqa: E402
from repro_torch.runtime.device import resolve_device  # noqa: E402
from repro_torch.runtime.distributed import MeshSpec, dry_mesh  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

KINDS = ("train", "prefill", "decode")


# --------------------------------------------------------------------------- #
# cells, registry, templates, parameter counts
# --------------------------------------------------------------------------- #
def test_shape_cells_equal_reference():
    assert list(base.SHAPE_CELLS) == list(j_base.SHAPE_CELLS)
    for name, cell in base.SHAPE_CELLS.items():
        ref = j_base.SHAPE_CELLS[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref)
        assert cell.tokens == ref.tokens
        assert registry.get_shape(name) == cell


def test_cell_functions_equal_reference():
    assert registry.LONG_CONTEXT_ARCHS == j_registry.LONG_CONTEXT_ARCHS
    assert registry.all_cells() == j_registry.all_cells()
    for arch in j_registry.ARCH_IDS:
        for shape in j_base.SHAPE_CELLS:
            assert registry.cell_is_runnable(arch, shape) == j_registry.cell_is_runnable(arch, shape)


@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_batch_spec_template_equals_reference(arch):
    cfg, j_cfg = registry.get_arch(arch), j_registry.get_arch(arch)
    for kind in KINDS:
        got = batch_spec_template(cfg, 3, 17, kind=kind)
        want = j_template(j_cfg, 3, 17, kind=kind)
        assert list(got) == list(want)
        for k in want:
            assert got[k][0] == want[k][0]
            assert str(got[k][1]).replace("torch.", "") == np.dtype(want[k][1]).name


@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_param_counts_equal_reference(arch):
    cfg, j_cfg = registry.get_arch(arch), j_registry.get_arch(arch)
    assert analytic_param_count(cfg) == j_param_count(j_cfg)
    assert analytic_param_count(cfg, active_only=True) == j_param_count(j_cfg, active_only=True)
    assert cfg.param_count() == j_cfg.param_count()
    assert cfg.active_param_count() == j_cfg.active_param_count()


# --------------------------------------------------------------------------- #
# the roofline terms
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("terms", [(3.1e15, 2.2e12, 4.0e9), (1.0e12, 9.0e11, 8.0e10), (5e13, 1e9, 0.0)])
def test_roofline_terms_equal_reference(terms):
    flops, hbm, coll = terms
    kw = dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=256, model_flops_global=7.7e17)
    want = j_roofline_terms(**kw)
    got = roofline_terms(**kw, peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9 * 2)
    for f in ("t_compute", "t_memory", "t_collective", "t_total", "useful_flops_ratio", "roofline_fraction"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12), f
    assert got.bottleneck == want.bottleneck


def test_roofline_prices_each_axis_by_where_its_groups_lie():
    # 16 x 16 over nodes of 8 cards: both axes' groups span nodes; (2, 4): every group within one node
    single = MeshSpec((16, 16), ("data", "model"))
    assert axis_bandwidth(single, "model") == axis_bandwidth(single, "data") == 50e9
    small = MeshSpec((2, 4), ("data", "model"))
    assert axis_bandwidth(small, "model") == axis_bandwidth(small, "data") == NVLINK_BW == 450e9
    assert axis_bandwidth(MeshSpec((4, 4), ("data", "model")), "model") == NVLINK_BW
    assert axis_bandwidth(MeshSpec((4, 4), ("data", "model")), "data") == 50e9
    assert axis_bandwidth(small, "data,model") == NVLINK_BW
    rf = roofline_terms(flops=0.0, hbm_bytes=0.0, coll_bytes={"data": 9e9, "model": 4.5e9}, chips=8,
                        model_flops_global=0.0, ici_bw={"data": 50e9, "model": NVLINK_BW})
    assert rf.t_collective == pytest.approx(9e9 / 50e9 + 4.5e9 / NVLINK_BW)
    assert rf.coll_bytes == 13.5e9


# --------------------------------------------------------------------------- #
# the dry mesh's collectives
# --------------------------------------------------------------------------- #
def _hlo(instr: str, param: str) -> str:
    return (f"HloModule m\n\nENTRY %main (p: {param}) -> f32[] {{\n  %p = {param} parameter(0)\n"
            f"  ROOT %r = {instr}\n}}\n")


def _ref_bytes(kind: str, n: int, elems: int) -> float:
    groups = f"replica_groups=[1,{n}]<={n}"
    if kind == "all-reduce":
        text = _hlo(f"f32[{elems}]{{0}} all-reduce(f32[{elems}]{{0}} %p), {groups}, to_apply=%add", f"f32[{elems}]")
    elif kind == "all-gather":
        text = _hlo(f"f32[{n * elems}]{{0}} all-gather(f32[{elems}]{{0}} %p), {groups}, dimensions={{0}}",
                    f"f32[{elems}]")
    else:
        text = _hlo(f"f32[{elems}]{{0}} collective-permute(f32[{elems}]{{0}} %p), source_target_pairs={{{{0,1}}}}",
                    f"f32[{elems}]")
    stats = analyze_hlo(text, world=n)
    assert stats.coll_ops == 1
    return stats.coll_bytes[kind]


@pytest.mark.parametrize("n", [2, 8, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "collective-permute"])
def test_dry_collective_bytes_equal_reference(kind, n):
    elems = 1024
    with dry.dry_world():
        mesh = dry_mesh(MeshSpec((n,), ("model",)), 0)
        x = torch.zeros(elems, dtype=torch.float32)

        def run():
            with torch.no_grad():
                if kind == "all-reduce":
                    return distributed.psum(x, "model", mesh)
                if kind == "all-gather":
                    return distributed.all_gather(x, "model", mesh)
                token = distributed.shift_token(mesh.device, False)
                return distributed.shift(x, "model", send=True, recv_like=None, token=token, mesh=mesh)[1]

        _, st = op_stats.measure(run, arguments=(x,))
    assert st.coll_ops == 1
    assert st.coll_bytes[kind] == _ref_bytes(kind, n, elems)
    assert st.coll_by_axis == {"model": st.coll_bytes[kind]}


def test_dry_pmean_and_psum_backward_record():
    """pmean is a psum per axis; the backward of a psum records its own all-reduce."""
    with dry.dry_world():
        mesh = dry_mesh(MeshSpec((2, 4), ("data", "model")), 5)
        w = torch.zeros(256, dtype=torch.float32, requires_grad=True)

        def run():
            with torch.enable_grad():
                y = distributed.psum(w * 2, "model", mesh).sum()
                (g,) = torch.autograd.grad(y, [w])
            return distributed.pmean(g, ("data", "model"), mesh)

        _, st = op_stats.measure(run, arguments=(w,))
    b = 256 * 4
    assert st.coll_ops == 4
    assert st.coll_by_axis == {"model": 3 * 2 * 3 / 4 * b, "data": 2 * 1 / 2 * b}


def test_dry_collectives_return_what_live_ranks_return():
    live = distributed.spawn(torch_ranks.collective_shapes, 4, (2, 2), ("data", "model"), "cpu")
    spec = MeshSpec((2, 2), ("data", "model"))
    with dry.dry_world():
        for rank in range(4):
            assert torch_ranks.collective_shapes(dry_mesh(spec, rank)) == live[rank], rank


def test_dry_mesh_is_explicit():
    assert "dry" in distributed.BACKENDS
    with pytest.raises(ValueError, match="dry mesh"):
        distributed.check_backend("dry", 4, "cpu")
    m = dry_mesh(MeshSpec((2, 4), ("data", "model")), 6, "cpu")
    assert (m.backend, m.rank, m.coords) == ("dry", 6, {"data": 1, "model": 2})
    with distributed.use_mesh(m):
        assert distributed.axis_index("model") == 2 and distributed.axis_size(("data", "model")) == 8


# --------------------------------------------------------------------------- #
# kernel_cost against PERF.md section 6's kernel table
# --------------------------------------------------------------------------- #
def _bound_ms(cost, peak=989e12):
    ops, nbytes = cost
    return max(nbytes / 3.35e12, ops / peak) * 1e3


@pytest.mark.parametrize("row, cost, table", [
    ("lowrank_matmul M=4 2048x615x8192", kernel_cost.lowrank_matmul(4, 2048, 615, 8192, 2), 0.0038),
    ("decode_attention B 4, S 288, 257 valid", kernel_cost.decode_attention(4, 288, 32, 8, 64, 2, n_rows=4 * 257),
     0.00064),
    ("paged 8 x page 64 x 10, 1324 valid", kernel_cost.paged_decode_attention(8, 10, 32, 8, 64, 2, n_rows=1324),
     0.00083),
    ("flash (4, 256) 32/8 hd 64 causal", kernel_cost.flash_attention(4, 256, 256, 32, 8, 64, 2), 0.0031),
    ("sketch 2048x8192 @ 8192x615", kernel_cost.sketch_matmul(2048, 8192, 615, 2), 0.0209),
    ("batched 16 x 128, 10 live, 16 rows",
     kernel_cost.lowrank_matmul_batched(16, 128, 4096, 1229, 6400, 2, live_experts=10, live_rows=16), 0.0898),
    ("ssd_scan (1, 512) nh 64 hd 64 s 64", kernel_cost.ssd_scan(1, 512, 64, 64, 64, 2), 0.0029),
    # phases 19-20's and 23's tables
    ("flash MLA (4, 256) 128 heads q/k 192 v 128",
     kernel_cost.flash_attention(4, 256, 256, 128, 128, 192, 2, vd=128), 0.0501),
    ("sketch qwen2 w_gate l 2458", kernel_cost.sketch_matmul(8192, 29568, 2458, 2), 1.2040),
])
def test_kernel_cost_reproduces_perf_table(row, cost, table):
    decimals = len(repr(table).split(".")[1])
    assert round(_bound_ms(cost), decimals) == table, row


def test_attention_pairs():
    assert kernel_cost.attention_pairs(256, 256) == 256 * 257 // 2
    assert kernel_cost.attention_pairs(200, 200, True, 64) == sum(min(i + 1, 64) for i in range(200))
    assert kernel_cost.attention_pairs(70, 256, True, None, 186) == sum(min(186 + i + 1, 256) for i in range(70))
    assert kernel_cost.attention_pairs(8, 1500, False) == 8 * 1500


# --------------------------------------------------------------------------- #
# the op counter and the dry world
# --------------------------------------------------------------------------- #
def test_op_counter_exact_on_a_tiny_program():
    with dry.dry_world():
        a = torch.zeros(1000, dtype=torch.float32)
        w = torch.zeros((8, 16), dtype=torch.float32)

        def prog():
            b = a * 2  # live: a, w, b
            c = b.sum()  # + 4
            del b  # a, w, c
            e = torch.cat([a, a])  # + 8000: the peak (8000 more had b not been freed)
            m = torch.mm(a[:32].view(4, 8), w)  # a view's product: 2 * 4 * 8 * 16 FLOPs, + 256
            return c, e, m

        _, st = op_stats.measure(prog, arguments=(a, w))
    assert st.argument_bytes == 4000 + 512
    assert st.peak_bytes == 4000 + 512 + 4 + 8000 + 256
    assert st.matmul_flops == 2 * 4 * 8 * 16
    assert st.flops == 1000 + 2 * 4 * 8 * 16  # the multiply's elements, then the mm
    # mul 4000 + 4000; sum 4000 + 4; cat 2 x 4000 + 8000; the views nothing; mm 128 + 512 + 256
    assert st.hbm_bytes == 8000 + 4004 + 16000 + 896
    assert st.kernels == {} and st.coll_ops == 0


def test_resolve_device_outside_and_inside_the_dry_world():
    if torch.cuda.is_available():
        pytest.skip("a card is present: resolve_device('cuda') does not raise here")
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device()
    with dry.dry_world():
        assert resolve_device("cuda") == resolve_device() == dry.stand_in_device()
        assert resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(RuntimeError, match="already active"):
            with dry.dry_world():
                pass
    assert not dry.active()
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device("cuda")


def test_dry_world_records_every_kernel_and_loads_no_library(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("a kernel library was loaded in the dry world")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(_build, "build_all", no_library)
    monkeypatch.setattr(ctypes, "CDLL", no_library)
    bf = torch.bfloat16
    with dry.dry_world(), torch.no_grad():
        z = lambda *s, dtype=bf: torch.zeros(s, dtype=dtype)  # noqa: E731
        x, A, B = z(6, 32), z(32, 4), z(4, 48)
        xs, As, Bs = z(3, 5, 32), z(3, 32, 4), z(3, 4, 48)
        q, k, v = z(2, 16, 8, 16), z(2, 16, 2, 16), z(2, 16, 2, 16)
        qd, kc, vc, valid = z(2, 1, 8, 16), z(2, 40, 2, 16), z(2, 40, 2, 16), z(2, 40, dtype=torch.bool)
        pool, bt, nv = z(9, 8, 2, 16), z(2, 4, dtype=torch.int32), z(2, dtype=torch.int32)
        ssd = (z(1, 64, 4, 8), z(1, 64, 4, dtype=torch.float32), z(1, 64, 16), z(1, 64, 16),
               z(4, dtype=torch.float32))
        table, W, Y = z(100, 32), z(64, 48), z(48, 12)

        def run():
            return [dispatch.lowrank_apply(x, A, B), dispatch.lowrank_apply(xs, As, Bs),
                    dispatch.sketch_matmul(W, Y), dispatch.logits_apply(x, table),
                    dispatch.flash_attention(q, k, v), dispatch.decode_attention(qd, kc, vc, valid),
                    dispatch.paged_decode_attention(qd, pool, pool, bt, nv),
                    *dispatch.ssd_scan(*ssd, chunk=16, round_xbar=True)]

        dispatch.reset_counters()
        outs, st = op_stats.measure(run)
    assert all(isinstance(o, FakeTensor) for o in outs)
    shapes = [tuple(o.shape) for o in outs]
    assert shapes == [(6, 48), (3, 5, 48), (64, 12), (6, 100), (2, 16, 8, 16), (2, 1, 8, 16), (2, 1, 8, 16),
                      (1, 64, 4, 8), (1, 4, 8, 16)]
    want = {
        "lowrank_matmul": kernel_cost.lowrank_matmul(6, 32, 4, 48, 2),
        "lowrank_matmul_batched": kernel_cost.lowrank_matmul_batched(3, 5, 32, 4, 48, 2),
        "sketch_matmul": kernel_cost.sketch_matmul(64, 48, 12, 2),
        "logits": kernel_cost.sketch_matmul(100, 32, 6, 2, out_itemsize=4),
        "flash_attention": kernel_cost.flash_attention(2, 16, 16, 8, 2, 16, 2),
        "decode_attention": kernel_cost.decode_attention(2, 40, 8, 2, 16, 2, n_rows=80),
        "paged_decode_attention": kernel_cost.paged_decode_attention(2, 4, 8, 2, 16, 2, n_rows=2 * 4 * 8),
        "ssd_scan": kernel_cost.ssd_scan(1, 64, 4, 8, 16, 2),
    }
    assert st.kernels == {op: {"calls": 1, "flops": float(f), "bytes": float(b)} for op, (f, b) in want.items()}
    assert st.matmul_flops == 0  # the plain versions' own products are not counted
    assert dispatch.kernel_calls() == {op: 1 for op in want}
