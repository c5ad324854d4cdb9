"""The port's MoE slice against the reference: the stacked low-rank plain
version, the routed layer, compression of expert stacks and an untied head,
the reduced phi3.5-moe model, and the serving engine.

Inputs are made from a seed with numpy (or drawn by JAX and bridged in) and
go through the JAX function and its port twin on the CPU.  The JAX batched
low-rank kernel runs in interpret mode at small blocks, as the reference's
own tests run it.  On the CPU the port's batched-kernel wrapper runs its
plain version; the CUDA kernel is held against that version on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: kernels fp32 2e-5 (another summation order) and bf16 3e-2 (one
bf16 ulp is 2^-8 relative, and both sides round the same intermediates but
may land on neighbouring values); layers and models fp32 1e-4 (matmuls and
transcendentals of two frameworks, through two layers) and bf16 5e-2 of the
reference's largest value (a value one ulp apart propagates).  Routing
decisions (expert ids) and greedy tokens are compared exactly in fp32.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.phi3_5_moe import CONFIG as J_FULL  # noqa: E402
from repro.configs.phi3_5_moe import REDUCED as J_REDUCED  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lowrank_matmul import lowrank_matmul_batched_pallas  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import dispatch as jdispatch  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.train.serve_step import greedy_generate as j_greedy  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels._build import aligned_rows, stack_strides  # noqa: E402
from repro_torch.kernels.lowrank_matmul_batched import lowrank_matmul_batched  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

# both core packages re-export a function named `rsi`, which shadows the submodule
jcompress, jrsi, jspectral = (importlib.import_module(f"repro.core.{m}") for m in ("compress", "rsi", "spectral"))
compress, lowrank, rsi, spectral = (
    importlib.import_module(f"repro_torch.core.{m}") for m in ("compress", "lowrank", "rsi", "spectral")
)

ARCH = "phi3.5-moe-42b-a6.6b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _np(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x / shape[-1] ** 0.25


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _model_close(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(tensor_to_numpy(got), want, **tol)


def _cfgs(dtype, **kw):
    jcfg = dataclasses.replace(J_REDUCED, dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_arch(ARCH, reduced=True), dtype=dtype, **kw)
    return jcfg, tcfg


# --------------------------------------------------------------------------- #
# the stacked plain version and the batched wrapper
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,M,K,r,N", [(3, 64, 128, 16, 64), (2, 100, 250, 37, 48), (4, 33, 70, 29, 96)])
def test_stacked_lowrank_matches_batched_pallas(L, M, K, r, N, dtype):
    """Ragged M and K, ranks off multiples of 8: the batched wrapper (its
    plain version on the CPU) against the JAX batched kernel in interpret
    mode and against the JAX oracle; the stack is L independent 2-D applies."""
    jx, tx = _pair(_np((L, M, K), 1), dtype)
    jA, tA = _pair(_np((L, K, r), 2), dtype)
    jB, tB = _pair(_np((L, r, N), 3), dtype)
    got = lowrank_matmul_batched(tx, tA, tB)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (L, M, N)
    want = lowrank_matmul_batched_pallas(jx, jA, jB, bm=32, bk=64, interpret=True)
    np.testing.assert_allclose(tensor_to_numpy(got), np.asarray(want, np.float32), **KERNEL_TOL[dtype])
    np.testing.assert_allclose(tensor_to_numpy(got), np.asarray(jref.lowrank_matmul_ref(jx, jA, jB), np.float32),
                               **KERNEL_TOL[dtype])
    for i in range(L):
        assert torch.equal(got[i], tref.lowrank_matmul_ref(tx[i], tA[i], tB[i]))


def test_stacked_plain_version_rounds_the_intermediate():
    """t = x @ A is rounded to x's dtype before @ B, per stack entry."""
    _, tx = _pair(_np((2, 8, 32), 4), "bfloat16")
    _, tA = _pair(_np((2, 32, 5), 5), "bfloat16")
    _, tB = _pair(_np((2, 5, 16), 6), "bfloat16")
    t = torch.matmul(tx.float(), tA.float()).to(torch.bfloat16)
    want = torch.matmul(t.float(), tB.float()).to(torch.bfloat16)
    assert torch.equal(tref.lowrank_matmul_ref(tx, tA, tB), want)


def test_stack_strides_take_row_padded_factor_views():
    """One layer's (E, K, r) slice of a row-padded (L, E, K, r) leaf passes
    uncopied with its row and stack strides; overlapping stacks raise."""
    leaf = aligned_rows(torch.zeros(3, 4, 40, 29))
    assert leaf.stride(-2) == 32
    A = leaf[1]
    assert stack_strides(A, "A") == (32, 40 * 32)
    assert stack_strides(leaf.reshape(12, 40, 29), "A") == (32, 40 * 32)
    assert stack_strides(torch.zeros(5, 7, 9), "x") == (9, 63)
    with pytest.raises(ValueError, match="overlap"):
        stack_strides(torch.zeros(40, 29).expand(4, 40, 29), "A")
    with pytest.raises(ValueError, match="contiguous rows"):
        stack_strides(torch.zeros(4, 29, 40).transpose(1, 2), "A")


def test_batched_wrapper_refuses_mixed_devices():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="operands on"):
        lowrank_matmul_batched(x.to("meta"), torch.zeros(2, 8, 3), torch.zeros(2, 3, 5))


# --------------------------------------------------------------------------- #
# dispatch: the stacked branch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("x_shape,a_shape,b_shape", [
    ((4, 128, 64), (4, 64, 20), (4, 20, 48)),  # (E, C, d) experts
    ((2, 4, 128, 64), (2, 4, 64, 20), (2, 4, 20, 48)),  # (L, E, ...) leading dims
    ((3, 2, 5, 64), (3, 64, 20), (3, 20, 48)),  # extra x dims flatten into M
])
def test_stacked_path_table_and_dims(x_shape, a_shape, b_shape):
    """Stacked factors take the batched kernel on ``cuda`` under ``auto`` and
    the two-GEMM plain version on the CPU or under ``reference``; leading
    dims flatten to the reference's (L, M, K, r, N)."""
    assert dispatch._lowrank_dims(x_shape, a_shape, b_shape) == jdispatch._lowrank_dims(x_shape, a_shape, b_shape)
    assert dispatch.choose_lowrank_path(x_shape, a_shape, b_shape, device_type="cuda") == dispatch.PATH_FUSED_BATCHED
    assert dispatch.choose_lowrank_path(x_shape, a_shape, b_shape, device_type="cpu") == dispatch.PATH_TWO_GEMM
    ref_cfg = dispatch.DispatchConfig(backend="reference")
    assert dispatch.choose_lowrank_path(x_shape, a_shape, b_shape, device_type="cuda",
                                        config=ref_cfg) == dispatch.PATH_TWO_GEMM
    assert dispatch.choose_lowrank_path((5, 64), (64, 20), (20, 48), device_type="cuda") == dispatch.PATH_FUSED
    with pytest.raises(ValueError):
        dispatch.choose_lowrank_path(x_shape, a_shape[:-1] + (21,), b_shape, device_type="cuda")


def test_stacked_lowrank_apply_matches_reference_dispatch():
    """x (L, E, M, K) against (L, E, K, r) / (L, E, r, N) factors, row-padded
    as compress_tree stores them: the port's apply equals the JAX apply, and
    the call is recorded under the reference's (L, M, K, r, N) signature."""
    jx, tx = _pair(_np((2, 3, 10, 24), 7), "float32")
    jA, tA = _pair(_np((2, 3, 24, 13), 8), "float32")
    jB, tB = _pair(_np((2, 3, 13, 40), 9), "float32")
    with jdispatch.use_dispatch(backend="reference"):
        want = jdispatch.lowrank_apply(jx, jA, jB)
    dispatch.reset_counters()
    got = dispatch.lowrank_apply(tx, aligned_rows(tA), aligned_rows(tB))
    assert tuple(got.shape) == (2, 3, 10, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL["float32"])
    assert dispatch.counters() == {("lowrank_matmul", dispatch.PATH_TWO_GEMM, (6, 10, 24, 13, 40)): 1}


# --------------------------------------------------------------------------- #
# the routed layer
# --------------------------------------------------------------------------- #
def _moe_params(jcfg, *, compressed: bool):
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.dtype(jcfg.dtype))
    if compressed:
        jp, _, _ = jcompress.compress_tree(jp, jcompress.CompressionPolicy(alpha=0.3, q=2, min_dim=32),
                                           jax.random.PRNGKey(1))
        assert isinstance(jp["experts"]["w_gate"], dict)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("T", [8, 96, 300])
def test_route_and_capacity_match_reference(T):
    jcfg, tcfg = _cfgs("float32")
    for tokens in (1, 8, 255, 256, 300, 1000, 5000):
        assert tmoe.moe_capacity(tokens, tcfg) == jmoe.moe_capacity(tokens, jcfg)
    jp, tp = _moe_params(jcfg, compressed=False)
    jx, tx = _pair(_np((T, jcfg.d_model), 10 + T), "float32")
    j_ids, j_gates, j_aux = jmoe._route(jx, jp["router"]["gate_w"], jcfg)
    ids, gates, probs = tmoe._route(tx, tp["router"]["gate_w"], tcfg)
    aux = tmoe._aux_loss(probs, ids, tcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(j_gates), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)


def _drop_oracle(ids, C, E):
    """keep[t, k]: the assignment is the first C of its expert in token order."""
    seen = np.zeros(E, np.int64)
    keep = np.zeros(ids.shape, bool)
    for t in range(ids.shape[0]):
        for k in range(ids.shape[1]):
            e = ids[t, k]
            keep[t, k] = seen[e] < C
            seen[e] += 1
    return keep


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_dispatch_compute_combine_matches_reference(compressed, capacity_factor):
    """The same ids and gates through both twins: equal outputs.  At
    capacity factor 0.5, 320 tokens over 4 experts overflow C = 128, and the
    assignments that drop are exactly the reference's (each expert keeps
    its first C in token order), checked against a numpy oracle."""
    jcfg, tcfg = _cfgs("float32", capacity_factor=capacity_factor)
    jp, tp = _moe_params(jcfg, compressed=compressed)
    T, d, E = 320, jcfg.d_model, jcfg.n_experts
    jx, tx = _pair(_np((T, d), 20), "float32")
    j_ids, j_gates, _ = jmoe._route(jx, jp["router"]["gate_w"], jcfg)
    C = jmoe.moe_capacity(T, jcfg)
    want = jmoe._dispatch_compute_combine(jx, j_ids, j_gates, jp["experts"], C, E, jnp.float32)
    ids, gates = torch.from_numpy(np.array(j_ids)).long(), torch.from_numpy(np.array(j_gates))
    got = tmoe._dispatch_compute_combine(tx, ids, gates, tp["experts"], C, E, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    keep = _drop_oracle(np.asarray(j_ids), C, E)
    assert keep.all() == (capacity_factor == 1.25)  # the low factor drops, the default does not
    # the oracle: each token's kept experts, applied to that token alone, weighted by their gates
    oracle = torch.zeros(T, d)
    for t in range(T):
        for k in range(jcfg.top_k):
            if keep[t, k]:
                e = int(ids[t, k])
                expert = {n: tmoe_layer(leaf, e) for n, leaf in tp["experts"].items()}
                oracle[t] += gates[t, k] * tmoe.ffn_forward(expert, tx[t:t + 1])[0]
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-4, atol=1e-5)


def _capacity_buffer(monkeypatch, dtype, capacity_factor, T=320, seed=21):
    """The (E, C, d) capacity buffer that _dispatch_compute_combine hands the
    expert stacks (caught at its first dense apply), with each expert's
    count of kept assignments and the compressed params."""
    jcfg, tcfg = _cfgs(dtype, capacity_factor=capacity_factor)
    jp, tp = _moe_params(jcfg, compressed=True)
    E = jcfg.n_experts
    jx, tx = _pair(_np((T, jcfg.d_model), seed), dtype)
    j_ids, j_gates, _ = jmoe._route(jx, jp["router"]["gate_w"], jcfg)
    C = jmoe.moe_capacity(T, jcfg)
    ids, gates = torch.from_numpy(np.array(j_ids)).long(), torch.from_numpy(np.array(j_gates))
    seen = []
    dense = tmoe.nn.dense

    def spy(p, x):
        seen.append(x)
        return dense(p, x)

    monkeypatch.setattr(tmoe.nn, "dense", spy)
    tmoe._dispatch_compute_combine(tx, ids, gates, tp["experts"], C, E, DTYPES[dtype][1])
    counts = np.minimum(np.bincount(np.asarray(j_ids).reshape(-1), minlength=E), C)
    return seen[0], counts, tp, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_capacity_buffer_is_zero_past_each_count(monkeypatch, capacity_factor, dtype):
    """The contract the batched kernel's skip of dead tiles rests on: each
    expert's capacity rows are filled from 0, and every row past its count
    of kept assignments is exactly zero (-0.0 counts as zero)."""
    buf, counts, _, C = _capacity_buffer(monkeypatch, dtype, capacity_factor)
    assert tuple(buf.shape[:2]) == (len(counts), C)
    live = torch.arange(C)[None, :] < torch.from_numpy(counts)[:, None]
    assert bool((buf[~live] == 0).all())
    assert bool((buf[live] != 0).any(dim=-1).all())  # the kept rows hold their tokens
    # at 1.25 some expert has rows past its count; at 0.5 every expert overflows C
    assert (counts < C).any() == (capacity_factor == 1.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_batched_version_keeps_zero_rows_zero(monkeypatch, dtype):
    """The plain batched version on the capacity buffer and an RSI-compressed
    expert stack gives exactly zero rows past each count: what the kernel
    writes for a tile it skips."""
    buf, counts, tp, C = _capacity_buffer(monkeypatch, dtype, 1.25)
    leaf = tp["experts"]["w_gate"]
    y = tref.lowrank_matmul_ref(buf, leaf["a"], leaf["b"])
    live = torch.arange(C)[None, :] < torch.from_numpy(counts)[:, None]
    assert bool((y[~live] == 0).all())
    assert torch.equal(lowrank_matmul_batched(buf, leaf["a"], leaf["b"]), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_on_zero_rows_matches_batched_pallas(monkeypatch, dtype):
    """With those zero rows, the batched wrapper still matches the JAX batched
    kernel (interpret mode) at the stated tolerance, zero rows included."""
    buf, counts, tp, C = _capacity_buffer(monkeypatch, dtype, 1.25, seed=22)
    leaf = tp["experts"]["w_up"]
    jd = DTYPES[dtype][0]
    jx, jA, jB = (jnp.asarray(tensor_to_numpy(t)).astype(jd) for t in (buf, leaf["a"], leaf["b"]))
    got = lowrank_matmul_batched(buf, leaf["a"], leaf["b"])
    want = np.asarray(lowrank_matmul_batched_pallas(jx, jA, jB, bm=32, bk=64, interpret=True), np.float32)
    np.testing.assert_allclose(tensor_to_numpy(got), want, **KERNEL_TOL[dtype])
    live = np.arange(C)[None, :] < counts[:, None]
    assert (want[~live] == 0).all()


def tmoe_layer(leaf, e):
    """Expert e's slice of a dense (E, a, b) leaf or of a factored one."""
    return {k: v[e] for k, v in leaf.items()} if lowrank.is_lowrank(leaf) else leaf[e]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["dense", "compressed", "low_capacity", "shared_expert"])
def test_moe_forward_matches_reference(variant, dtype):
    kw = {"low_capacity": dict(capacity_factor=0.5), "shared_expert": dict(n_shared_experts=1)}.get(variant, {})
    jcfg, tcfg = _cfgs(dtype, **kw)
    jp, tp = _moe_params(jcfg, compressed=variant == "compressed")
    assert ("shared" in tp) == (variant == "shared_expert")
    jx, tx = _pair(_np((2, 160, jcfg.d_model), 30), dtype)
    want, want_aux = jmoe.moe_forward(jp, jx, jcfg)
    got, aux = tmoe.moe_forward(tp, tx, tcfg)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == tuple(want.shape)
    _model_close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4 if dtype == "float32" else 5e-2)
    assert torch.equal(tmoe.moe_apply(tp, tx, tcfg), got)  # the serving entry: same output, no aux


def test_moe_init_tree_matches_reference():
    """Same tree, shapes and dtypes as the reference's moe_init (the shared
    branch included)."""
    for kw in ({}, dict(n_shared_experts=1)):
        jcfg, tcfg = _cfgs("bfloat16", **kw)
        jflat, _ = jax.tree_util.tree_flatten_with_path(jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
        want = {"/".join(p.key for p in path): (tuple(a.shape), str(a.dtype)) for path, a in jflat}
        tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
        got = {path: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for path, t in compress._leaves(tp)}
        assert got == want


# --------------------------------------------------------------------------- #
# compression of (L, E, ...) expert stacks and the untied head
# --------------------------------------------------------------------------- #
def _jax_omega_fn(jparams, key):
    """The Omegas the reference's compress_tree draws, keyed by (path, flat
    index): one key per leaf, split over every (layer, expert) matrix of a
    stacked leaf in row-major order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    counts = {n: int(np.prod(leaf.shape[:-2])) for n, (_, leaf) in zip(names, flat)}
    keys = dict(zip(names, jax.random.split(key, len(names))))

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], counts[name])[layer]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))

    return omega_fn, keys, counts


@pytest.fixture(scope="module")
def dense_f32():
    """Reduced phi3.5-moe, fp32, spectralized (the paper's regime)."""
    jcfg, _ = _cfgs("float32")
    return jspectral.spectralize_params(j_build_model(jcfg).init(jax.random.PRNGKey(0)), jax.random.PRNGKey(9))


def test_compress_tree_matches_reference_on_expert_stacks(dense_f32):
    q, key = 2, jax.random.PRNGKey(1)
    policy = dict(alpha=0.3, q=q, min_dim=32)
    jcp, _, jrep = jcompress.compress_tree(dense_f32, jcompress.CompressionPolicy(**policy), key)
    tparams = params_from_numpy(jax.device_get(dense_f32), device="cpu")
    omega_fn, keys, counts = _jax_omega_fn(dense_f32, key)
    tcp, trep = compress.compress_tree(tparams, compress.CompressionPolicy(**policy), omega_fn=omega_fn)
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    decisions = [(l.path, l.rank, l.compressed) for l in trep.layers]
    assert decisions == [(l.path, l.rank, l.compressed) for l in jrep.layers]
    by_path = {p: c for p, _, c in decisions}
    assert by_path["lm_head"] and by_path["layers/moe/experts/w_gate"] and by_path["layers/attn/wq"]
    assert not by_path["layers/moe/router/gate_w"] and not by_path["embed"]

    leaves = {"layers/moe/experts/w_gate": (tcp["layers"]["moe"]["experts"]["w_gate"],
                                            jcp["layers"]["moe"]["experts"]["w_gate"],
                                            dense_f32["layers"]["moe"]["experts"]["w_gate"]),
              "layers/moe/experts/w_down": (tcp["layers"]["moe"]["experts"]["w_down"],
                                            jcp["layers"]["moe"]["experts"]["w_down"],
                                            dense_f32["layers"]["moe"]["experts"]["w_down"]),
              "lm_head": (tcp["lm_head"], jcp["lm_head"], dense_f32["lm_head"])}
    for name, (tleaf, jleaf, W) in leaves.items():
        assert lowrank.is_lowrank(tleaf) and tuple(tleaf["a"].shape) == jleaf["a"].shape
        k = jleaf["a"].shape[-1]
        mats = [(None, ())] if W.ndim == 2 else [(i, np.unravel_index(i, W.shape[:-2])) for i in range(counts[name])]
        for flat_i, idx in mats:
            Wi, ja, jb, ta, tb = W[idx], jleaf["a"][idx], jleaf["b"][idx], tleaf["a"][idx], tleaf["b"][idx]
            want = np.asarray(ja @ jb)
            np.testing.assert_allclose((ta @ tb).numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
            if flat_i not in (None, 0, counts[name] - 1):
                continue  # S and the error of the first and the last matrix of a stack
            kk = keys[name] if flat_i is None else jax.random.split(keys[name], counts[name])[flat_i]
            j_res = jrsi.rsi(Wi, k, q, kk)
            t_res = rsi.rsi(torch.from_numpy(np.array(Wi)), k, q, omega=omega_fn(name, flat_i, (Wi.shape[1], k)))
            np.testing.assert_allclose(t_res.S.numpy(), np.asarray(j_res.S), rtol=1e-4)
            s = np.linalg.svd(np.asarray(Wi), compute_uv=False)
            ekey = jax.random.PRNGKey(4)
            want_err = float(jspectral.normalized_error_factored(Wi, ja, jb, s[k], ekey))
            v0 = torch.from_numpy(np.array(jax.random.normal(ekey, (Wi.shape[1],), dtype=jnp.float32)))
            got_err = float(spectral.normalized_error_factored(torch.from_numpy(np.array(Wi)), ta, tb, float(s[k]),
                                                               v0=v0))
            np.testing.assert_allclose(got_err, want_err, rtol=1e-3)


# --------------------------------------------------------------------------- #
# the reduced model
# --------------------------------------------------------------------------- #
B, S, GEN = 2, 12, 6


@pytest.fixture(scope="module")
def params_by_dtype(dense_f32):
    """Reference params per dtype: dense (spectralized) and RSI-compressed
    from them (experts, attention and the untied head); bf16 trees are the
    fp32 ones cast."""
    comp, _, _ = jcompress.compress_tree(dense_f32, jcompress.CompressionPolicy(alpha=0.3, q=2, min_dim=32),
                                         jax.random.PRNGKey(1))
    f32 = {"dense": dense_f32, "compressed": comp}
    return {"float32": f32, "bfloat16": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), f32)}


def _models(dtype):
    jcfg, tcfg = _cfgs(dtype)
    return j_build_model(jcfg), build_model(tcfg, device="cpu")


def _tokens(vocab, shape, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_prefill_and_decode_match_reference(params_by_dtype, kind, dtype):
    jm, tm = _models(dtype)
    jp = params_by_dtype[dtype][kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert lowrank.is_lowrank(tp["lm_head"]) == (kind == "compressed")
    jb, tb = _tokens(tm.cfg.vocab, (B, S), 0)
    want, want_aux = jm.forward(jp, jb)
    got, aux = tm.forward(tp, tb)
    assert got.dtype == torch.float32
    _model_close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4 if dtype == "float32" else 5e-2)

    want_l, want_c = jm.prefill(jp, jb, S + GEN)
    got_l, got_c = tm.prefill(tp, tb, S + GEN)
    _model_close(got_l, want_l, dtype)
    for name in ("k", "v"):
        _model_close(got_c["layers"][name], want_c["layers"][name].astype(jnp.float32), dtype)
    nxt = np.array(jnp.argmax(want_l, axis=-1))[:, None]
    want_d, _ = jm.decode_step(jp, want_c, jnp.asarray(nxt, jnp.int32), S)
    got_d, _ = tm.decode_step(tp, got_c, torch.from_numpy(nxt).long(), S)
    _model_close(got_d, want_d, dtype)


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_greedy_generate_matches_reference_fp32(params_by_dtype, kind):
    jm, tm = _models("float32")
    jp = params_by_dtype["float32"][kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jb, tb = _tokens(tm.cfg.vocab, (B, S), 1)
    want = np.asarray(j_greedy(jm, jp, jb, steps=GEN, max_len=S + GEN))
    got = greedy_generate(tm, tp, tb, steps=GEN, max_len=S + GEN)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunk_and_paged_decode_match_reference(params_by_dtype, dtype):
    """Chunk after chunk through permuted pages, then one paged decode step:
    logits and pages against the JAX twins.  Inside the port the chunks give
    the monolithic prefill's logits bit for bit at the engine's bucketed
    prompt shape, and the paged step the flat step's."""
    jm, tm = _models(dtype)
    jp = params_by_dtype[dtype]["compressed"]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    L, C, page, max_len, n_pages = 11, 4, 4, 16, 6
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, size=(1, L))
    row = np.array([3, 0, 5, 1], np.int32)
    jc, _ = jm.init_cache_paged(1, max_len, page, n_pages)
    tc, mask = tm.init_cache_paged(1, max_len, page, n_pages)
    assert mask == {"layers": {"k": True, "v": True}}
    for start in range(0, L, C):
        n = min(C, L - start)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :n] = toks[0, start:start + n]
        want, jc = jm.prefill_chunk(jp, jc, jnp.asarray(chunk, jnp.int32), jnp.asarray(row), start, n)
        got, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk), torch.from_numpy(row), start, n)
    _model_close(got, want, dtype)
    for name in ("k", "v"):
        _model_close(tc["layers"][name][:, torch.from_numpy(row).long()],
                     np.asarray(jc["layers"][name].astype(jnp.float32))[:, row], dtype)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :L] = toks[0]
    mono, flat = tm.prefill(tp, {"tokens": torch.from_numpy(padded)}, max_len, last_index=torch.tensor([L - 1]))
    assert torch.equal(got, mono)

    jc = dict(jc, block_table=jnp.asarray(row[None]))
    tc["block_table"].copy_(torch.from_numpy(row[None]))
    nxt = np.array([[7]])
    want, _ = jm.decode_step(jp, jc, jnp.asarray(nxt, jnp.int32), jnp.asarray([L], jnp.int32))
    got, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt), torch.tensor([L]))
    _model_close(got, want, dtype)
    got_flat, _ = tm.decode_step(tp, flat, torch.from_numpy(nxt), torch.tensor([L]))
    assert torch.equal(got, got_flat)


def test_param_count_and_arch():
    assert analytic_param_count(get_arch(ARCH)) == j_analytic_param_count(J_FULL)
    assert analytic_param_count(get_arch(ARCH, reduced=True)) == j_analytic_param_count(J_REDUCED)
    for field in ("d_model", "n_heads", "n_kv_heads", "head_dim", "vocab", "n_experts", "top_k", "moe_d_ff",
                  "n_layers", "tie_embeddings", "rope_theta", "capacity_factor"):
        assert getattr(get_arch(ARCH), field) == getattr(J_FULL, field), field
        assert getattr(get_arch(ARCH, reduced=True), field) == getattr(J_REDUCED, field), field


# each deepseek-v2 feature on phi's reduced config, with the fields it needs besides
_DEEPSEEK_FEATURES = {
    "kv_lora_rank": dict(kv_lora_rank=8, q_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8),
    "first_dense_layers": dict(first_dense_layers=1, dense_d_ff=64),
    "n_shared_experts": dict(n_shared_experts=1),
}


@pytest.mark.parametrize("field,value", [("kv_lora_rank", 8), ("first_dense_layers", 1), ("n_shared_experts", 1)])
def test_deepseek_features_raise_naming_their_slice(field, value):
    """The deepseek-v2 slice is ported: each of its features builds and
    serves on phi's reduced config; one set without the fields it needs
    raises, naming them."""
    kw = _DEEPSEEK_FEATURES[field]
    assert kw[field] == value
    cfg = dataclasses.replace(get_arch(ARCH, reduced=True), dtype="float32", **kw)
    tm = build_model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = _tokens(cfg.vocab, (2, 6), 1)[1]["tokens"]
    logits, _ = tm.forward(tp, {"tokens": toks})
    assert tuple(logits.shape) == (2, 6, cfg.vocab_padded) and bool(torch.isfinite(logits).all())
    got = greedy_generate(tm, tp, {"tokens": toks}, steps=3, max_len=10)
    assert tuple(got.shape) == (2, 3)
    if field != "n_shared_experts":
        with pytest.raises(ValueError, match="needs"):
            build_model(dataclasses.replace(get_arch(ARCH, reduced=True), **{field: value}), device="cpu")


# --------------------------------------------------------------------------- #
# the serving engine
# --------------------------------------------------------------------------- #
MAX_LEN = 16
STEPS = (5, 6)
MODES = {"flat": {}, "paged4": dict(page_size=4), "paged4_chunk3": dict(page_size=4, prefill_chunk=3)}


@pytest.fixture(scope="module")
def engine_models(params_by_dtype):
    jm, tm = _models("float32")
    jp = params_by_dtype["float32"]["compressed"]
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), device="cpu")


def _drive(eng, make_request, prompts):
    """Request 1 arrives two engine steps after request 0 (mid-decode or
    mid-chunk)."""
    reqs = [eng.submit(make_request(prompts[0], STEPS[0]))]
    eng.step()
    eng.step()
    reqs.append(eng.submit(make_request(prompts[1], STEPS[1])))
    while eng.has_work:
        eng.step()
    return [list(r.tokens) for r in reqs]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in (6, 4)]


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_engine(engine_models, mode):
    """Compressed reduced phi3.5-moe in fp32: the port's engine emits the JAX
    engine's greedy tokens with staggered admission, flat, paged and paged +
    chunked; inside the port every mode emits the flat engine's tokens."""
    jm, jp, tm, tp = engine_models
    prompts = _prompts(tm.cfg.vocab)
    want = _drive(JEngine(jm, jp, n_slots=2, max_len=MAX_LEN, **MODES[mode]),
                  lambda p, s: JRequest(prompt=p, max_new_tokens=s), prompts)
    got = _drive(Engine(tm, tp, n_slots=2, max_len=MAX_LEN, **MODES[mode]),
                 lambda p, s: Request(prompt=p, max_new_tokens=s), prompts)
    assert got == want
    flat = _drive(Engine(tm, tp, n_slots=2, max_len=MAX_LEN), lambda p, s: Request(prompt=p, max_new_tokens=s),
                  prompts)
    assert got == flat


def test_engine_bf16_paged_and_chunked_equal_flat():
    """bf16 (the served dtype), compressed in the port itself: paged and
    paged + chunked tokens equal the flat engine's bit for bit."""
    _, tcfg = _cfgs("bfloat16")
    tm = build_model(tcfg, device="cpu")
    tp, _ = compress.compress_tree(tm.init(torch.Generator().manual_seed(3)),
                                   compress.CompressionPolicy(alpha=0.3, q=2, min_dim=16),
                                   generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab, size=n) for n in (9, 3, 12)]
    out = {}
    for name, kw in {"flat": {}, "paged": dict(page_size=4), "chunked": dict(page_size=4, prefill_chunk=4)}.items():
        eng = Engine(tm, tp, n_slots=3, max_len=24, **kw)
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=7)) for p in prompts]
        while eng.has_work:
            eng.step()
        assert all(r.status == "ok" and len(r.tokens) == 7 for r in reqs)
        out[name] = [r.tokens for r in reqs]
    assert out["paged"] == out["flat"] and out["chunked"] == out["flat"]


def test_serve_launcher_phi_moe(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", ARCH, "--reduced", "--compress-alpha", "0.3", "--device", "cpu", "--gen", "5",
                       "--page-size", "4", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "[compress]" in out and "[continuous]" in out and "[paged]" in out
    assert all(r.status == "ok" and len(r.tokens) == 5 for r in done)
    assert "lowrank_matmul" in out and "two_gemm" in out
    # the expert stacks went through the stacked apply: L = n_experts, M = capacity 128
    assert f"({get_arch(ARCH, reduced=True).n_experts}, 128," in out
