"""The port's paged decode path, held against the reference.

The paged flash-decode wrapper runs its plain PyTorch version on the CPU
(the CUDA kernel builds and runs only on a card, tests/test_torch_gpu.py);
the same seeded numpy inputs go through the JAX Pallas kernel in interpret
mode and through ``repro.kernels.ref``.  Pages sit at permuted physical
ids behind a trash page full of finite poison, ``n_valid`` crosses page
boundaries and one row is fully masked.  Then the model pieces of the
paged path (``gqa_decode_paged``, ``gqa_prefill_chunk``,
``lm_prefill_chunk``) against their JAX twins, and the port's own exact
rules: the gathered view equals a flat cache bit for bit, paged decode
equals flat decode, chunked prefill equals monolithic prefill.

Tolerances: the kernel fp32 2e-5 (another summation order) and bf16 3e-2
(one bf16 ulp is 2^-8 relative, and both sides round the same
intermediates but may land on neighbouring values); layers and models, as
tests/test_torch_model.py holds them, fp32 1e-4 (transcendentals and
matmuls of two frameworks) and bf16 5e-2 of the reference's largest value
(a value one ulp apart propagates through the layers).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.llama3_2_1b import REDUCED as J_REDUCED  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.paged_decode_attention import paged_decode_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _model_close(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(tensor_to_numpy(got), want, **tol)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _paged_inputs(B, n_tbl, page, KV, G, hd, seed=0, poison=1e4):
    """q, a pool whose pages sit at PERMUTED physical ids behind a trash page
    of finite poison, the block table, and the flat cache the pages hold."""
    rng = np.random.default_rng(seed)
    S, P = n_tbl * page, B * n_tbl + 1
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32) / hd**0.25
    flat_k = rng.standard_normal((B, S, KV, hd)).astype(np.float32) / hd**0.25
    flat_v = rng.standard_normal((B, S, KV, hd)).astype(np.float32) / hd**0.25
    bt = rng.permutation(P - 1).reshape(B, n_tbl).astype(np.int32)
    k_pool = np.full((P, page, KV, hd), poison, np.float32)
    v_pool = np.full((P, page, KV, hd), -poison, np.float32)
    for b in range(B):
        for j in range(n_tbl):
            k_pool[bt[b, j]] = flat_k[b, j * page : (j + 1) * page]
            v_pool[bt[b, j]] = flat_v[b, j * page : (j + 1) * page]
    return q, k_pool, v_pool, bt, flat_k, flat_v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("page,n_tbl", [(1, 9), (4, 5), (16, 3)])
def test_paged_decode_matches_pallas_and_ref(page, n_tbl, G, dtype):
    B, KV, hd = 4, 2, 16
    q, kp, vp, bt, _, _ = _paged_inputs(B, n_tbl, page, KV, G, hd, seed=page + G)
    S = n_tbl * page
    # full, crossing a page boundary (one past it), fully masked, one position
    n_valid = np.array([S, min(S, page + 1), 0, 1], np.int32)
    bt[3, -1] = B * n_tbl  # a table entry past n_valid on the trash page
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    got = paged_decode_attention(tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(n_valid))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (B, 1, KV * G, hd)
    assert bool((got[2] == 0).all()), "a fully-masked row must give zeros"
    jbt, jnv = jnp.asarray(bt), jnp.asarray(n_valid)
    for want in (paged_decode_attention_pallas(jq, jk, jv, jbt, jnv, interpret=True),
                 jref.paged_decode_attention_ref(jq, jk, jv, jbt, jnv)):
        np.testing.assert_allclose(tensor_to_numpy(got), np.asarray(want, np.float32), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_pages_is_the_flat_cache_bit_for_bit(dtype):
    B, n_tbl, page, KV, G, hd = 3, 4, 8, 2, 4, 16
    q, kp, vp, bt, fk, fv = _paged_inputs(B, n_tbl, page, KV, G, hd, seed=1)
    td = DTYPES[dtype][1]
    tq, tk, tv, tfk, tfv = (torch.from_numpy(x).to(td) for x in (q, kp, vp, fk, fv))
    tbt = torch.from_numpy(bt)
    assert torch.equal(tref.gather_pages(tk, tbt), tfk)
    assert torch.equal(tref.gather_pages(tv, tbt), tfv)
    S = n_tbl * page
    n_valid = torch.tensor([S, 11, 27], dtype=torch.int32)
    valid = torch.arange(S)[None, :] < n_valid[:, None]
    assert torch.equal(tref.paged_decode_attention_ref(tq, tk, tv, tbt, n_valid),
                       tref.decode_attention_ref(tq, tfk, tfv, valid))


def test_dispatch_routes_paged_decode_to_the_plain_version_on_cpu():
    q, kp, vp, bt, _, _ = _paged_inputs(2, 3, 4, 2, 2, 16)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt)] + [torch.tensor([5, 12], dtype=torch.int32)]
    assert dispatch.choose_paged_decode_path(device_type="cpu") == "reference"
    assert dispatch.choose_paged_decode_path(device_type="cuda") == "kernel"
    with dispatch.use_dispatch(backend="reference"):
        assert dispatch.choose_paged_decode_path(device_type="cuda") == "reference"
    dispatch.reset_counters()
    dispatch.paged_decode_attention(*args)
    assert dispatch.counters_by_path() == {("paged_decode_attention", "reference"): 1}
    # a call inside a capture extent is counted for the graph, then once per replay
    dispatch.reset_counters()
    with dispatch.recording_capture() as calls:
        dispatch.paged_decode_attention(*args)
    assert dispatch.counters() == {} and sum(calls.values()) == 1
    dispatch.add_replays(calls, 3)
    assert dispatch.counters_by_path() == {("paged_decode_attention", "reference"): 3}


def test_paged_write_routes_dead_rows_to_trash():
    pool = torch.zeros((5, 4, 1, 2))  # 4 pages + trash (id 4)
    row = torch.tensor([2, 0, 4], dtype=torch.int32)
    pos = torch.arange(3, 9)  # positions 3..8: pages 0 (pos 3), 1 (4-7), 2 (8)
    rows = torch.arange(1.0, 7.0)[:, None, None].expand(6, 1, 2)
    live = torch.arange(6) < 4
    tattn._paged_write(pool, row, pos, rows, live=live)
    assert float(pool[2, 3, 0, 0]) == 1.0  # pos 3 -> page row[0] = 2
    assert [float(pool[0, i, 0, 0]) for i in range(3)] == [2.0, 3.0, 4.0]  # pos 4-6 -> page 0
    assert float(pool[0, 3].abs().sum()) == 0.0  # pos 7 was dead: it went to trash
    assert float(pool[4].abs().sum()) > 0
    assert tattn.trash_page(pool) == 4


# --------------------------------------------------------------------------- #
# model pieces of the paged path, against their JAX twins
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _lm(dtype):
    """The reduced llama, reference and port, with the reference's params
    bridged (built once per dtype; the tests only read them)."""
    jcfg = dataclasses.replace(J_REDUCED, dtype=dtype)
    tcfg = dataclasses.replace(get_arch("llama3.2-1b", reduced=True), dtype=dtype)
    jm, tm = j_build_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _layer0(dtype):
    """Layer 0's attention params of the reduced llama, reference and port."""
    jm, tm, jp, tp = _lm(dtype)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    return jm.cfg, tm.cfg, jl, {k: v[0] for k, v in tp["layers"]["attn"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_paged_matches_reference_and_flat(dtype):
    jcfg, tcfg, jl, tl = _layer0(dtype)
    B, page, n_tbl = 3, 4, 4
    KV, hd, d = tcfg.n_kv_heads, tcfg.head_dim, tcfg.d_model
    _, kp, vp, bt, fk, fv = _paged_inputs(B, n_tbl, page, KV, 1, hd, seed=3)
    x = np.random.default_rng(4).standard_normal((B, 1, d)).astype(np.float32)
    pos = np.array([5, 0, 14], np.int32)
    (jx, tx), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (x, kp, vp))
    want, wc = jattn.gqa_decode_paged(jl, jx, {"k": jk, "v": jv}, jnp.asarray(pos), jcfg, jnp.asarray(bt))
    tbt = torch.from_numpy(bt)
    cache = {"k": tk.clone(), "v": tv.clone()}
    got, gc = tattn.gqa_decode_paged(tl, tx, cache, torch.from_numpy(pos).long(), tcfg, tbt)
    assert gc["k"].data_ptr() == cache["k"].data_ptr()  # written in place
    _model_close(got, want, dtype)
    _model_close(gc["k"], wc["k"], dtype)
    # the flat layout holding the same cache gives the same bits
    flat = {"k": tref.gather_pages(tk, tbt).clone(), "v": tref.gather_pages(tv, tbt).clone()}
    got_flat, _ = tattn.gqa_decode(tl, tx, flat, torch.from_numpy(pos).long(), tcfg)
    assert torch.equal(got_flat, got)
    assert torch.equal(flat["k"], tref.gather_pages(gc["k"], tbt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start,n_real", [(0, 5), (4, 3), (7, 1), (6, 5)])  # mid-page: a COW re-entry, a rewrite
def test_gqa_prefill_chunk_matches_reference(dtype, start, n_real):
    jcfg, tcfg, jl, tl = _layer0(dtype)
    C, page, n_tbl = 5, 4, 4
    KV, hd, d = tcfg.n_kv_heads, tcfg.head_dim, tcfg.d_model
    _, kp, vp, bt, _, _ = _paged_inputs(1, n_tbl, page, KV, 1, hd, seed=5)
    x = np.random.default_rng(6).standard_normal((1, C, d)).astype(np.float32)
    (jx, tx), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (x, kp, vp))
    want, wc = jattn.gqa_prefill_chunk(jl, jx, {"k": jk, "v": jv}, jcfg, jnp.asarray(bt[0]), start, n_real)
    cache = {"k": tk.clone(), "v": tv.clone()}
    got, gc = tattn.gqa_prefill_chunk(tl, tx, cache, tcfg, torch.from_numpy(bt[0]), start, n_real)
    _model_close(got[:, :n_real], np.asarray(want, np.float32)[:, :n_real], dtype)
    real = bt[0]  # the pages: the trash page (last) took the padded rows on both sides, in any order
    for name in ("k", "v"):
        _model_close(gc[name][torch.from_numpy(real).long()], np.asarray(wc[name], np.float32)[real], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_chunk_matches_reference_and_monolithic(dtype):
    """Chunk after chunk through the paged cache: logits and pages against
    the JAX twin; inside the port, bit for bit the monolithic prefill at the
    engine's bucketed prompt shape (the CPU's vectorized sums keep their
    order when only whole vectors of exact zeros are added)."""
    jm, tm, jp, tp = _lm(dtype)
    L, C, page, max_len, n_pages = 11, 4, 4, 16, 6
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab, size=(1, L))
    row = np.array([3, 0, 5, 1], np.int32)  # permuted pages
    jc, _ = jm.init_cache_paged(1, max_len, page, n_pages)
    tc, mask = tm.init_cache_paged(1, max_len, page, n_pages)
    assert mask == {"layers": {"k": True, "v": True}}
    assert tc["block_table"].dtype == torch.int32 and bool((tc["block_table"] == n_pages).all())
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
    # the engine's monolithic prefill: right-padded to its power-of-two bucket
    padded = np.zeros((1, 16), np.int64)
    padded[0, :L] = toks[0]
    mono, mc = tm.prefill(tp, {"tokens": torch.from_numpy(padded)}, max_len, last_index=torch.tensor([L - 1]))
    assert torch.equal(got, mono)
    for name in ("k", "v"):
        gathered = tref.gather_pages(tc["layers"][name][0], torch.from_numpy(row)[None])[0, :L]
        assert torch.equal(gathered, mc["layers"][name][0, 0, :L])


def test_lm_decode_step_paged_equals_flat():
    """One decode step of the whole model through a block table gives the
    flat cache's logits bit for bit, and writes the same K/V."""
    _, tm, _, tp = _lm("float32")
    B, page, max_len = 2, 4, 12
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, tm.cfg.vocab, size=(B, 6)))
    _, flat = tm.prefill(tp, {"tokens": toks}, max_len)
    paged, _ = tm.init_cache_paged(B, max_len, page, 8)
    bt = torch.tensor([[5, 2, 7], [0, 6, 1]], dtype=torch.int32)
    paged["block_table"].copy_(bt)
    for name in ("k", "v"):  # the flat cache's rows, page by page
        for b in range(B):
            for j in range(3):
                paged["layers"][name][:, bt[b, j]] = flat["layers"][name][:, b, j * page:(j + 1) * page]
    nxt = torch.tensor([[3], [9]])
    pos = torch.tensor([6, 6])
    want, flat = tm.decode_step(tp, flat, nxt, pos)
    got, paged = tm.decode_step(tp, paged, nxt, pos)
    assert torch.equal(got, want)
    for name in ("k", "v"):
        for b in range(B):
            assert torch.equal(tref.gather_pages(paged["layers"][name][0], bt[b:b + 1])[0],
                               flat["layers"][name][0, b])
