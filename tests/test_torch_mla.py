"""The port's deepseek-v2 slice against the reference: multi-head latent
attention (MLA), the dense first layer, shared experts, the top-6
fixed-order combine, the whole reduced model, its compression and the
serving engine.

The reference's reduced deepseek-v2 config (3 layers: 1 dense + 2 MoE, d 64,
4 heads, q_lora 32, kv_lora 16, nope 16 / rope 8 / v 16, 8 experts top-2, 1
shared expert), and that config at top-6.  Inputs come from numpy seeds, the
reference's params cross through ``bridge.params_from_numpy``.

Tolerances: fp32 1e-4 (matmuls, softmax and rotary embeddings of two
frameworks, through three layers); bf16 5e-2 of the reference's largest
value (one ulp apart at a rounding boundary propagates); greedy tokens,
routing and compression decisions exactly; the port's own paged == flat,
chunked == monolithic and shared == unshared engine runs bit for bit.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.deepseek_v2_236b import CONFIG as J_FULL  # noqa: E402
from repro.configs.deepseek_v2_236b import REDUCED as J_REDUCED  # noqa: E402
from repro.configs.phi3_5_moe import REDUCED as J_PHI  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

jcompress = importlib.import_module("repro.core.compress")
compress = importlib.import_module("repro_torch.core.compress")
lowrank = importlib.import_module("repro_torch.core.lowrank")

ARCH = "deepseek-v2-236b"
DTYPES = ("float32", "bfloat16")
B, S, GEN = 2, 12, 4


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(J_REDUCED, dtype=dtype, **kw),
            dataclasses.replace(get_arch(ARCH, reduced=True), dtype=dtype, **kw))


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(tensor_to_numpy(got), want, **tol)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.dtype(dtype)), tree)


def _both(tree):
    """The same numpy-made values for both frameworks."""
    return tree, params_from_numpy(jax.device_get(tree), device="cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _jax_omega_fn(jparams, key):
    """The Omegas the reference's compress_tree draws: one key per leaf,
    split over every matrix of a stacked leaf in row-major order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    counts = {n: int(np.prod(leaf.shape[:-2])) for n, (_, leaf) in zip(names, flat)}
    keys = dict(zip(names, jax.random.split(key, len(names))))

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], counts[name])[layer]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))

    return omega_fn


POLICY = dict(alpha=0.3, q=2, min_dim=16)


@pytest.fixture(scope="module")
def trees():
    """Reference params (fp32, seed 0): dense, and compressed by the
    reference; the port's compression of the same dense tree with the
    reference's Omegas, and both reports."""
    jcfg, _ = _cfgs()
    dense = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    box = {}

    def jcompress_tree(p, k):  # one compile of the whole compression (eager: twice the time, the same bits)
        out, _, box["report"] = jcompress.compress_tree(p, jcompress.CompressionPolicy(**POLICY), k)
        return out

    jcomp = jax.jit(jcompress_tree)(dense, key)
    jrep = box["report"]
    tcomp, trep = compress.compress_tree(params_from_numpy(jax.device_get(dense), device="cpu"),
                                         compress.CompressionPolicy(**POLICY), omega_fn=_jax_omega_fn(dense, key))
    return {"dense": dense, "compressed": jcomp, "port_compressed": tcomp, "reports": (jrep, trep)}


# --------------------------------------------------------------------------- #
# the config and the parameter count
# --------------------------------------------------------------------------- #
def test_config_param_count_and_family():
    """CONFIG and REDUCED field for field (the reference's optimizer and
    accum_steps are training knobs the port's config lacks); the arch
    resolves and builds; the parameter count is the reference's in full, at
    the chip's 3 layers and reduced."""
    for reduced in (False, True):
        want = dataclasses.asdict(J_REDUCED if reduced else J_FULL)
        got = dataclasses.asdict(get_arch(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
        assert get_arch(ARCH, reduced=reduced).qk_head_dim == (J_REDUCED if reduced else J_FULL).qk_head_dim
    full = get_arch(ARCH)
    tlm._check_family(full)  # no field of it raises
    assert full.qk_head_dim == 192 and full.v_head_dim == 128
    assert analytic_param_count(full) == j_analytic_param_count(J_FULL) == 235_740_692_480
    three = dataclasses.replace(full, n_layers=3)
    assert analytic_param_count(three) == j_analytic_param_count(dataclasses.replace(J_FULL, n_layers=3)) \
        == 9_330_753_536
    assert analytic_param_count(get_arch(ARCH, reduced=True)) == j_analytic_param_count(J_REDUCED)


def test_init_tree_matches_reference():
    """Same tree, shapes and dtypes as the reference's lm_init: the
    ``dense_layers`` stack with MLA attention and a dense FFN, the MoE stack
    with MLA attention, routed and shared experts."""
    jcfg, tcfg = _cfgs("bfloat16")
    jflat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0)))
    want = {"/".join(p.key for p in path): (tuple(a.shape), str(a.dtype)) for path, a in jflat}
    tp = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = {path: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for path, t in compress._leaves(tp)}
    assert got == want
    assert "dense_layers/mlp/w_gate" in got and "layers/moe/shared/w_gate" in got and "layers/attn/wkv_b" in got


# --------------------------------------------------------------------------- #
# MLA, one function at a time
# --------------------------------------------------------------------------- #
def _layer0_attn(trees, dtype):
    jp = jax.tree_util.tree_map(lambda a: a[0], _cast(trees["dense"], dtype)["layers"]["attn"])
    return _both(jp)


def _x(shape, seed, dtype):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).astype(jnp.dtype(dtype))
    return _both(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_forward_matches_reference(trees, dtype):
    """The prefill: per-head K at q/k head dim 24 (nope 16 + rope 8) and V at
    16 through the port's flash (its plain version here), against the
    reference's chunked attention; the latent cache rows too."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _layer0_attn(trees, dtype)
    jx, tx = _x((B, S, jcfg.d_model), 1, dtype)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    want, (wc, wr) = jax.jit(lambda p, x, q: jattn.mla_forward(p, x, jcfg, positions=q, return_cache=True))(
        jp, jx, jnp.asarray(pos))
    dispatch.reset_counters()
    got, (gc, gr) = tattn.mla_forward(tp, tx, tcfg, positions=torch.as_tensor(pos), return_cache=True)
    # one flash call at q/k 24, v 16 (the signature names v's head dim when it differs)
    flash = {key: n for key, n in dispatch.counters().items() if key[0] == "flash_attention"}
    assert flash == {("flash_attention", "reference", ((B, S, 4, 24), 4, True, None, 16)): 1}
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        assert g.dtype == tx.dtype
        _close(g, w, dtype)


def test_flash_pallas_at_a_separate_v_head_dim_matches_plain():
    """The TPU kernel in interpret mode at q/k head dim 24 and v 16 against
    the port's plain flash (what the CUDA kernel is held to on the card)."""
    rng = np.random.default_rng(2)
    q, k = (rng.standard_normal((1, 64, 2, 24)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, bq=32, bkv=32,
                                  interpret=True)
    got = tref.chunked_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    assert tuple(got.shape) == (1, 64, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _latent_caches(cfg, n_rows, length, seed, dtype):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n_rows, length, cfg.kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((n_rows, length, cfg.qk_rope_dim)).astype(np.float32)
    return _both({"c_kv": jnp.asarray(c).astype(jnp.dtype(dtype)), "k_rope": jnp.asarray(r).astype(jnp.dtype(dtype))})


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_paths_match_reference(trees, dtype):
    """The absorbed-weight decode, flat and through permuted pages, and a
    page-backed chunk prefill with padded rows, against the reference's
    functions on the same caches; the flat and paged decode agree bit for
    bit in the port.  A NaN planted in the trash page reaches nothing."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _layer0_attn(trees, dtype)
    page, n_tbl = 4, 4
    L = page * n_tbl
    pos = np.array([9, 3], np.int32)
    jx, tx = _x((B, 1, jcfg.d_model), 3, dtype)
    (jc, tc) = _latent_caches(jcfg, B, L, 4, dtype)
    want, wcache = jax.jit(lambda *a: jattn.mla_decode(*a, jcfg))(jp, jx, jc, jnp.asarray(pos))
    flat = {k: v.clone() for k, v in tc.items()}
    got, _ = tattn.mla_decode(tp, tx, flat, torch.as_tensor(pos), tcfg)
    _close(got, want, dtype)
    for name in ("c_kv", "k_rope"):
        _close(flat[name], wcache[name], dtype)

    # the same logical caches scattered over permuted physical pages (+ the trash page)
    n_phys = B * n_tbl + 1
    perm = np.random.default_rng(5).permutation(B * n_tbl)
    bt = perm.reshape(B, n_tbl).astype(np.int32)
    pools = {}
    for name, arr in jc.items():
        a = np.asarray(jnp.asarray(arr, jnp.float32))
        pool = np.zeros((n_phys, page) + a.shape[2:], np.float32)
        pool[bt.reshape(-1)] = a.reshape((B * n_tbl, page) + a.shape[2:])
        pools[name] = jnp.asarray(pool).astype(jnp.dtype(dtype))
    jpool, tpool = _both(pools)
    tpool["c_kv"][-1] = float("nan")  # trash: read through no table entry, weighed by no query
    tpool_chunk = {k: v.clone() for k, v in tpool.items()}
    want_p, _ = jax.jit(lambda p, x, c, q, t: jattn.mla_decode_paged(p, x, c, q, jcfg, t))(
        jp, jx, jpool, jnp.asarray(pos), jnp.asarray(bt))
    tbt = torch.as_tensor(bt)
    got_p, _ = tattn.mla_decode_paged(tp, tx, tpool, torch.as_tensor(pos), tcfg, tbt)
    _close(got_p, want_p, dtype)
    assert torch.equal(got_p, got)

    # a chunk of 6 rows at position 5, 4 of them real, into slot 0's pages; the
    # gathered view's tail points at the NaN trash page
    C, start, n_real = 6, 5, 4
    jxc, txc = _x((1, C, jcfg.d_model), 6, dtype)
    row = np.concatenate([bt[0, :3], [n_phys - 1]]).astype(np.int32)
    jpool2 = dict(jpool)
    jpool2["c_kv"] = jpool["c_kv"].at[-1].set(0.0)
    want_c, wpool = jax.jit(lambda p, x, c, t: jattn.mla_prefill_chunk(p, x, c, jcfg, t, start, n_real))(
        jp, jxc, jpool2, jnp.asarray(row))
    got_c, _ = tattn.mla_prefill_chunk(tp, txc, tpool_chunk, tcfg, torch.as_tensor(row), start, n_real)
    assert bool(torch.isfinite(got_c[:, :n_real]).all())
    _close(got_c[:, :n_real], want_c[:, :n_real], dtype)
    for name in ("c_kv", "k_rope"):
        _close(tpool_chunk[name][:-1], wpool[name][:-1], dtype)


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
def _models(dtype, **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    return j_build_model(jcfg), build_model(tcfg, device="cpu")


def _jitted(jm):
    """The reference model's forward, prefill and decode step, each compiled
    once (the decode position traced, so every step reuses one program)."""
    return (jax.jit(jm.forward), jax.jit(jm.prefill, static_argnums=2),
            jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos)))


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_model_forward_prefill_and_decode_match_reference(trees, kind):
    """fp32: forward logits; the prefill's logits and latent caches (the
    ``dense_layers`` subtree included); 4 greedy decode steps on the flat
    cache and on a paged one, each step's logits against the reference's
    and equal greedy tokens.  The compressed model is the port's own
    compression with the reference's Omegas."""
    jm, tm = _models("float32")
    j_forward, j_prefill, j_decode = _jitted(jm)
    jp = trees[kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu") if kind == "dense" else trees["port_compressed"]
    assert lowrank.is_lowrank(tp["layers"]["attn"]["wkv_b"]) == (kind == "compressed")
    toks = _tokens(tm.cfg.vocab, (B, S), 0)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}
    want, want_aux = j_forward(jp, jb)
    got, aux = tm.forward(tp, tb)
    _close(got, want, "float32")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)

    max_len = S + GEN
    want_l, want_c = j_prefill(jp, jb, max_len)
    got_l, got_c = tm.prefill(tp, tb, max_len)
    _close(got_l, want_l, "float32")
    for sub in ("dense_layers", "layers"):
        for name in ("c_kv", "k_rope"):
            _close(got_c[sub][name], want_c[sub][name], "float32")

    page = 4
    n_pages = B * (max_len // page)
    pcache, mask = tm.init_cache_paged(B, max_len, page, n_pages)
    assert mask == {sub: {"c_kv": True, "k_rope": True} for sub in ("layers", "dense_layers")}
    bt = np.random.default_rng(7).permutation(n_pages).reshape(B, -1).astype(np.int32)
    pcache["block_table"].copy_(torch.as_tensor(bt))
    for sub in ("dense_layers", "layers"):
        for name, pool in pcache[sub].items():
            flat = got_c[sub][name]  # (L, B, max_len, *)
            pool[:, torch.as_tensor(bt.reshape(-1)).long()] = flat.reshape(
                (flat.shape[0], n_pages, page) + tuple(flat.shape[3:]))
    want_tok = np.asarray(jnp.argmax(want_l, -1))
    got_tok = torch.argmax(got_l, -1)
    ptok = got_tok.clone()
    for step in range(GEN):
        assert got_tok.tolist() == want_tok.tolist()
        want_d, want_c = j_decode(jp, want_c, jnp.asarray(want_tok[:, None], jnp.int32), jnp.int32(S + step))
        got_d, got_c = tm.decode_step(tp, got_c, got_tok[:, None], S + step)
        got_p, pcache = tm.decode_step(tp, pcache, ptok[:, None], torch.full((B,), S + step))
        _close(got_d, want_d, "float32")
        assert torch.equal(got_p, got_d)
        want_tok, got_tok, ptok = np.asarray(jnp.argmax(want_d, -1)), torch.argmax(got_d, -1), torch.argmax(got_p, -1)
    assert got_tok.tolist() == want_tok.tolist()


def test_bf16_forward_matches_reference(trees):
    """bf16 (the served dtype), the reference's compressed tree cast: forward
    and prefill logits within 5e-2 of the reference's largest.  Every
    expert is selected (top-8 of 8): at top-2 a token near a routing tie
    flips expert under one bf16 ulp (3 of 24 tokens here, 9-20% of the
    largest logit), which the fp32 tests rule out by holding the routing
    exactly."""
    jm, tm = _models("bfloat16", top_k=8)
    j_forward, j_prefill, _ = _jitted(jm)
    jp, tp = _both(_cast(trees["compressed"], "bfloat16"))
    toks = _tokens(tm.cfg.vocab, (B, S), 1)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}
    _close(tm.forward(tp, tb)[0], j_forward(jp, jb)[0], "bfloat16")
    _close(tm.prefill(tp, tb, S + 2)[0], j_prefill(jp, jb, S + 2)[0], "bfloat16")


def test_compression_decisions_match_reference(trees):
    """The port's compress_tree on the deepseek tree decides what the
    reference decides, ``dense_layers/...`` and the MLA leaves included
    (``q_norm`` / ``kv_norm`` scales never compressed), with the same ranks
    and parameter totals; the factored products agree."""
    jrep, trep = trees["reports"]
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    decisions = [(l.path, l.rank, l.compressed) for l in trep.layers]
    assert decisions == [(l.path, l.rank, l.compressed) for l in jrep.layers]
    by_path = {p: c for p, _, c in decisions}
    for path in ("dense_layers/attn/wq_b", "dense_layers/mlp/w_gate", "layers/attn/wkv_b",
                 "layers/moe/experts/w_gate", "layers/moe/shared/w_up", "lm_head"):
        assert by_path[path], path
    assert not any(c for p, c in by_path.items() if p.endswith("norm/scale") or "router" in p or p == "embed")
    jcomp, tcomp = trees["compressed"], trees["port_compressed"]
    for sub, group, name in (("dense_layers", "attn", "wkv_b"), ("layers", "attn", "wq_b"),
                             ("layers", "moe", "shared")):
        jleaf, tleaf = jcomp[sub][group][name], tcomp[sub][group][name]
        if "a" not in jleaf:
            jleaf, tleaf = jleaf["w_down"], tleaf["w_down"]
        want = np.asarray(jnp.matmul(jleaf["a"], jleaf["b"]))
        got = torch.matmul(tleaf["a"], tleaf["b"]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------------------- #
# the combine
# --------------------------------------------------------------------------- #
def _moe_pair(cfg_j, seed):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    return _both(jp)


def test_top6_moe_matches_reference():
    """At top-6 of 8 experts with a shared expert: the port's moe_forward
    (its fixed-order combine) against the reference's, output and aux loss,
    in fp32; the routing is the reference's."""
    jcfg, tcfg = _cfgs(top_k=6)
    jp, tp = _moe_pair(jcfg, 3)
    jx, tx = _x((2, 24, jcfg.d_model), 8, "float32")
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(jp, jx)
    got, aux = tmoe.moe_forward(tp, tx, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)
    j_ids = np.asarray(jax.jit(lambda x, w: jmoe._route(x, w, jcfg)[0])(jx.reshape(-1, jcfg.d_model),
                                                                        jp["router"]["gate_w"]))
    t_ids = tmoe._route(tx.reshape(-1, tcfg.d_model), tp["router"]["gate_w"], tcfg)[0]
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)


def test_top6_combine_is_independent_of_dispatch_order():
    """Relabel the experts (permute the expert stacks and the routed ids to
    match): every token takes the same experts in the same rank order with
    the same gates, but its assignments land in other slots of the dispatch
    buffer, so a scatter-add would meet them in another order.  The
    fixed-order combine gives the same bits."""
    jcfg, tcfg = _cfgs(top_k=6)
    _, tp = _moe_pair(jcfg, 4)
    E = tcfg.n_experts
    perm = torch.as_tensor(np.random.default_rng(9).permutation(E))  # new label j holds old expert perm[j]
    inv = torch.argsort(perm)
    relabelled = {k: v[perm].contiguous() for k, v in tp["experts"].items()}
    _, tx = _x((48, tcfg.d_model), 10, "float32")
    ids, gates, _ = tmoe._route(tx, tp["router"]["gate_w"], tcfg)
    assert not torch.equal(inv[ids], ids)
    for C in (128, 24):  # every assignment kept; some dropped
        want = tmoe._dispatch_compute_combine(tx, ids, gates, tp["experts"], C, E, tx.dtype)
        got = tmoe._dispatch_compute_combine(tx, inv[ids], gates, relabelled, C, E, tx.dtype)
        assert torch.equal(got, want)


def _index_add_combine(xf, ids, gates, experts, C, E, dtype):
    """The combine the port had before the fixed-order one, written out: a
    scatter-add of the (E*C, d) weighted expert rows into zeros."""
    T, d = xf.shape
    K = ids.shape[-1]
    ids_flat = ids.reshape(-1)
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    seg_start = torch.searchsorted(sorted_ids, torch.arange(E, dtype=sorted_ids.dtype))
    pos_sorted = torch.arange(T * K) - seg_start[torch.clamp(sorted_ids, max=E - 1)]
    pos_flat = torch.empty_like(pos_sorted)
    pos_flat[order] = pos_sorted
    keep = (pos_flat < C) & (ids_flat < E)
    slot = torch.where(keep, ids_flat * C + pos_flat, torch.full_like(ids_flat, E * C))
    slot_tok = tmoe._scatter_drop(E * C, slot, torch.arange(T * K) // K)
    slot_gate = tmoe._scatter_drop(E * C, slot, gates.reshape(-1).float())
    occupied = tmoe._scatter_drop(E * C, slot, keep.float())
    buf = (xf[slot_tok].float() * occupied[:, None]).to(dtype).reshape(E, C, d)
    h = tmoe.nn.swiglu(tmoe.nn.dense(experts["w_gate"], buf), tmoe.nn.dense(experts["w_up"], buf))
    y = tmoe.nn.dense(experts["w_down"], h).reshape(E * C, d)
    weighted = y.float() * (slot_gate * occupied)[:, None]
    return torch.zeros((T, d), dtype=torch.float32).index_add_(0, slot_tok, weighted)


@pytest.mark.parametrize("dtype", DTYPES)
def test_top2_combine_is_the_index_add_bits(dtype):
    """On phi3.5-moe's reduced config (top-2), with drops at capacity factor
    0.5: the fixed-order combine gives the bits of the scatter-add into
    zeros, so phi's bitwise gates hold unchanged."""
    tcfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b", reduced=True), dtype=dtype)
    _, tp = _both(jmoe.moe_init(jax.random.PRNGKey(5), dataclasses.replace(J_PHI, dtype=dtype), jnp.dtype(dtype)))
    _, tx = _x((4, 64, tcfg.d_model), 11, dtype)
    xf = tx.reshape(-1, tcfg.d_model)
    ids, gates, _ = tmoe._route(xf, tp["router"]["gate_w"], tcfg)
    for C in (128, 32):  # every assignment kept; some dropped
        got = tmoe._dispatch_compute_combine(xf, ids, gates, tp["experts"], C, tcfg.n_experts, tx.dtype)
        want = _index_add_combine(xf, ids, gates, tp["experts"], C, tcfg.n_experts, tx.dtype)
        assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
MAX_LEN = 24


def _drive(eng, make_request, prompts, steps):
    """Request 1 arrives two engine steps after request 0."""
    reqs = [eng.submit(make_request(prompts[0], steps[0]))]
    eng.step()
    eng.step()
    reqs.append(eng.submit(make_request(prompts[1], steps[1])))
    while eng.has_work:
        eng.step()
    return [list(r.tokens) for r in reqs]


def test_engine_matches_reference_engine(trees):
    """Compressed reduced deepseek-v2 in fp32, staggered admission: the
    port's paged + chunked engine (chunk = page, the absorbed path) emits
    the reference engine's greedy tokens; in the port flat, paged, and paged
    + chunked emit the same tokens bit for bit."""
    jm, tm = _models("float32")
    jp, tp = _both(trees["compressed"])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(n,)).astype(np.int32) for n in (10, 5)]
    steps = (6, 5)
    kw = dict(page_size=4, prefill_chunk=4)
    want = _drive(JEngine(jm, jp, n_slots=2, max_len=MAX_LEN, **kw),
                  lambda p, s: JRequest(prompt=p, max_new_tokens=s), prompts, steps)
    out = {}
    for name, mode in {"flat": {}, "paged": dict(page_size=4), "chunked": kw}.items():
        out[name] = _drive(Engine(tm, tp, n_slots=2, max_len=MAX_LEN, **mode),
                           lambda p, s: Request(prompt=p, max_new_tokens=s), prompts, steps)
    assert out["chunked"] == want
    assert out["paged"] == out["flat"] == out["chunked"]


def test_engine_shared_prefix_equals_unshared(trees):
    """A system prefix of 2 full pages at chunk = page: the follower maps
    them read-only (the latent pools of both stacks) and every request
    emits the unshared run's tokens bit for bit."""
    _, tm = _models("float32")
    tp = trees["port_compressed"]
    rng = np.random.default_rng(1)
    sys = rng.integers(0, tm.cfg.vocab, size=8)
    prompts = [np.concatenate([sys, rng.integers(0, tm.cfg.vocab, size=n)]) for n in (2, 3)]
    outs = {}
    for share in (False, True):
        eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, share_prefix=share, prefill_chunk=4)
        r0 = eng.submit(Request(prompt=prompts[0], max_new_tokens=4))
        while not r0.tokens:
            eng.step()
        eng.step()
        r1 = eng.submit(Request(prompt=prompts[1], max_new_tokens=5))
        while eng.has_work:
            eng.step()
        outs[share] = [r0.tokens, r1.tokens]
        if share:
            assert eng.shared_page_hits == 2 and eng.skipped_prefill_tokens == 8
        assert eng.pages_in_use == 0
    assert outs[True] == outs[False]


def test_serve_launcher_deepseek(capsys):
    """``--arch deepseek-v2-236b --reduced`` on the static and the
    continuous engine, compressed: the expert stacks as one stacked apply
    (L = 8 experts, M = capacity 128) and the absorbed path's products
    counted under their own op name."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--engine", "static", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--compress-alpha", "0.3"])
    out = capsys.readouterr().out
    assert "flash_attention" in out and dispatch.MLA_OP in out
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--gen", "4", "--compress-alpha", "0.3",
                       "--page-size", "4", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "[continuous]" in out and "[paged]" in out and dispatch.MLA_OP in out
    assert all(r.status == "ok" and len(r.tokens) == 4 for r in done)
    assert f"({get_arch(ARCH, reduced=True).n_experts}, 128," in out
