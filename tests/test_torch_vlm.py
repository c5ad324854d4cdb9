"""The port's llama-3.2-vision slice against the reference: the vlm family
(groups of GQA self blocks and one cross-attention block over per-request
image embeddings), its caches (the self stack paged, the cross K/V
slot-resident), its compression, and per-request images through the
serving engine, preemption included.

The reference's reduced config (5 layers: one group of 4 self blocks and a
cross block; d 64, 4/2 heads, head_dim 16, 16 image tokens).  Inputs and
images come from numpy seeds (``modality_extras`` of both packages on the
same generator); the reference's params cross through
``bridge.params_from_numpy``.

Tolerances: fp32 1e-4 (matmuls, softmax and rotary embeddings of two
frameworks through five blocks); bf16 5e-2 of the reference's largest
value; greedy tokens and compression decisions exactly; the port's own
flat == paged decode bit for bit.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.llama3_2_vision_11b import CONFIG as J_FULL  # noqa: E402
from repro.configs.llama3_2_vision_11b import REDUCED as J_REDUCED  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.synthetic import modality_extras as j_modality_extras  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, modality_extras  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

jcompress = importlib.import_module("repro.core.compress")
compress = importlib.import_module("repro_torch.core.compress")
lowrank = importlib.import_module("repro_torch.core.lowrank")

ARCH = "llama-3.2-vision-11b"
B, S, GEN = 2, 8, 3
POLICY = dict(alpha=0.3, q=2, min_dim=16)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(J_REDUCED, dtype=dtype),
            dataclasses.replace(get_arch(ARCH, reduced=True), dtype=dtype))


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(tensor_to_numpy(got), want, **tol)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.dtype(dtype)), tree)


def _both(tree):
    return tree, params_from_numpy(jax.device_get(tree), device="cpu")


def _jax_omega_fn(jparams, key):
    """The Omegas the reference's compress_tree draws (one key a leaf, split
    over every matrix of a stacked leaf in row-major order)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    counts = {n: int(np.prod(leaf.shape[:-2])) for n, (_, leaf) in zip(names, flat)}
    keys = dict(zip(names, jax.random.split(key, len(names))))

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], counts[name])[layer]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))

    return omega_fn


@pytest.fixture(scope="module")
def trees():
    """Reference params (fp32, seed 0), dense and compressed by the
    reference; the port's compression of the same tree with the
    reference's Omegas; both reports."""
    jcfg, _ = _cfgs()
    dense = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    box = {}

    def jcompress_tree(p, k):
        out, _, box["report"] = jcompress.compress_tree(p, jcompress.CompressionPolicy(**POLICY), k)
        return out

    jcomp = jax.jit(jcompress_tree)(dense, key)
    tcomp, trep = compress.compress_tree(params_from_numpy(jax.device_get(dense), device="cpu"),
                                         compress.CompressionPolicy(**POLICY), omega_fn=_jax_omega_fn(dense, key))
    return {"dense": dense, "compressed": jcomp, "port_compressed": tcomp, "reports": (box["report"], trep)}


@pytest.fixture(scope="module")
def jitted():
    """The reference model's forward, prefill and decode step (fp32), each
    compiled once."""
    jm = j_build_model(_cfgs()[0])
    return (jm, jax.jit(jm.forward), jax.jit(jm.prefill, static_argnums=2),
            jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos)))


def _batch(cfg, seed):
    """A SyntheticLM batch of both packages (the same numpy draws): the
    reference's as jax arrays, the port's as tensors."""
    jb = JSyntheticLM(J_REDUCED, B, S, kind="serve", seed=seed).at_step(0)
    tb = SyntheticLM(cfg, B, S, kind="serve", seed=seed).at_step(0)
    assert set(jb) == set(tb) == {"tokens", "image_embed"}
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {"tokens": torch.as_tensor(tb["tokens"], dtype=torch.int64),
             "image_embed": torch.as_tensor(tb["image_embed"])})


# --------------------------------------------------------------------------- #
# the config, the parameter count and the tree
# --------------------------------------------------------------------------- #
def test_config_param_count_and_init_tree(trees):
    """CONFIG and REDUCED field for field; the full count is the reference's
    9,976,152,064; the port's init tree has the reference's paths, shapes
    and dtypes (``layers/self/...`` stacked (n_groups, n_self, ...),
    ``layers/cross/...`` (n_groups, ...)), and the bridge carries the
    reference's params with both stack axes as they are."""
    for reduced in (False, True):
        want = dataclasses.asdict(J_REDUCED if reduced else J_FULL)
        got = dataclasses.asdict(get_arch(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
    assert analytic_param_count(get_arch(ARCH)) == j_analytic_param_count(J_FULL) == 9_976_152_064
    assert analytic_param_count(get_arch(ARCH, reduced=True)) == j_analytic_param_count(J_REDUCED)
    jcfg, tcfg = _cfgs("bfloat16")
    jflat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0)))
    want = {"/".join(p.key for p in path): (tuple(a.shape), str(a.dtype)) for path, a in jflat}
    tp = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = {path: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for path, t in compress._leaves(tp)}
    assert got == want
    assert got["layers/self/attn/wk"][0] == (1, 4, 64, 32) and got["layers/cross/cross/wk"][0] == (1, 64, 64)
    bridged = dict(compress._leaves(params_from_numpy(jax.device_get(trees["dense"]), device="cpu")))
    for path, leaf in jax.tree_util.tree_flatten_with_path(trees["dense"])[0]:
        np.testing.assert_array_equal(bridged["/".join(p.key for p in path)].numpy(), np.asarray(leaf))


# --------------------------------------------------------------------------- #
# cross-attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_cross_attention_matches_reference(trees, dtype):
    """cross_attn_kv over 16 image tokens, then cross_attn with S queries
    (prefill) and one (decode): the flash kernel's non-causal path (its
    plain version here) against the reference's chunked attention, one
    call each at G = 1."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(jax.tree_util.tree_map(lambda a: a[0], _cast(trees["dense"], dtype)["layers"]["cross"]["cross"]))
    rng = np.random.default_rng(1)
    img = rng.standard_normal((B, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)
    jimg, timg = _both(jnp.asarray(img).astype(jnp.dtype(dtype)))
    wk, wv = jax.jit(lambda p, c: jattn.cross_attn_kv(p, c, jcfg))(jp, jimg)
    gk, gv = tattn.cross_attn_kv(tp, timg, tcfg)
    _close(gk, wk, dtype)
    _close(gv, wv, dtype)
    for Sq in (S, 1):
        x = rng.standard_normal((B, Sq, jcfg.d_model)).astype(np.float32)
        jx, tx = _both(jnp.asarray(x).astype(jnp.dtype(dtype)))
        want = jax.jit(lambda p, x, k, v: jattn.cross_attn(p, x, (k, v), jcfg))(jp, jx, wk, wv)
        dispatch.reset_counters()
        got = tattn.cross_attn(tp, tx, (gk, gv), tcfg)
        assert got.dtype == tx.dtype
        _close(got, want, dtype)
        flash = {key: n for key, n in dispatch.counters().items() if key[0] == "flash_attention"}
        assert flash == {("flash_attention", "reference", ((B, Sq, 4, 16), 4, False, None)): 1}


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
def _flat_self(c):
    """The reference's (n_groups, n_self, B, S, KV, hd) self stack as the port's flattened one."""
    return {n: c[n].reshape((-1,) + c[n].shape[2:]) for n in ("k", "v")}


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_model_forward_prefill_and_decode_match_reference(trees, jitted, kind):
    """fp32: forward logits; prefill logits and both caches (the self stack,
    flattened over the groups, and the image's cross K/V); 3 greedy decode
    steps on the flat cache and on a paged one (the self stack scattered
    over permuted pages, cross K/V slot rows), logits against the
    reference's at each step, equal greedy tokens, flat == paged bit for
    bit.  The compressed model is the port's own compression with the
    reference's Omegas."""
    jm, j_forward, j_prefill, j_decode = jitted
    tm = build_model(_cfgs()[1], device="cpu")
    jp = trees[kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu") if kind == "dense" else trees["port_compressed"]
    assert lowrank.is_lowrank(tp["layers"]["cross"]["cross"]["wk"]) == (kind == "compressed")
    jb, tb = _batch(tm.cfg, 0)
    _close(tm.forward(tp, tb)[0], j_forward(jp, jb)[0], "float32")

    max_len = S + GEN
    want_l, want_c = j_prefill(jp, jb, max_len)
    got_l, got_c = tm.prefill(tp, tb, max_len)
    _close(got_l, want_l, "float32")
    for name, t in _flat_self(want_c["layers"]["self"]).items():
        _close(got_c["layers"][name], t, "float32")
    for name in ("k", "v"):
        _close(got_c["cross_kv"][name], want_c["layers"]["cross_kv"][name], "float32")

    page = 4
    n_pages = B * (-(-max_len // page))
    pcache, mask = tm.init_cache_paged(B, max_len, page, n_pages)
    assert mask == {"layers": {"k": True, "v": True}, "cross_kv": {"k": False, "v": False}}
    bt = np.random.default_rng(7).permutation(n_pages).reshape(B, -1).astype(np.int32)
    pcache["block_table"].copy_(torch.as_tensor(bt))
    for name, pool in pcache["layers"].items():
        flat = torch.nn.functional.pad(got_c["layers"][name], (0, 0, 0, 0, 0, n_pages // B * page - max_len))
        pool[:, torch.as_tensor(bt.reshape(-1)).long()] = flat.reshape((flat.shape[0], n_pages, page) + flat.shape[3:])
    for name in ("k", "v"):
        pcache["cross_kv"][name].copy_(got_c["cross_kv"][name])
    want_tok = np.asarray(jnp.argmax(want_l, -1))
    got_tok = torch.argmax(got_l, -1)
    for step in range(GEN):
        assert got_tok.tolist() == want_tok.tolist()
        want_d, want_c = j_decode(jp, want_c, jnp.asarray(want_tok[:, None], jnp.int32), jnp.int32(S + step))
        got_d, got_c = tm.decode_step(tp, got_c, got_tok[:, None], S + step)
        got_p, pcache = tm.decode_step(tp, pcache, got_tok[:, None], torch.full((B,), S + step))
        _close(got_d, want_d, "float32")
        assert torch.equal(got_p, got_d)
        want_tok, got_tok = np.asarray(jnp.argmax(want_d, -1)), torch.argmax(got_d, -1)
    assert got_tok.tolist() == want_tok.tolist()


def test_bf16_forward_and_prefill_match_reference(trees):
    """bf16 (the served dtype), the reference's compressed tree cast: forward
    and prefill logits within 5e-2 of the reference's largest."""
    jcfg, tcfg = _cfgs("bfloat16")
    jm, tm = j_build_model(jcfg), build_model(tcfg, device="cpu")
    jp, tp = _both(_cast(trees["compressed"], "bfloat16"))
    jb, tb = _batch(tcfg, 1)
    _close(tm.forward(tp, tb)[0], jax.jit(jm.forward)(jp, jb)[0], "bfloat16")
    _close(tm.prefill(tp, tb, S + 2)[0], jax.jit(jm.prefill, static_argnums=2)(jp, jb, S + 2)[0], "bfloat16")


def test_compression_decisions_match_reference(trees):
    """The port's compress_tree decides what the reference decides on the
    two-level self stack and the cross blocks, with the same ranks and
    totals (decisions, not skip reasons); the factored products agree."""
    jrep, trep = trees["reports"]
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    decisions = [(l.path, l.rank, l.compressed) for l in trep.layers]
    assert decisions == [(l.path, l.rank, l.compressed) for l in jrep.layers]
    by_path = {p: c for p, _, c in decisions}
    for path in ("layers/self/attn/wq", "layers/self/attn/wk", "layers/self/mlp/w_down", "layers/cross/cross/wk",
                 "layers/cross/cross/wo", "layers/cross/mlp/w_gate", "lm_head"):
        assert by_path[path], path
    assert not any(c for p, c in by_path.items() if p.endswith("norm/scale") or p == "embed")
    for sub, name in (("self", "attn"), ("cross", "cross")):
        jleaf = trees["compressed"]["layers"][sub][name]["wk"]
        tleaf = trees["port_compressed"]["layers"][sub][name]["wk"]
        want = np.asarray(jnp.matmul(jleaf["a"], jleaf["b"]))
        got = torch.matmul(tleaf["a"], tleaf["b"]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------------------- #
# the engine: per-request images
# --------------------------------------------------------------------------- #
MAX_LEN = 24


def _requests(cfg, lens, steps, seed, make):
    """Requests whose prompts and images both packages draw alike."""
    rng = np.random.default_rng(seed)
    out = []
    for n, s in zip(lens, steps):
        prompt = rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
        out.append(make(prompt, s, modality_extras(cfg, rng)))
    return out


def test_engine_matches_reference_engine(trees):
    """Compressed reduced vision in fp32, three requests of their own images,
    the third arriving two steps late: the port's flat and paged engines
    emit the reference paged engine's greedy tokens; the image payloads are
    the reference's draws; a request with the first one's prompt and
    another image gets other first logits."""
    jm = j_build_model(_cfgs()[0])
    tm = build_model(_cfgs()[1], device="cpu")
    jp, tp = trees["compressed"], trees["port_compressed"]
    lens, steps = (10, 5, 7), (6, 5, 4)
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(j_modality_extras(J_REDUCED, rng_j)["image_embed"],
                                  modality_extras(tm.cfg, rng_t)["image_embed"])

    def drive(eng, make):
        reqs = _requests(tm.cfg, lens, steps, 0, make)
        for r in reqs[:2]:
            eng.submit(r)
        eng.step()
        eng.step()
        eng.submit(reqs[2])
        while eng.has_work:
            eng.step()
        return [list(r.tokens) for r in reqs]

    want = drive(JEngine(jm, jp, n_slots=2, max_len=MAX_LEN, page_size=4, decode_block=2),
                 lambda p, s, e: JRequest(prompt=p, max_new_tokens=s, extras=e))
    for mode in ({}, dict(page_size=4, prefill_chunk=4)):
        got = drive(Engine(tm, tp, n_slots=2, max_len=MAX_LEN, decode_block=2, **mode),
                    lambda p, s, e: Request(prompt=p, max_new_tokens=s, extras=e))
        assert got == want, mode
    r = _requests(tm.cfg, (10, 10), (1, 1), 0, lambda p, s, e: (p, e))
    logits = [tm.prefill(tp, {"tokens": torch.as_tensor(r[0][0][None], dtype=torch.int64),
                              "image_embed": torch.as_tensor(e["image_embed"][None])}, 12)[0]
              for e in (r[0][1], r[1][1])]
    assert not torch.equal(logits[0], logits[1])


def test_preempted_request_resumes_with_its_image(trees):
    """A pool that holds one of two requests: the priority-1 arrival preempts
    the running one, whose continuation carries its image into the
    re-prefill and finishes with its uninterrupted tokens; both streams are
    the reference Engine's, one preemption, no page left."""
    jm = j_build_model(_cfgs()[0])
    tm = build_model(_cfgs()[1], device="cpu")
    jp, tp = trees["compressed"], trees["port_compressed"]
    steps = (9, 5)

    def trace(eng, make):
        reqs = _requests(tm.cfg, (8, 8), steps, 12, make)
        reqs[1].priority = 1
        r0 = eng.submit(reqs[0])
        eng.step()
        eng.step()
        emitted = len(r0.tokens)
        eng.submit(reqs[1])
        while eng.has_work:
            eng.step()
        return [r.tokens for r in reqs], (emitted, eng.preemptions, eng.pages_in_use, r0.status), reqs

    kw = dict(n_slots=2, max_len=24, page_size=4, kv_pages=5, preempt=True, decode_block=2)
    want, jstate, _ = trace(JEngine(jm, jp, **kw), lambda p, s, e: JRequest(prompt=p, max_new_tokens=s, extras=e))
    got, state, reqs = trace(Engine(tm, tp, **kw), lambda p, s, e: Request(prompt=p, max_new_tokens=s, extras=e))
    assert got == want and state == jstate
    assert 0 < state[0] < steps[0] and state[1:] == (1, 0, "ok")
    solo = [greedy_generate(tm, tp, {"tokens": torch.as_tensor(r.prompt[None]),
                                     "image_embed": torch.as_tensor(r.extras["image_embed"][None])},
                            steps=s, max_len=24)[0].tolist() for r, s in zip(reqs, steps)]
    assert got == solo


def test_export_inflight_and_take_queue_keep_the_image(trees):
    """export_inflight evicts an active request as a continuation holding its
    image and take_queue hands back a waiter as submitted; a second engine
    finishes both with their uninterrupted tokens."""
    tm = build_model(_cfgs()[1], device="cpu")
    tp = trees["port_compressed"]
    reqs = _requests(tm.cfg, (6, 9), (7, 4), 21, lambda p, s, e: Request(prompt=p, max_new_tokens=s, extras=e))
    eng = Engine(tm, tp, n_slots=1, max_len=24, page_size=4, decode_block=2)
    for r in reqs:
        eng.submit(r)
    eng.step()
    queued, moved = eng.take_queue(), eng.export_inflight()
    assert queued == [reqs[1]] and len(moved) == 1 and moved[0].extras is reqs[0].extras
    other = Engine(tm, tp, n_slots=2, max_len=24, page_size=4, decode_block=2)
    for r in moved + queued:
        other.submit(r)
    while other.has_work:
        other.step()
    for r in reqs:
        solo = greedy_generate(tm, tp, {"tokens": torch.as_tensor(r.prompt[None]),
                                        "image_embed": torch.as_tensor(r.extras["image_embed"][None])},
                               steps=r.max_new_tokens, max_len=24)[0].tolist()
        assert r.status == "ok" and r.tokens == solo


def test_serve_launcher_vlm(capsys):
    """``--arch llama-3.2-vision-11b --reduced``, compressed, on the static
    and the continuous engine: each request's image through the
    cross-attention flash calls (non-causal, prefill and Sq = 1 decode)."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--engine", "static", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--compress-alpha", "0.3"])
    assert tuple(out.shape) == (2, 3)
    text = capsys.readouterr().out
    assert "((2, 8, 4, 16), 4, False, None)" in text and "((2, 1, 4, 16), 4, False, None)" in text
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--gen", "4", "--compress-alpha", "0.3",
                       "--page-size", "4", "--prefill-chunk", "8"])
    text = capsys.readouterr().out
    assert "[continuous]" in text and "[paged]" in text and "prefill_chunks=0" in text
    assert all(r.status == "ok" and len(r.tokens) == 4 for r in done)
