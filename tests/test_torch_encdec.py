"""The port's whisper-small slice against the reference: LayerNorm, the
tanh GELU and sinusoidal positions; the encoder (non-causal self-attention
without rotary embedding over every frame); the decoder's causal
self-attention, cross-attention over the encoder states and its caches
(self K/V paged, cross K/V slot-resident); compression; per-request audio
frames through the serving engine, preemption included; and the flash
kernel's non-causal path against the reference's Pallas kernel.

The reference's reduced config (2 encoder + 2 decoder layers, d 64, 4
heads, head_dim 16, 32 frames).  Inputs and frames come from numpy seeds
(both packages' ``SyntheticLM`` and ``modality_extras`` draw alike); the
reference's params cross through ``bridge.params_from_numpy``.

Tolerances: fp32 1e-4 (matmuls, softmax, LayerNorm and transcendentals of
two frameworks through four blocks); the modules 1e-6 in fp32 (one op
each), one ulp in bf16 (1e-5 near zero, where GELU's 1 + tanh cancels);
bf16 5e-2 of the reference's largest value; greedy tokens and compression
decisions exactly; the port's own flat == paged decode bit for bit.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.whisper_small import CONFIG as J_FULL  # noqa: E402
from repro.configs.whisper_small import REDUCED as J_REDUCED  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, modality_extras  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import modules as tnn  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

jcompress = importlib.import_module("repro.core.compress")
compress = importlib.import_module("repro_torch.core.compress")
lowrank = importlib.import_module("repro_torch.core.lowrank")

ARCH = "whisper-small"
B, S, GEN = 2, 8, 3
POLICY = dict(alpha=0.3, q=2, min_dim=16)


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


def _batch(seed):
    """A SyntheticLM batch of both packages (the same numpy draws)."""
    jb = JSyntheticLM(J_REDUCED, B, S, kind="serve", seed=seed).at_step(0)
    tb = SyntheticLM(get_arch(ARCH, reduced=True), B, S, kind="serve", seed=seed).at_step(0)
    assert set(jb) == set(tb) == {"tokens", "frames"}
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {"tokens": torch.as_tensor(tb["tokens"], dtype=torch.int64), "frames": torch.as_tensor(tb["frames"])})


# --------------------------------------------------------------------------- #
# the config, the parameter count, the tree and the modules
# --------------------------------------------------------------------------- #
def test_config_param_count_and_init_tree(trees):
    """CONFIG and REDUCED field for field; the full count is the reference's
    278,003,712 (vocab 51865 padded to 51968); the port's init tree has the
    reference's paths, shapes and dtypes, and the bridge carries the
    reference's params as they are."""
    for reduced in (False, True):
        want = dataclasses.asdict(J_REDUCED if reduced else J_FULL)
        got = dataclasses.asdict(get_arch(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
    assert get_arch(ARCH).vocab_padded == J_FULL.vocab_padded == 51968
    assert analytic_param_count(get_arch(ARCH)) == j_analytic_param_count(J_FULL) == 278_003_712
    assert analytic_param_count(get_arch(ARCH, reduced=True)) == j_analytic_param_count(J_REDUCED)
    jcfg, tcfg = _cfgs("bfloat16")
    jflat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0)))
    want = {"/".join(p.key for p in path): (tuple(a.shape), str(a.dtype)) for path, a in jflat}
    tp = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = {path: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for path, t in compress._leaves(tp)}
    assert got == want
    assert got["dec_layers/cross/wk"][0] == (2, 64, 64) and got["enc_layers/attn_norm/bias"][0] == (2, 64)
    bridged = dict(compress._leaves(params_from_numpy(jax.device_get(trees["dense"]), device="cpu")))
    for path, leaf in jax.tree_util.tree_flatten_with_path(trees["dense"])[0]:
        np.testing.assert_array_equal(bridged["/".join(p.key for p in path)].numpy(), np.asarray(leaf))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_layernorm_gelu_and_positions_match_reference(dtype):
    """LayerNorm (fp32 mean and population variance, scale and bias), the
    GELU (jax.nn.gelu's tanh form: torch's exact default sits ~1e-3 away)
    and the sinusoidal table, against the reference's modules."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32), "bias": rng.standard_normal(64).astype(np.float32)}
    jx, tx = _both(jnp.asarray(x).astype(jnp.dtype(dtype)))
    jp, tp = _both(_cast(jax.tree_util.tree_map(jnp.asarray, p), dtype))
    # bf16: one ulp, and 1e-5 near zero, where GELU's 1 + tanh cancels and the two fp32 tanh differ
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2**-8, atol=1e-5)
    for got, want in ((tnn.layernorm(tp, tx), jnn.layernorm(jp, jx)),
                      (tnn.gelu(tx), jax.nn.gelu(jx.astype(jnp.float32)).astype(jx.dtype))):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(tensor_to_numpy(got), np.asarray(want.astype(jnp.float32)), **tol)
    exact = torch.nn.functional.gelu(tx.float()).to(tx.dtype)
    assert not torch.equal(exact, tnn.gelu(tx))
    np.testing.assert_allclose(tnn.sinusoidal_positions(1500, 768).numpy(),
                               np.asarray(jnn.sinusoidal_positions(1500, 768)), rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_encoder_matches_reference(trees, dtype):
    """The encoder over 32 frames: each layer's self-attention through the
    flash kernel's non-causal path (its plain version here) at G = 1,
    without rotary embedding, then enc_norm."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_cast(trees["dense"], dtype))
    frames = np.random.default_rng(4).standard_normal((B, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
    dispatch.reset_counters()
    got = ted.encdec_encode(tp, torch.from_numpy(frames), tcfg)
    want = jax.jit(lambda p, f: jed.encdec_encode(p, f, jcfg))(jp, jnp.asarray(frames))
    _close(got, want, dtype)
    flash = {key: n for key, n in dispatch.counters().items() if key[0] == "flash_attention"}
    assert flash == {("flash_attention", "reference", ((B, 32, 4, 16), 4, False, None)): 2}


@pytest.mark.parametrize("Sq", [1, 50])
def test_flash_pallas_non_causal_matches_plain(Sq):
    """The TPU kernel in interpret mode, causal=False, over 50 keys (off its
    32-key block) with one query and with 50, against the port's plain
    flash (what the CUDA kernel is held to on the card)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, Sq, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 50, 2, 16)).astype(np.float32) for _ in range(2))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, bq=32, bkv=32,
                                  interpret=True)
    got = tref.chunked_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_model_forward_prefill_and_decode_match_reference(trees, jitted, kind):
    """fp32: forward logits; prefill logits and both caches (the prompt's
    unrotated self K/V, the encoder states' cross K/V); 3 greedy decode
    steps on the flat cache and on a paged one (self K/V over permuted
    pages, its position table over the pages' span, cross K/V slot rows),
    logits against the reference's at each step, equal greedy tokens,
    flat == paged bit for bit.  The compressed model is the port's own
    compression with the reference's Omegas."""
    jm, j_forward, j_prefill, j_decode = jitted
    tm = build_model(_cfgs()[1], device="cpu")
    jp = trees[kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu") if kind == "dense" else trees["port_compressed"]
    assert lowrank.is_lowrank(tp["lm_head"]) == (kind == "compressed")
    jb, tb = _batch(0)
    _close(tm.forward(tp, tb)[0], j_forward(jp, jb)[0], "float32")

    max_len = S + GEN + 1
    want_l, want_c = j_prefill(jp, jb, max_len)
    got_l, got_c = tm.prefill(tp, tb, max_len)
    _close(got_l, want_l, "float32")
    for sub in ("self", "cross_kv"):
        for name in ("k", "v"):
            _close(got_c[sub][name], want_c[sub][name], "float32")

    page = 4
    n_pages = B * (max_len // page)
    pcache, mask = tm.init_cache_paged(B, max_len, page, n_pages)
    assert mask == {"self": {"k": True, "v": True}, "cross_kv": {"k": False, "v": False}}
    bt = np.random.default_rng(7).permutation(n_pages).reshape(B, -1).astype(np.int32)
    pcache["block_table"].copy_(torch.as_tensor(bt))
    for name, pool in pcache["self"].items():
        flat = got_c["self"][name]
        pool[:, torch.as_tensor(bt.reshape(-1)).long()] = flat.reshape((flat.shape[0], n_pages, page) + flat.shape[3:])
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


def test_decode_rotates_where_the_prompt_does_not(trees):
    """The reference caveat the port keeps: rope_theta moves no prompt logit
    (the prompt has no rotary embedding) but moves a decode step's (the
    shared GQA decode rotates Q and K)."""
    tp = params_from_numpy(jax.device_get(trees["dense"]), device="cpu")
    _, tb = _batch(2)
    out = []
    for theta in (10_000.0, 500_000.0):
        tm = build_model(_cfgs(rope_theta=theta)[1], device="cpu")
        logits, cache = tm.prefill(tp, tb, S + 2)
        out.append((logits, tm.decode_step(tp, cache, torch.argmax(logits, -1)[:, None], S)[0]))
    assert torch.equal(out[0][0], out[1][0]) and not torch.equal(out[0][1], out[1][1])


def test_bf16_forward_and_prefill_match_reference(trees):
    """bf16, the reference's compressed tree cast: forward and prefill
    logits within 5e-2 of the reference's largest."""
    jcfg, tcfg = _cfgs("bfloat16")
    jm, tm = j_build_model(jcfg), build_model(tcfg, device="cpu")
    jp, tp = _both(_cast(trees["compressed"], "bfloat16"))
    jb, tb = _batch(1)
    _close(tm.forward(tp, tb)[0], jax.jit(jm.forward)(jp, jb)[0], "bfloat16")
    _close(tm.prefill(tp, tb, S + 2)[0], jax.jit(jm.prefill, static_argnums=2)(jp, jb, S + 2)[0], "bfloat16")


def test_compression_decisions_match_reference(trees):
    """The port's compress_tree decides what the reference decides on
    ``enc_layers``, ``dec_layers`` (self and cross attention, FFN) and the
    head, with the same ranks and totals; no LayerNorm scale or bias is
    compressed; the factored products agree."""
    jrep, trep = trees["reports"]
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    decisions = [(l.path, l.rank, l.compressed) for l in trep.layers]
    assert decisions == [(l.path, l.rank, l.compressed) for l in jrep.layers]
    by_path = {p: c for p, _, c in decisions}
    for path in ("enc_layers/attn/wq", "enc_layers/mlp/w_up", "dec_layers/attn/wo", "dec_layers/cross/wk",
                 "dec_layers/mlp/w_down", "lm_head"):
        assert by_path[path], path
    assert not any(c for p, c in by_path.items() if "norm/" in p or p == "embed")
    for sub, name in (("enc_layers", "attn"), ("dec_layers", "cross")):
        jleaf, tleaf = trees["compressed"][sub][name]["wv"], trees["port_compressed"][sub][name]["wv"]
        want = np.asarray(jnp.matmul(jleaf["a"], jleaf["b"]))
        got = torch.matmul(tleaf["a"], tleaf["b"]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------------------- #
# the engine: per-request audio frames
# --------------------------------------------------------------------------- #
def _requests(cfg, lens, steps, seed, make):
    """Requests whose prompts and frames both packages draw alike."""
    rng = np.random.default_rng(seed)
    out = []
    for n, s in zip(lens, steps):
        prompt = rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
        out.append(make(prompt, s, modality_extras(cfg, rng)))
    return out


def _solo(tm, tp, r, steps, max_len):
    return greedy_generate(tm, tp, {"tokens": torch.as_tensor(r.prompt[None]),
                                    "frames": torch.as_tensor(r.extras["frames"][None])},
                           steps=steps, max_len=max_len)[0].tolist()


def test_engine_matches_reference_engine(trees):
    """Compressed reduced whisper in fp32, three requests of their own frames,
    the third arriving two steps late: the port's flat and paged engines
    emit the reference paged engine's greedy tokens and the static path's;
    the same prompt over other frames gets other first logits."""
    jm = j_build_model(_cfgs()[0])
    tm = build_model(_cfgs()[1], device="cpu")
    jp, tp = trees["compressed"], trees["port_compressed"]
    lens, steps = (10, 5, 7), (6, 5, 4)

    def drive(eng, make):
        reqs = _requests(tm.cfg, lens, steps, 0, make)
        for r in reqs[:2]:
            eng.submit(r)
        eng.step()
        eng.step()
        eng.submit(reqs[2])
        while eng.has_work:
            eng.step()
        return [list(r.tokens) for r in reqs], reqs

    want, _ = drive(JEngine(jm, jp, n_slots=2, max_len=24, page_size=4, decode_block=2),
                    lambda p, s, e: JRequest(prompt=p, max_new_tokens=s, extras=e))
    for mode in ({}, dict(page_size=4, prefill_chunk=4)):
        got, reqs = drive(Engine(tm, tp, n_slots=2, max_len=24, decode_block=2, **mode),
                          lambda p, s, e: Request(prompt=p, max_new_tokens=s, extras=e))
        assert got == want, mode
    assert got == [_solo(tm, tp, r, s, 24) for r, s in zip(reqs, steps)]
    other = dict(reqs[0].extras, frames=reqs[1].extras["frames"])
    logits = [tm.prefill(tp, {"tokens": torch.as_tensor(reqs[0].prompt[None]),
                              "frames": torch.as_tensor(e["frames"][None])}, 12)[0] for e in (reqs[0].extras, other)]
    assert not torch.equal(logits[0], logits[1])


def test_preempted_request_resumes_with_its_frames(trees):
    """A pool that holds one of two requests: the priority-1 arrival preempts
    the running one, whose continuation carries its frames into the
    re-prefill (encoder included) and finishes with its uninterrupted
    tokens; both streams are the reference Engine's."""
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
    assert got == [_solo(tm, tp, r, s, 24) for r, s in zip(reqs, steps)]


def test_serve_launcher_whisper(capsys):
    """``--arch whisper-small --reduced``, compressed, on the static and the
    continuous engine: the encoder's non-causal flash over the 32 frames,
    the decoder prompt's causal one and cross-attention's."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--engine", "static", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--compress-alpha", "0.3"])
    assert tuple(out.shape) == (2, 3)
    text = capsys.readouterr().out
    for sig in ("((2, 32, 4, 16), 4, False, None)", "((2, 8, 4, 16), 4, True, None)",
                "((2, 8, 4, 16), 4, False, None)", "((2, 1, 4, 16), 4, False, None)"):
        assert sig in text, sig
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--gen", "4", "--compress-alpha", "0.3",
                       "--page-size", "4"])
    text = capsys.readouterr().out
    assert "[continuous]" in text and "[paged]" in text and "paged_decode_attention" in text
    assert all(r.status == "ok" and len(r.tokens) == 4 for r in done)
