"""h2o-danube-1.8b in the port: the sliding-window ring cache, held against
the reference.

Reduced h2o-danube (2 layers, d 64, 4/2 heads, head_dim 16, window W = 32),
in fp32, the reference's params bridged in; inputs from numpy seeds.

* ``gqa_forward`` at S < W, S = W and S > W: the output at rtol/atol 1e-5,
  and the returned cache slot for slot, the ring order exact (slot i holds
  the position p with p % W == i, bit for bit the prefill's own K/V) and
  its values at 1e-5 of the reference's.
* ``gqa_decode`` for steps that cross the wrap (a ring of W slots):
  outputs and every slot of the cache at 1e-5.
* ``lm_prefill`` plus 40 decode steps (fed the reference's greedy tokens):
  logits at rtol/atol 1e-4 (summation order and transcendental
  implementations differ between the frameworks), greedy tokens equal.
* The engine, with prompts shorter and longer than W, flat and with
  ``page_size`` (zero pages: the ring is a slot row), on params compressed
  by the port's RSI and handed to both: the reference ``Engine``'s greedy
  tokens, exact-length prefill groups past the window; two rank tiers at
  once; a preempted request past its window resumes with the reference's
  tokens.
* head_dim 80 (h2o's own), at reduced width: the plain flash and decode
  versions against the reference's ``_flash_fwd_pass`` (several q and KV
  chunks) and ``decode_attention`` over a wrapped ring, at 1e-5.

One module-scoped reference build and compression serve the whole file.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import CompressionPolicy, compress_tree, spectralize_params  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

ARCH = "h2o-danube-1.8b"
TOL = dict(rtol=1e-5, atol=1e-5)  # one attention layer in fp32: only the summation order differs
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # two layers and the head in fp32


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_get_arch(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(get_arch(ARCH, reduced=True), dtype=dtype))


@pytest.fixture(scope="module")
def h2o():
    """(reference model, its fp32 params, port model, the same params bridged)."""
    jcfg, tcfg = _cfgs()
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg, device="cpu"), params_from_numpy(jax.device_get(jp), device="cpu")


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(np.ascontiguousarray(tree.numpy()))


@pytest.fixture(scope="module")
def h2o_compressed(h2o):
    """The port's params spectralized and compressed by its RSI (alpha 0.5, q 2,
    min_dim 16), and the same factors in the reference's tree."""
    jm, _, tm, _ = h2o
    tp = spectralize_params(tm.init(torch.Generator().manual_seed(0)), torch.Generator().manual_seed(9))
    tp, rep = compress_tree(tp, CompressionPolicy(alpha=0.5, q=2, min_dim=16), generator=torch.Generator().manual_seed(1))
    assert any(layer.compressed for layer in rep.layers)
    return jm, _to_jax(tp), tm, tp


def _np(x):
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# the config
# --------------------------------------------------------------------------- #
def test_config_is_the_reference_config():
    for reduced in (False, True):
        want = dataclasses.asdict(j_get_arch(ARCH, reduced=reduced))
        got = dataclasses.asdict(get_arch(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
    cfg = get_arch(ARCH)
    assert (cfg.sliding_window, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (4096, 80, 4)
    assert not cfg.tie_embeddings and 80 in HEAD_DIMS


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_matches_reference(reduced):
    n = analytic_param_count(get_arch(ARCH, reduced=reduced))
    assert n == j_analytic_param_count(j_get_arch(ARCH, reduced=reduced))
    if not reduced:
        assert 1.8e9 < n < 1.9e9


def test_bridge_carries_h2o_params_as_they_are(h2o):
    """h2o adds no kind of leaf: every reference leaf crosses with its path,
    shape, dtype and bits, in fp32 and bf16."""
    _, jp, tm, tp = h2o
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = dict(_flat(tp))
    assert sorted(jflat) == sorted(tflat)
    for path, leaf in jflat.items():
        assert tuple(tflat[path].shape) == leaf.shape and tflat[path].dtype == torch.float32
        np.testing.assert_array_equal(tflat[path].numpy(), np.asarray(leaf))
    own = dict(_flat(tm.init(torch.Generator().manual_seed(0))))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: tuple(t.shape) for p, t in tflat.items()}
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = params_from_numpy(jax.device_get(jb), device="cpu")
    w = jb["layers"]["attn"]["wq"]
    assert tb["layers"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["layers"]["attn"]["wq"].view(torch.int16).numpy(), np.asarray(w).view(np.int16))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


# --------------------------------------------------------------------------- #
# the attention layer: prefill ring, decode across the wrap
# --------------------------------------------------------------------------- #
def _layer0(h2o):
    jm, jp, tm, tp = h2o
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    return jm.cfg, jl, tm.cfg, tl


_j_forward = jax.jit(jattn.gqa_forward, static_argnames=("cfg", "return_cache"))
_j_decode = jax.jit(jattn.gqa_decode, static_argnames=("cfg",))


@pytest.mark.parametrize("S", [20, 32, 45])
def test_gqa_forward_ring_matches_reference(h2o, S):
    """S < W, S = W, and S > W (a ring rotated by S % W = 13): the output,
    and the cache slot for slot."""
    jcfg, jl, tcfg, tl = _layer0(h2o)
    W = tcfg.sliding_window
    x = np.random.default_rng(S).standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jout, (jk, jv) = _j_forward(jl, jnp.asarray(x), cfg=jcfg, return_cache=True)
    tout, (tk, tv) = tattn.gqa_forward(tl, torch.from_numpy(x), tcfg, return_cache=True)
    np.testing.assert_allclose(tout.numpy(), _np(jout), **TOL)
    assert tuple(tk.shape) == jk.shape == (2, min(S, W), tcfg.n_kv_heads, tcfg.head_dim)
    # the ring order, exact: slot i holds the prefill's own K/V of the position p >= S - W with p % W == i
    _, (fk, fv) = tattn.gqa_forward(tl, torch.from_numpy(x), dataclasses.replace(tcfg, sliding_window=None),
                                    return_cache=True)
    for i in range(min(S, W)):
        p = i if S <= W else next(p for p in range(S - W, S) if p % W == i)
        assert torch.equal(tk[:, i], fk[:, p]) and torch.equal(tv[:, i], fv[:, p])
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


def test_gqa_decode_across_the_wrap_matches_reference(h2o):
    """A prompt of W - 3 positions, then 8 decode steps on a ring of W slots:
    the ring fills at step 3 and wraps from step 4; every step's output and
    every slot match the reference's."""
    jcfg, jl, tcfg, tl = _layer0(h2o)
    W, B, d = tcfg.sliding_window, 2, tcfg.d_model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, W - 3, d)).astype(np.float32)
    _, (jk, jv) = _j_forward(jl, jnp.asarray(x), cfg=jcfg, return_cache=True)
    jc = jattn.gqa_init_cache(jcfg, B, 64, jnp.float32)
    tc = tattn.gqa_init_cache(tcfg, B, 64, torch.float32, "cpu")
    assert tc["k"].shape[1] == jc["k"].shape[1] == W
    jc = {"k": jc["k"].at[:, : W - 3].set(jk), "v": jc["v"].at[:, : W - 3].set(jv)}
    tc["k"][:, : W - 3] = torch.from_numpy(np.array(jk))
    tc["v"][:, : W - 3] = torch.from_numpy(np.array(jv))
    for step in range(8):
        xt = rng.standard_normal((B, 1, d)).astype(np.float32)
        pos = W - 3 + step
        jout, jc = _j_decode(jl, jnp.asarray(xt), jc, jnp.int32(pos), cfg=jcfg)
        tout, tc = tattn.gqa_decode(tl, torch.from_numpy(xt), tc, pos, tcfg)
        np.testing.assert_allclose(tout.numpy(), _np(jout), **TOL)
        np.testing.assert_allclose(tc["k"].numpy(), _np(jc["k"]), **TOL)
        np.testing.assert_allclose(tc["v"].numpy(), _np(jc["v"]), **TOL)


def test_ring_cache_is_never_paged(h2o):
    _, _, tm, _ = h2o
    cfg = tm.cfg
    assert tattn.gqa_init_cache_paged(cfg, 4, 9, torch.float32, "cpu") == (None, False)
    cache, mask = lm_mod.lm_init_cache_paged(cfg, 3, 200, page_size=4, n_pages=10, device="cpu")
    assert mask == {"layers": {"k": False, "v": False}}
    assert tuple(cache["layers"]["k"].shape) == (cfg.n_layers, 3, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim)
    assert tm.prefill_chunk is None
    with pytest.raises(ValueError, match="sliding window"):
        lm_mod.lm_prefill_chunk(tm.init(torch.Generator().manual_seed(0)), cache, torch.zeros((1, 4), dtype=torch.long),
                                cfg, bt_row=cache["block_table"][0], start=0, n_real=4)
    # the ring's bytes do not grow with max_len past the window
    small = lm_mod.lm_init_cache(cfg, 2, cfg.sliding_window, "cpu")
    big = lm_mod.lm_init_cache(cfg, 2, 20 * cfg.sliding_window, "cpu")
    assert all(small["layers"][n].shape == big["layers"][n].shape for n in ("k", "v"))


# --------------------------------------------------------------------------- #
# the model: prefill, then 40 decode steps through the wrap
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [20, 45])
def test_prefill_and_40_decode_steps_match_reference(h2o, S):
    """fp32: the prefill's logits and ring, then 40 decode steps fed the
    reference's greedy tokens (crossing position W, and 2W for S = 45):
    logits at 1e-4 every step, greedy tokens equal."""
    jm, jp, tm, tp = h2o
    steps, max_len = 40, S + 40
    toks = np.random.default_rng(S).integers(0, tm.cfg.vocab, size=(2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, max_len)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc["layers"]["k"].numpy(), _np(jc["layers"]["k"]), **TOL)
    jstep = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
    want, got = [np.asarray(jtok)[:, 0]], [tl.argmax(-1).numpy()]
    for i in range(steps):
        jl, jc = jstep(jp, jc, jtok, jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(np.array(jtok)).long(), S + i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
        jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(jtok)[:, 0])
        got.append(tl.argmax(-1).numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    # the port's own greedy loop gives the same tokens
    out = greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks).long()}, steps=steps + 1, max_len=max_len)
    np.testing.assert_array_equal(out.numpy(), np.stack(want, 1))


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]


def _run(eng, make, prompts, steps):
    reqs = [eng.submit(make(p, s)) for p, s in zip(prompts, steps)]
    while eng.has_work:
        eng.step()
    return [r.tokens for r in reqs]


ENGINE_LENS, ENGINE_STEPS = (40, 11, 35, 40, 25, 32), (6, 12, 7, 9, 10, 8)  # W = 32


@pytest.fixture(scope="module")
def engine_reference(h2o_compressed):
    """The reference Engine's greedy tokens on the engine trace (flat pool)."""
    jm, jp, tm, _ = h2o_compressed
    prompts = _prompts(tm.cfg, ENGINE_LENS)
    eng = JEngine(jm, jp, n_slots=4, max_len=ENGINE_LENS[0] + 24, decode_block=4)
    return prompts, _run(eng, lambda p, s: JRequest(prompt=p, max_new_tokens=s), prompts, ENGINE_STEPS)


@pytest.mark.parametrize("page_size", [None, 4])
def test_engine_matches_reference_across_the_window(h2o_compressed, engine_reference, page_size):
    """Prompts shorter and longer than W (two of one length past it) on 4
    slots, 6-12 new tokens: the reference Engine's greedy tokens, flat and
    paged with zero pages reserved; past the window, one prefill group per
    prompt length, never padded; below it, the pad capped at W."""
    _, _, tm, tp = h2o_compressed
    W = tm.cfg.sliding_window
    prompts, want = engine_reference
    steps = ENGINE_STEPS
    eng = Engine(tm, tp, n_slots=4, max_len=W + 32, page_size=page_size, decode_block=4)
    got = _run(eng, lambda p, s: Request(prompt=p.astype(np.int64), max_new_tokens=s), prompts, steps)
    assert got == want
    assert eng.peak_pages_in_use == 0 and not eng._has_pages
    for rows, P, group in eng.prefill_batches:
        if max(group) > W:
            assert len(set(group)) == 1 and P == group[0]
        else:
            assert P <= W
    assert any(len(g) == 2 and g[0] > W for _, _, g in eng.prefill_batches)  # the two W + 8 prompts together
    solo = [greedy_generate(tm, tp, {"tokens": torch.from_numpy(p[None]).long()}, steps=s, max_len=W + 32)[0].tolist()
            for p, s in zip(prompts, steps)]
    assert got == solo


def test_engine_zero_page_lifecycle_on_a_one_page_pool(h2o):
    """The reference's tests/test_scheduler.py zero-page case: a 1-page pool
    never gates the ring, admission stays slot-gated."""
    _, _, tm, tp = h2o
    eng = Engine(tm, tp, n_slots=2, max_len=16, page_size=4, kv_pages=1, decode_block=1)
    assert not eng._has_pages
    reqs = [eng.submit(Request(prompt=p.astype(np.int64), max_new_tokens=3)) for p in _prompts(tm.cfg, (4, 4, 4))]
    eng.step()
    assert eng.n_active == 2 and eng.n_waiting == 1
    assert all(g.pages == [] for g in eng.scheduler.slot_pages.values())
    assert eng.pages_in_use == 0 and eng.kv_bytes_in_use == eng._bytes_resident
    while eng.has_work:
        eng.step()
    assert all(len(r.tokens) == 3 for r in reqs)
    assert eng.pages_in_use == 0 and eng.peak_pages_in_use == 0


def test_preempted_request_past_its_window_resumes_with_reference_tokens(h2o_compressed):
    """One slot: a priority-1 arrival preempts a request whose prompt is
    already past the window; its continuation (prompt + tokens so far, a
    prefill of its own exact length) finishes with its uninterrupted tokens,
    as in the reference Engine."""
    jm, jp, tm, tp = h2o_compressed
    W = tm.cfg.sliding_window
    prompts, steps = _prompts(tm.cfg, (W + 5, 9), seed=12), (14, 5)

    def trace(eng, make):
        r0 = eng.submit(make(prompts[0], steps[0], 0))
        eng.step()
        eng.step()
        emitted = len(r0.tokens)
        r1 = eng.submit(make(prompts[1], steps[1], 1))
        while eng.has_work:
            eng.step()
        return [r0.tokens, r1.tokens], (emitted, eng.preemptions, r0.status), eng

    kw = dict(n_slots=1, max_len=64, page_size=4, preempt=True, decode_block=2)
    want, jstate, _ = trace(JEngine(jm, jp, **kw), lambda p, s, pr: JRequest(prompt=p, max_new_tokens=s, priority=pr))
    got, state, eng = trace(Engine(tm, tp, **kw),
                            lambda p, s, pr: Request(prompt=p.astype(np.int64), max_new_tokens=s, priority=pr))
    assert got == want and state == jstate
    assert 0 < state[0] < steps[0] and state[1:] == (1, "ok")
    assert any(P == W + 5 + state[0] for _, P, _ in eng.prefill_batches)  # the continuation, past W, unpadded
    solo = [greedy_generate(tm, tp, {"tokens": torch.from_numpy(p[None]).long()}, steps=s, max_len=64)[0].tolist()
            for p, s in zip(prompts, steps)]
    assert got == solo


def test_tiers_past_the_window_match_reference(h2o_compressed):
    """Rank tiers (1.0, 0.5) at once, prompts below and past the window on
    both tiers: the reference Engine's greedy tokens tier by tier (prefill
    groups split by tier, then by exact length past W; the frozen slots of
    the other tier re-feed their ring slot)."""
    jm, jp, tm, tp = h2o_compressed
    W = tm.cfg.sliding_window
    prompts, steps, tiers = _prompts(tm.cfg, (W + 8, 12, W + 8, 25), seed=5), (6, 8, 5, 7), (0, 1, 1, 0)
    kw = dict(n_slots=4, max_len=W + 24, page_size=4, tiers=(1.0, 0.5), tier_q=2, decode_block=4)

    def trace(eng, make):
        reqs = [eng.submit(make(p, s, t)) for p, s, t in zip(prompts, steps, tiers)]
        while eng.has_work:
            eng.step()
        return [r.tokens for r in reqs]

    want = trace(JEngine(jm, jp, **kw), lambda p, s, t: JRequest(prompt=p, max_new_tokens=s, tier=t))
    eng = Engine(tm, tp, **kw)
    assert trace(eng, lambda p, s, t: Request(prompt=p.astype(np.int64), max_new_tokens=s, tier=t)) == want
    assert eng.peak_pages_in_use == 0


def test_serve_launcher_serves_h2o_past_the_window(capsys):
    from repro_torch.launch import serve

    for engine in ("static", "continuous"):
        out = serve.main(["--arch", ARCH, "--reduced", "--engine", engine, "--batch", "2", "--prompt-len", "40",
                          "--gen", "4", "--max-len", "200", "--page-size", "4", "--compress-alpha", "0.3", "--q", "2",
                          "--device", "cpu"])
        text = capsys.readouterr().out
        assert "flash_attention" in text and ", 32)" in text  # the flash calls carry the window
        if engine == "static":
            assert tuple(out.shape) == (2, 4)
        else:
            assert all(r.status == "ok" and len(r.tokens) == 4 for r in out)
            assert "peak_pages=0" in text


# --------------------------------------------------------------------------- #
# head_dim 80 (h2o's own) in the plain versions
# --------------------------------------------------------------------------- #
def test_hd80_plain_flash_and_decode_match_reference():
    """32/8 heads cut to 8/2, head_dim 80, window 32: the plain flash on the
    CPU against ``_flash_fwd_pass`` at q and KV chunks of 32 (several
    blocks, online softmax across them), with and without the window; the
    plain decode over a wrapped ring of 32 slots, every slot valid, against
    the reference's ``decode_attention`` with its ring mask."""
    rng = np.random.default_rng(80)
    B, S, H, KV, hd, W = 2, 96, 8, 2, 80, 32
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32) for n in (H, KV, KV))
    for window in (None, W):
        want, _ = jattn._flash_fwd_pass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window, 32, 32, 0)
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
                              window=window)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    qd = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, W, KV, hd)).astype(np.float32) for _ in range(2))
    n_valid = np.array([W, W], np.int32)
    want = jattn.decode_attention(jnp.asarray(qd), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(n_valid),
                                  rotate_mask=jnp.ones((B, W), bool))
    got = decode_attention(torch.from_numpy(qd), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.ones((B, W), dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("window", [None, 24])
def test_plain_flash_in_query_blocks_equals_one_block(window, monkeypatch):
    """The plain flash's query blocks (which bound its memory on a long
    prompt, and skip the keys a block's window cannot see) compute what one
    block computes."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 100, n, 80)).astype(np.float32)) for n in (4, 2, 2))
    one = ref.chunked_attention_ref(q, k, v, causal=True, window=window)
    monkeypatch.setattr(ref, "Q_BLOCK", 16)
    blocks = ref.chunked_attention_ref(q, k, v, causal=True, window=window)
    assert blocks.shape == one.shape == (1, 100, 4, 80)
    torch.testing.assert_close(blocks, one, **TOL)
