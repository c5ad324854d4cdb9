"""The port's continuous-batching engine, held against the reference.

Cross-framework: on the same bridged params (reduced llama3.2-1b in fp32),
the port's ``Engine`` emits the JAX ``Engine``'s greedy tokens for a single
request and for staggered two-request admission, in flat mode, paged mode
at two page sizes and paged + chunked mode at two chunk sizes (the cases of
tests/test_engine_parity.py).  Inside the port, on the CPU path, the exact
rules hold bit for bit: paged == flat, chunked == monolithic and
``decode_block`` 1 == 8 (the caches the engines wrote are compared byte for
byte mid-decode, and the tokens), and every request's tokens equal
``greedy_generate`` on its prompt alone.  Then the port's own sampling rule
(a seed gives the same stream alone and interleaved; ``top_k=1`` and
temperature 0 are greedy), the non-finite-logits freeze, the scheduler copy
against the reference's, and the launcher.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.llama3_2_1b import REDUCED as J_REDUCED  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.ref import gather_pages  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import Engine, Request, SamplingParams  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.sampling import sample_tokens, token_salts  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

MAX_LEN = 16
STEPS = (5, 6)
MODES = {
    "flat": {},
    "paged4": dict(page_size=4),
    "paged8": dict(page_size=8),
    "paged4_chunk3": dict(page_size=4, prefill_chunk=3),
    "paged8_chunk5": dict(page_size=8, prefill_chunk=5),
}


@pytest.fixture(scope="module")
def models():
    """The reference model and params (fp32) and the port's, bridged."""
    jcfg = dataclasses.replace(J_REDUCED, dtype="float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_arch("llama3.2-1b", reduced=True), dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), device="cpu")


def _prompts(vocab, sizes=(6, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in sizes]


def _drive(make_engine, make_request, prompts, steps, *, staggered):
    """Single request (prompt 0) or staggered admission: request 1 arrives
    two engine steps after request 0, mid-decode or mid-chunk."""
    eng = make_engine()
    reqs = [eng.submit(make_request(prompts[0], steps[0]))]
    if staggered:
        eng.step()
        eng.step()
        reqs.append(eng.submit(make_request(prompts[1], steps[1])))
    while eng.has_work:
        eng.step()
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_tokens(models):
    jm, jp, tm, _ = models
    prompts = _prompts(tm.cfg.vocab)
    out = {("flat", False): _drive(lambda: JEngine(jm, jp, n_slots=2, max_len=MAX_LEN),
                                   lambda p, s: JRequest(prompt=p, max_new_tokens=s), prompts, STEPS,
                                   staggered=False)}
    for mode, kw in MODES.items():
        out[(mode, True)] = _drive(lambda: JEngine(jm, jp, n_slots=2, max_len=MAX_LEN, **kw),
                                   lambda p, s: JRequest(prompt=p, max_new_tokens=s), prompts, STEPS,
                                   staggered=True)
    return out


def _port_request(p, s):
    return Request(prompt=p, max_new_tokens=s)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_engine_staggered(models, jax_tokens, mode):
    _, _, tm, tp = models
    got = _drive(lambda: Engine(tm, tp, n_slots=2, max_len=MAX_LEN, **MODES[mode]), _port_request,
                 _prompts(tm.cfg.vocab), STEPS, staggered=True)
    assert got == jax_tokens[(mode, True)]


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_engine_single(models, jax_tokens, mode):
    _, _, tm, tp = models
    got = _drive(lambda: Engine(tm, tp, n_slots=2, max_len=MAX_LEN, **MODES[mode]), _port_request,
                 _prompts(tm.cfg.vocab), STEPS, staggered=False)
    assert got == jax_tokens[("flat", False)]  # the reference holds every mode to the flat tokens


# --------------------------------------------------------------------------- #
# exact rules inside the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def bf16_model():
    """bf16 (the served dtype): near-ties are likeliest there."""
    cfg = get_arch("llama3.2-1b", reduced=True)
    tm = build_model(cfg, device="cpu")
    return tm, tm.init(torch.Generator().manual_seed(3))


def _kv(eng, slot):
    """The K/V a slot has written so far, (L, pos, KV, hd) each, from its
    flat row or gathered from its pages."""
    n = int(eng._pos[slot])
    out = []
    for name in ("k", "v"):
        leaf = eng.cache["layers"][name]
        if eng.paged:
            row = torch.from_numpy(eng._bt[slot])[None]
            out.append(torch.stack([gather_pages(leaf[i], row)[0, :n] for i in range(leaf.shape[0])]))
        else:
            out.append(leaf[:, slot, :n].clone())
    return out


def _finish_snapshots(tm, tp, prompts, **kw):
    """Serve every prompt; at each request's finish, snapshot the K/V its slot
    holds before the slot is cleared: {uid: (position, [k, v])}."""
    eng = Engine(tm, tp, n_slots=len(prompts), max_len=24, **kw)
    snaps = {}
    clear = eng._clear_slot

    def snapshot_then_clear(slot):
        snaps[eng._reqs[slot].uid] = (int(eng._pos[slot]), _kv(eng, slot))
        clear(slot)

    eng._clear_slot = snapshot_then_clear
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=s)) for p, s in zip(prompts, (12, 9, 15))]
    while eng.has_work:
        eng.step()
    return [r.tokens for r in reqs], snaps


@pytest.mark.parametrize("variant", [
    dict(page_size=4), dict(page_size=8), dict(page_size=4, prefill_chunk=4),
    dict(page_size=8, prefill_chunk=3), dict(decode_block=1),
])
def test_paged_chunked_and_block_size_are_bitwise_the_flat_engine(bf16_model, variant):
    """The same requests: each one's K/V, as its slot holds it when it
    finishes, is the flat engine's bytes, and its tokens are the same."""
    tm, tp = bf16_model
    prompts = _prompts(tm.cfg.vocab, sizes=(9, 5, 7), seed=4)
    flat_tokens, flat = _finish_snapshots(tm, tp, prompts)
    tokens, other = _finish_snapshots(tm, tp, prompts, **variant)
    assert tokens == flat_tokens
    assert sorted(other) == sorted(flat) == [0, 1, 2]
    for uid, (pos, kv) in flat.items():
        assert other[uid][0] == pos
        for a, b in zip(other[uid][1], kv):
            assert torch.equal(a, b)


def test_engine_tokens_equal_greedy_generate_alone(bf16_model):
    """Five ragged prompts through three slots and a tight page pool, chunked:
    each request's tokens are greedy_generate's on that prompt alone."""
    tm, tp = bf16_model
    prompts = _prompts(tm.cfg.vocab, sizes=(9, 3, 12, 6, 4), seed=5)
    steps = (7, 11, 4, 9, 6)
    eng = Engine(tm, tp, n_slots=3, max_len=24, page_size=4, kv_pages=10, prefill_chunk=5)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=s)) for p, s in zip(prompts, steps)]
    done = eng.run([])
    while eng.has_work:
        done += eng.step()
    assert sorted(r.uid for r in done) == list(range(5))
    assert eng.peak_pages_in_use <= 10 and eng.page_pool.n_used == 0
    for r, p, s in zip(reqs, prompts, steps):
        want = greedy_generate(tm, tp, {"tokens": torch.as_tensor(p[None]).long()}, steps=s, max_len=24)
        assert r.tokens == want[0].tolist() and r.status == "ok"


def test_engine_counters_and_page_gated_admission(bf16_model):
    tm, tp = bf16_model
    prompts = _prompts(tm.cfg.vocab, sizes=(8, 8, 8), seed=6)
    # each request needs ceil((8 + 8) / 4) = 4 pages; 9 pages hold two at once
    eng = Engine(tm, tp, n_slots=3, max_len=16, page_size=4, kv_pages=9, decode_block=4)
    for p in prompts:
        eng.submit(Request(prompt=p, max_new_tokens=8))
    eng.step()
    assert eng.n_active == 2 and eng.n_waiting == 1 and eng.pages_in_use == 8
    per_page = eng._bytes_per_page
    assert per_page == 2 * tm.cfg.n_layers * 4 * tm.cfg.n_kv_heads * tm.cfg.head_dim * 2  # k+v, bf16
    assert eng.kv_bytes_capacity == per_page * 10 and eng.kv_bytes_in_use == per_page * 8
    while eng.has_work:
        eng.step()
    assert eng.peak_active == 2 and eng.peak_pages_in_use == 8 and eng.kv_bytes_peak == per_page * 8
    assert eng.decoded_tokens == 3 * 7 and eng.host_syncs * 4 == eng.steps
    assert eng.graph_replays == 0 and not eng.cuda_graph
    eng.reset_counters()
    assert eng.steps == eng.host_syncs == eng.decoded_tokens == 0 and eng.peak_pages_in_use == 0


@pytest.mark.parametrize("decode_block", [1, 8])
def test_eos_stops_a_request_inside_the_block(bf16_model, decode_block):
    """A request stops on the eos token (emitted, then nothing after it),
    wherever in a block it falls; arrivals are replayed on the wall clock."""
    tm, tp = bf16_model
    prompts = _prompts(tm.cfg.vocab, sizes=(6, 5), seed=10)
    full = [greedy_generate(tm, tp, {"tokens": torch.as_tensor(p[None]).long()}, steps=10, max_len=20)[0].tolist()
            for p in prompts]
    eos = full[0][4]  # request 0's fifth token
    eng = Engine(tm, tp, n_slots=2, max_len=20, eos_token=eos, decode_block=decode_block)
    reqs = [Request(prompt=p, max_new_tokens=10) for p in prompts]
    done = eng.run(reqs, arrivals=[0.0, 0.01], max_idle_wait=0.005)
    assert sorted(r.uid for r in done) == [0, 1]
    for r, want in zip(reqs, full):
        stop = want.index(eos) + 1 if eos in want else len(want)
        assert r.tokens == want[:stop] and r.latency is not None and r.ttft <= r.latency


def test_non_finite_logits_freeze_only_that_request(bf16_model):
    """Logits that turn non-finite for one slot mid-block end its request with
    status "error" and no garbage token; the other request decodes on."""
    tm, tp = bf16_model
    prompts = _prompts(tm.cfg.vocab, sizes=(5, 6), seed=7)
    calls = {"n": 0}

    def poisoned(p, cache, tokens, pos):
        logits, cache = tm.decode_step(p, cache, tokens, pos)
        calls["n"] += 1
        if calls["n"] == 3:  # the third decode step: slot 1 goes NaN
            logits = logits.clone()
            logits[1] = float("nan")
        return logits, cache

    bad = dataclasses.replace(tm, decode_step=poisoned)
    eng = Engine(bad, tp, n_slots=2, max_len=16)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=8)) for p in prompts]
    while eng.has_work:
        eng.step()
    want = [greedy_generate(tm, tp, {"tokens": torch.as_tensor(p[None]).long()}, steps=8, max_len=16)[0].tolist()
            for p in prompts]
    assert reqs[0].status == "ok" and reqs[0].tokens == want[0]
    assert reqs[1].status == "error" and eng.quarantined == 1
    assert reqs[1].tokens == want[1][:3]  # the prefill token and the two steps before the NaN


def test_options_of_later_slices_raise(bf16_model):
    tm, tp = bf16_model
    for kw in (dict(share_prefix=True), dict(warm_cache_pages=4), dict(tiers=(1.0, 0.5)), dict(preempt=True),
               dict(injector=object()), dict(admission=object()), dict(watchdog=object()),
               dict(on_event=print), dict(tier_q=2)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            Engine(tm, tp, n_slots=1, max_len=8, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        Engine(tm, tp, n_slots=1, max_len=8, cuda_graph=True)
    with pytest.raises(ValueError, match="page_size"):
        Engine(tm, tp, n_slots=1, max_len=8, prefill_chunk=4)


# --------------------------------------------------------------------------- #
# sampling: the port's own rule
# --------------------------------------------------------------------------- #
def test_sampled_stream_is_the_same_alone_and_interleaved(bf16_model):
    tm, tp = bf16_model
    prompts = _prompts(tm.cfg.vocab, sizes=(6, 4, 7), seed=8)
    sp = [SamplingParams(temperature=0.9, top_k=40, seed=11), SamplingParams(temperature=1.3, seed=12),
          SamplingParams(temperature=0.7, top_k=5, seed=2**40 + 3)]

    def alone(i):
        eng = Engine(tm, tp, n_slots=1, max_len=20, decode_block=3)
        r = eng.submit(Request(prompt=prompts[i], max_new_tokens=10, sampling=sp[i]))
        while eng.has_work:
            eng.step()
        return r.tokens

    eng = Engine(tm, tp, n_slots=2, max_len=20, page_size=4, prefill_chunk=3)
    reqs = []
    for i in range(3):
        reqs.append(eng.submit(Request(prompt=prompts[i], max_new_tokens=10, sampling=sp[i])))
        eng.step()
    while eng.has_work:
        eng.step()
    for i, r in enumerate(reqs):
        assert r.tokens == alone(i)
    assert reqs[0].tokens != reqs[1].tokens


def test_top_k_one_and_temperature_zero_are_greedy(bf16_model):
    tm, tp = bf16_model
    p = _prompts(tm.cfg.vocab, sizes=(6,), seed=9)[0]
    want = greedy_generate(tm, tp, {"tokens": torch.as_tensor(p[None]).long()}, steps=9, max_len=16)[0].tolist()
    for sp in (SamplingParams(temperature=1.5, top_k=1, seed=4), SamplingParams(temperature=0.0, top_k=7)):
        eng = Engine(tm, tp, n_slots=1, max_len=16)
        r = eng.submit(Request(prompt=p, max_new_tokens=9, sampling=sp))
        while eng.has_work:
            eng.step()
        assert r.tokens == want


def test_sample_tokens_rule():
    """Deterministic in (seed, token index, vocab id); top-k restricts the
    draw; the draws spread over the candidates."""
    V = 50
    logits = torch.zeros((4, V))
    salts = token_salts(torch.tensor([1, 1, 2, 2**32 - 1]), torch.tensor([0, 0, 0, 7]))
    temps = torch.full((4,), 1.0)
    a = sample_tokens(logits, salts, temps, torch.tensor([0, 0, 3, 0]))
    assert a[0] == a[1]
    assert int(a[2]) < 3  # equal logits: the stable top-3 are ids 0, 1, 2
    draws = {int(sample_tokens(logits[:1], token_salts(torch.tensor([5]), torch.tensor([i])), temps[:1],
                               torch.tensor([0]))) for i in range(200)}
    assert len(draws) > 30
    # the salt depends on the seed's low 32 bits only, as the engine stores it
    assert int(token_salts(torch.tensor([2**32 + 5]), torch.tensor([3]))) == (5 * 1_000_003 + 3) & 0x7FFFFFFF


# --------------------------------------------------------------------------- #
# the scheduler copy, against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_copy_matches_reference(seed):
    """The same random alloc / free / reset_peak sequence through both
    allocators gives the same grants, usage and peaks."""
    rng = np.random.default_rng(seed)
    ja, ta = jsched.PageAllocator(12), tsched.PageAllocator(12)
    held = []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(0, 6))
            g = ja.alloc(n)
            assert ta.alloc(n) == g
            if g:
                held.append(g)
        elif op == 1 and held:
            g = held.pop(int(rng.integers(0, len(held))))
            ja.free(g)
            ta.free(g)
        elif op == 2:
            ja.reset_peak()
            ta.reset_peak()
        assert (ja.n_used, ja.n_free, ja.peak_used) == (ta.n_used, ta.n_free, ta.peak_used)


def test_scheduler_copy_matches_reference():
    """FIFO admission gated on slots and pages, queue and release, step for step."""
    runs = []
    for mod in (jsched, tsched):
        pages = mod.PageAllocator(6)
        sched = mod.Scheduler(mod.SlotAllocator(2), reserve=lambda r, pages=pages, mod=mod: (
            None if (g := pages.alloc(r)) is None else mod.PageGrant(pages=g)),
            release_grant=lambda g, pages=pages: pages.free(g.pages))
        log = []
        for need in (3, 2, 4, 1, 1):
            sched.enqueue(need)
        for release in (None, 0, 1, 0):
            if release is not None:
                sched.release(release)
            placed = sched.admit()
            log.append((placed, sched.n_waiting, pages.n_used, sorted(sched.slot_pages)))
        runs.append(log)
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="double free"):
        tsched.SlotAllocator(1).free(0)
    pages = tsched.PageAllocator(3)
    pages.alloc(2)
    with pytest.raises(ValueError, match="duplicate"):
        pages.free([1, 1])
    with pytest.raises(ValueError, match="double free"):
        pages.free([2])
    assert pages.n_used == 2  # a rejected free changes nothing


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("argv", [
    ["--engine", "continuous", "--page-size", "4", "--prefill-chunk", "8"],
    ["--engine", "continuous", "--batch", "3", "--n-slots", "2", "--temperature", "0.8", "--top-k", "20",
     "--compress-alpha", "0.3"],
])
def test_serve_launcher_continuous(capsys, argv):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--gen", "6", *argv])
    out = capsys.readouterr().out
    assert "[continuous]" in out and "[dispatch]" in out
    assert all(r.status == "ok" and len(r.tokens) == 6 for r in done)
    if "--page-size" in argv:
        assert "[paged]" in out and "paged_decode_attention" in out
