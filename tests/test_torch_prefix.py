"""Engine stage 3 in the port: refcounted prefix sharing, the copy-on-write
fork, the warm cache and the session cache, held against the reference.

The host bookkeeping first: the port's ``PageAllocator`` and ``PrefixIndex``
against the reference's (jax-free) copies under seeded random operation
sequences, with the same grants, refcounts, cached pages, evictions and
peaks, and the same chained digests and matches; the index hashes int32
bytes, so the port's int64 prompts give the reference's keys.  Then the
reference's own allocator and index cases, mirrored on the port's classes.

Then the engine, inside the port on the CPU path (bf16 reduced models, the
served dtype): sharing is a memory knob, so shared and unshared engines
emit the same greedy tokens bit for bit on every chunk-capable ported arch
(llama3.2-1b, minitron-4b, qwen2-72b, phi3.5-moe), with the COW fork at an
exact page boundary, under page churn, through the session cache and under
warm-cache eviction; sharing is inert on zamba2 and mamba2.  The cases of
the reference's tests/test_engine_parity.py and tests/test_scheduler.py are
mirrored.  Across frameworks: one shared trace's greedy tokens and counters
against the reference ``Engine``'s, in fp32, on reduced qwen2-72b with
non-zero QKV biases.  Last, ``drop_session`` and the launcher.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

PageAllocator, PrefixIndex = tsched.PageAllocator, tsched.PrefixIndex
CHUNKABLE = ("llama3.2-1b", "minitron-4b", "qwen2-72b", "phi3.5-moe-42b-a6.6b")
INERT = ("zamba2-1.2b", "mamba2-130m")
MAX_LEN = 16


# --------------------------------------------------------------------------- #
# the allocator and the index, operation for operation against the reference
# --------------------------------------------------------------------------- #
def _alloc_state(a):
    return (a.n_free, a.n_used, a.n_cached, a.peak_used, a.evictions, [a.refcount(p) for p in range(a.n_pages)])


def _both(ja, ta, fn):
    """Apply ``fn`` to both allocators: the same result, or the same error."""
    out = []
    for a in (ja, ta):
        try:
            out.append(("ok", fn(a)))
        except ValueError as e:
            out.append(("ValueError", type(e).__name__))
    assert out[0] == out[1]
    return out[0][1] if out[0][0] == "ok" else None


@pytest.mark.parametrize("budget", [None, 0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_allocator_matches_reference(seed, budget):
    """Seeded random alloc / free / acquire / mark_indexed / record_saved /
    drop_cached / flush_cache / extend / reset_peak sequences, and whole
    shared reservations rolled back with rollback_peak, through both
    allocators: the same grants, refcounts, cached pages, evictions (each
    announced with the same pages) and peaks after every operation."""
    rng = np.random.default_rng(seed)
    N = 12
    jlog, tlog = [], []
    ja = jsched.PageAllocator(N, cache_budget=budget, on_evict=jlog.append)
    ta = PageAllocator(N, cache_budget=budget, on_evict=tlog.append)
    held = []  # one reference per page of each entry
    for _ in range(300):
        op = int(rng.integers(0, 11))
        if op <= 1:
            n = int(rng.integers(0, 5))
            g = _both(ja, ta, lambda a: a.alloc(n))
            if g:
                held.append(list(g))
        elif op == 2 and held:
            g = held.pop(int(rng.integers(0, len(held))))
            _both(ja, ta, lambda a: a.free(list(g)))
        elif op == 3:
            p = int(rng.integers(-1, N + 1))
            if _both(ja, ta, lambda a: a.acquire(p)):
                held.append([p])
        elif op == 4:
            pages = [int(p) for p in rng.integers(0, N + (1 if rng.random() < 0.1 else 0), size=3)]
            _both(ja, ta, lambda a: a.mark_indexed(pages))
        elif op == 5:
            pages = [int(p) for p in rng.integers(0, N, size=2)]
            _both(ja, ta, lambda a: a.record_saved(pages))
        elif op == 6:
            pages = [int(p) for p in rng.integers(0, N, size=2)]
            _both(ja, ta, lambda a: a.drop_cached(pages))
        elif op == 7 and rng.random() < 0.2:
            _both(ja, ta, lambda a: a.flush_cache())
        elif op == 8 and held:
            i = int(rng.integers(0, len(held)))
            n = int(rng.integers(0, 3))
            grown = [_both(ja, ta, lambda a: a.extend(list(held[i]), n))]
            if grown[0] is not None:
                held[i] = grown[0]
        elif op == 9:
            _both(ja, ta, lambda a: a.reset_peak())
        elif op == 10:
            # the engine's reservation: revive cached pages, then alloc the tail;
            # on failure give every reference back and restore the peak
            cands = [int(p) for p in rng.integers(0, N, size=int(rng.integers(1, 4)))]
            tail = int(rng.integers(0, 6))

            def reserve(a):
                peak0, got = a.peak_used, []
                for p in dict.fromkeys(cands):
                    if a.refcount(p) == 0 and p in a._cached and a.acquire(p):
                        got.append(p)
                fresh = a.alloc(tail)
                if fresh is None:
                    if got:
                        a.free(got)
                    a.rollback_peak(peak0)
                    return None
                a.record_saved(got)
                return got + fresh

            g = _both(ja, ta, reserve)
            if g:
                held.append(g)
        if rng.random() < 0.05:  # a duplicate or a double free: rejected, nothing changes
            _both(ja, ta, lambda a: a.free([0, 0]))
        assert _alloc_state(ja) == _alloc_state(ta)
        assert list(ja._cached) == list(ta._cached)
        assert jlog == tlog
    assert ja.evictions == ta.evictions


@pytest.mark.parametrize("page", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_index_matches_reference(seed, page):
    """Random prompts over a few shared heads: register / match /
    drop_pages / drop_branch / clear give the same results, and every
    chained key is the reference's digest of the prompt's int32 bytes (the
    port's prompts are int64)."""
    rng = np.random.default_rng(seed)
    ji, ti = jsched.PrefixIndex(page), PrefixIndex(page)
    heads = [rng.integers(0, 50, size=int(rng.integers(0, 3 * page + 2))) for _ in range(3)]

    def prompt():
        h = heads[int(rng.integers(0, len(heads)))]
        return np.concatenate([h, rng.integers(0, 50, size=int(rng.integers(0, 2 * page + 2)))]).astype(np.int64)

    for _ in range(120):
        p = prompt()
        jp = p.astype(np.int32)
        assert list(ji._page_keys(jp)) == list(ti._page_keys(p))
        assert all(len(k) == 16 for k in ti._page_keys(p))
        op = int(rng.integers(0, 6))
        if op <= 1:
            pages = [int(x) for x in rng.integers(0, 40, size=len(p) // page)]
            assert ti.register(p, np.asarray(pages, np.int32)) == ji.register(jp, pages)
        elif op == 2:
            pages = [int(x) for x in rng.integers(0, 40, size=2)]
            ji.drop_pages(pages)
            ti.drop_pages(pages)
        elif op == 3:
            assert ti.drop_branch(p) == ji.drop_branch(jp)
        elif op == 4 and rng.random() < 0.1:
            ji.clear()
            ti.clear()
        assert ti.match(p) == ji.match(jp)
        assert len(ti) == len(ji)


def test_page_allocator_refcount_share_and_last_reader_release():
    a = PageAllocator(4)
    pages = a.alloc(2)
    assert all(a.acquire(p) for p in pages)
    assert a.n_used == 2  # a shared page counts once
    a.free(pages)
    assert a.n_used == 2 and a.n_free == 2
    a.free(pages)
    assert a.n_used == 0 and a.n_free == 4
    with pytest.raises(ValueError, match="double free"):
        a.free([pages[0]])


def test_page_allocator_extend_duplicate_and_revive():
    a = PageAllocator(4)
    pages = a.alloc(2)
    assert a.extend(pages, 1) == [0, 1, 2] and pages == [0, 1, 2]
    assert a.extend(pages, 2) is None and pages == [0, 1, 2]  # all-or-nothing
    with pytest.raises(ValueError, match="duplicate"):
        a.free([pages[0], pages[0]])
    assert a.n_free == 1 and a.refcount(pages[0]) == 1  # the rejected call changed nothing
    a.free(pages)
    (p,) = a.alloc(1)
    a.free([p])  # cached: on the free list, contents intact
    assert a.acquire(p) and a.refcount(p) == 1 and a.n_free == 3
    assert a.alloc(4) is None  # the revived page cannot be granted to a writer
    assert not a.acquire(4) and not a.acquire(-1)


def test_page_allocator_peak_and_rollback():
    """``peak_used`` rises inside alloc and acquire; ``reset_peak`` re-arms to
    current usage; ``rollback_peak`` restores a mark only once the failed
    reservation's references are back."""
    a = PageAllocator(8)
    g = a.alloc(5)
    a.free(g)
    assert a.peak_used == 5
    a.reset_peak()
    assert a.peak_used == 0
    g = a.alloc(2)
    a.free(g)
    a.reset_peak()
    peak0 = a.peak_used
    assert a.acquire(g[0]) and a.peak_used == 1
    assert a.alloc(8) is None
    a.free([g[0]])
    a.rollback_peak(peak0)
    assert a.peak_used == 0
    with pytest.raises(ValueError):
        a.rollback_peak(3)  # a mark can be restored, never raised
    b = a.alloc(2)
    with pytest.raises(ValueError):
        a.rollback_peak(1)  # references not given back
    a.free(b)


def test_page_allocator_clean_first_then_lru_eviction():
    evicted = []
    a = PageAllocator(4, on_evict=evicted.extend)
    g = a.alloc(2)
    a.mark_indexed(g)
    a.free(g)  # both cached; the chain's tail (page 1) is the older entry
    assert a.alloc(2) == [2, 3]  # clean pages first: nothing evicted
    assert evicted == [] and a.evictions == 0 and a.n_cached == 2
    assert a.alloc(2) == [1, 0]  # then LRU, the tail first
    assert evicted == [1, 0] and a.evictions == 2 and a.n_cached == 0


def test_page_allocator_lru_recency_refresh_and_cost_aware_victim():
    evicted = []
    a = PageAllocator(3, on_evict=evicted.extend)
    g = a.alloc(3)
    a.mark_indexed(g)
    a.free(g)  # eviction order: 2, 1, 0
    a.mark_indexed([2])  # refreshed: 1, 0, 2
    assert a.alloc(1) == [1] and evicted == [1]
    a.record_saved([0])  # page 0 saved a prefill once: page 2 goes first
    assert a.alloc(1) == [2] and evicted == [1, 2]


def test_page_allocator_cache_budget_sweeps_on_release():
    evicted = []
    a = PageAllocator(4, cache_budget=2, on_evict=evicted.extend)
    g = a.alloc(4)
    a.mark_indexed(g)
    a.free(g)
    assert evicted == [3, 2] and a.evictions == 2
    assert a.n_cached == 2 and a.n_free == 4
    z = PageAllocator(2, cache_budget=0)
    g = z.alloc(1)
    z.mark_indexed(g)
    z.free(g)
    assert z.n_cached == 0 and z.evictions == 1
    with pytest.raises(ValueError):
        PageAllocator(2, cache_budget=-1)


def test_page_allocator_flush_and_drop_cached_are_silent():
    evicted = []
    a = PageAllocator(3, on_evict=evicted.extend)
    g = a.alloc(3)
    a.mark_indexed(g)
    a.free(g[:2])
    assert a.n_cached == 2
    assert a.drop_cached([g[0], g[2]]) == 1  # g[2] is live: it only loses its mark
    a.free(g[2:])
    assert a.n_cached == 1 and a.evictions == 0
    a.flush_cache()
    assert a.n_cached == 0 and a.evictions == 0 and evicted == []
    assert a.alloc(3) == [0, 1, 2]


def test_page_allocator_mark_indexed_validates_and_caches_ref0():
    a = PageAllocator(2)
    with pytest.raises(ValueError, match="out of range"):
        a.mark_indexed([2])
    g = a.alloc(1)
    a.mark_indexed(g)
    assert a.n_cached == 0  # live: indexed, not cached
    a.free(g)
    assert a.n_cached == 1
    assert a.acquire(g[0]) and a.n_cached == 0
    a.free(g)
    assert a.n_cached == 1
    plain = PageAllocator(3)
    plain.free(plain.alloc(3))
    assert plain.alloc(2) == [0, 1] and plain.evictions == 0 and plain.n_cached == 0


def test_prefix_index_match_register_drop():
    idx = PrefixIndex(4)
    prompt = np.arange(12)
    assert idx.register(prompt, [7, 3, 9]) == [7, 3, 9]
    assert idx.match(prompt) == [7, 3, 9]
    assert idx.match(prompt[:10]) == [7, 3]  # full pages only
    other = prompt.copy()
    other[5] = 99  # a key commits to the whole prefix
    assert idx.match(other) == [7]
    idx.drop_pages([3])
    assert idx.match(prompt) == [7]
    idx.register(prompt, [7, 5, 9])
    assert idx.match(prompt) == [7, 5, 9]
    assert idx.register(prompt, [1, 2, 6]) == [7, 5, 9]  # the first registration wins
    longer = np.arange(20)
    idx.register(longer, [7, 5, 9, 11, 12])
    assert sorted(idx.drop_branch(prompt[:8])) == [5, 7, 9, 11, 12]  # the chain and its extensions
    assert idx.match(longer) == [] and len(idx) == 0
    idx.register(prompt, [1, 2, 6])
    idx.clear()
    assert idx.match(prompt) == [] and len(idx) == 0


@pytest.mark.parametrize("axis", [0, 1])
def test_copy_page_matches_reference(axis):
    """The COW fork's page copy, on a pool's page axis (1 in the engine's
    stacked (L, P, page, KV, hd) pools), against the reference's."""
    from repro.models.attention import copy_page as j_copy_page
    from repro_torch.models.attention import copy_page

    pool = np.random.default_rng(axis).standard_normal((3, 5, 4, 2, 8) if axis else (5, 4, 2, 8)).astype(np.float32)
    want = np.asarray(j_copy_page(jnp.asarray(pool), 3, 1, axis=axis))
    t = torch.from_numpy(pool.copy())
    got = copy_page(t, 3, 1, axis=axis)
    assert got is t  # in place
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# the engine inside the port: sharing changes where bytes live, never what
# is computed
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def served():
    """{arch: (model, params)}: the port's reduced models in bf16 (the served
    dtype), weights from seed 3; qwen2's QKV biases non-zero."""
    out = {}
    for arch in CHUNKABLE + INERT:
        tm = build_model(get_arch(arch, reduced=True), device="cpu")
        tp = tm.init(torch.Generator().manual_seed(3))
        if tm.cfg.qkv_bias:
            g = torch.Generator().manual_seed(4)
            for name in ("bq", "bk", "bv"):
                b = tp["layers"]["attn"][name]
                b.copy_(0.02 * torch.randn(b.shape, generator=g))
        out[arch] = (tm, tp)
    return out


def _rand(rng, vocab, n):
    return rng.integers(0, vocab, size=(n,)).astype(np.int64)


def _solo(tm, tp, prompt, steps, max_len=MAX_LEN):
    out = greedy_generate(tm, tp, {"tokens": torch.as_tensor(prompt[None]).long()}, steps=steps, max_len=max_len)
    return out[0].tolist()


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("arch", CHUNKABLE + INERT)
def test_shared_prefix_tokens_equal_unshared(served, arch, chunk):
    """A common system prefix of 2 full pages: the second request maps them
    read-only (chunk-capable families) and both emit the unshared run's
    tokens bit for bit, which are greedy_generate's alone; inert families
    share nothing and change nothing.  ``chunk`` 4 (= the page): every
    prompt longer than one chunk, as the card's bitwise gate runs it."""
    tm, tp = served[arch]
    rng = np.random.default_rng(0)
    sys = _rand(rng, tm.cfg.vocab, 8)
    prompts = [np.concatenate([sys, _rand(rng, tm.cfg.vocab, 2)]), np.concatenate([sys, _rand(rng, tm.cfg.vocab, 3)])]
    steps = (4, 5)
    outs = {}
    for share in (False, True):
        eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, share_prefix=share, prefill_chunk=chunk)
        r0 = eng.submit(Request(prompt=prompts[0], max_new_tokens=steps[0]))
        while not r0.tokens:  # its last chunk lands (one chunk a step)
            eng.step()
        eng.step()  # r0 mid-decode, its prefix registered, when r1 arrives
        r1 = eng.submit(Request(prompt=prompts[1], max_new_tokens=steps[1]))
        while eng.has_work:
            eng.step()
        outs[share] = [r0.tokens, r1.tokens]
        if share and arch in CHUNKABLE:
            assert eng.shared_page_hits == 2 and eng.shared_admissions == 1
            assert r1.prefill_skipped == 8 and eng.skipped_prefill_tokens == 8
        elif share:
            assert eng.shared_page_hits == 0 and eng.prefix_cached_pages == 0  # inert by design
        assert eng.pages_in_use == 0
    assert outs[True] == outs[False]
    if tm.cfg.family != "moe":  # a moe layer's capacity drops depend on the rows that share a call
        assert outs[True] == [_solo(tm, tp, p, s) for p, s in zip(prompts, steps)]


@pytest.mark.parametrize("arch", CHUNKABLE[:3])
def test_shared_prefix_cow_fork_exact_page_boundary(served, arch):
    """A follower whose whole prompt is matched re-runs only its last token,
    after COW-forking the last prefix page; a third same-prompt request
    after both finish revives the cached pages.  All three emit the
    unshared run's tokens."""
    tm, tp = served[arch]
    prompt = _rand(np.random.default_rng(7), tm.cfg.vocab, 8)
    outs = {}
    for share in (False, True):
        eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, share_prefix=share, decode_block=1)
        r0 = eng.submit(Request(prompt=prompt, max_new_tokens=6))
        eng.step()
        eng.step()
        r1 = eng.submit(Request(prompt=prompt, max_new_tokens=5))
        while eng.has_work:
            eng.step()
        r2 = eng.submit(Request(prompt=prompt, max_new_tokens=4))
        while eng.has_work:
            eng.step()
        outs[share] = [r0.tokens, r1.tokens, r2.tokens]
        if share:
            assert eng.cow_forks == 2 and eng.shared_admissions == 2
            assert r1.prefill_skipped == 7 and r2.prefill_skipped == 7
    assert outs[True] == outs[False]


def test_shared_prefix_parity_under_page_churn(served):
    tm, tp = served["llama3.2-1b"]
    rng = np.random.default_rng(9)
    sys = _rand(rng, tm.cfg.vocab, 8)
    prompts = [np.concatenate([sys, _rand(rng, tm.cfg.vocab, n)]) for n in (2, 3, 1)]
    prompts.append(_rand(rng, tm.cfg.vocab, 9))  # a foreign prefix
    steps = [4, 5, 3, 3]
    eng = Engine(tm, tp, n_slots=4, max_len=MAX_LEN, page_size=4, kv_pages=8, share_prefix=True, decode_block=1)
    reqs = [eng.submit(Request(prompt=prompts[0], max_new_tokens=steps[0]))]
    eng.step()
    for p, s in zip(prompts[1:], steps[1:]):
        reqs.append(eng.submit(Request(prompt=p, max_new_tokens=s)))
    eng.step()
    # r1 shares 2 + allocates 2, r2 shares 2 + allocates 1: 7 used; the
    # foreign request needs 3 fresh pages and queues on the 1 free one
    assert eng.n_waiting == 1 and eng.pages_in_use == 7
    assert eng.shared_page_hits == 4 and eng.shared_admissions == 2
    while eng.has_work:
        eng.step()
    assert [r.tokens for r in reqs] == [_solo(tm, tp, p, s) for p, s in zip(prompts, steps)]
    assert eng.pages_in_use == 0


@pytest.mark.parametrize("arch", CHUNKABLE + INERT)
def test_generated_page_reuse_parity(served, arch):
    """The session cache: turn 2 extends (prompt + reply) and matches THROUGH
    the decode-filled pages (positions 0-11; turn 1's prompt ends at 5),
    which were rewritten through the chunk program, and emits a cold
    engine's tokens."""
    tm, tp = served[arch]
    rng = np.random.default_rng(3)
    prompt = _rand(rng, tm.cfg.vocab, 6)
    warm = Engine(tm, tp, n_slots=2, max_len=32, page_size=4, share_prefix=True)
    r1 = warm.run([Request(prompt=prompt, max_new_tokens=7)])[0]
    follow = np.concatenate([prompt, np.asarray(r1.tokens, np.int64), _rand(rng, tm.cfg.vocab, 3)])
    r2 = warm.run([Request(prompt=follow.copy(), max_new_tokens=4)])[0]
    assert r2.prefill_skipped == (12 if arch in CHUNKABLE else 0)
    cold = Engine(tm, tp, n_slots=2, max_len=32, page_size=4, share_prefix=True)
    ref = cold.run([Request(prompt=follow.copy(), max_new_tokens=4)])[0]
    assert r2.tokens == ref.tokens


def test_rematerialized_pages_are_the_cold_prefill_bytes(served):
    """The pages a finished request indexes hold bitwise what a cold chunked
    prefill of (prompt + reply) writes, though decode wrote them first."""
    tm, tp = served["minitron-4b"]
    prompt = _rand(np.random.default_rng(21), tm.cfg.vocab, 6)
    warm = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, share_prefix=True)
    r = warm.run([Request(prompt=prompt, max_new_tokens=8)])[0]
    seq = np.concatenate([prompt, np.asarray(r.tokens[:-1], np.int64)])  # 13 tokens: 3 full pages
    pages = warm._prefix[0].match(seq)  # tier 0's index
    assert len(pages) == 3 and warm.prefix_cached_pages == 3
    cold = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, prefill_chunk=4)
    cold.run([Request(prompt=seq[:12], max_new_tokens=1)])  # its first grant: pages 0-3
    row = torch.arange(3)
    for name in ("k", "v"):
        assert torch.equal(warm.cache["layers"][name][:, torch.tensor(pages)], cold.cache["layers"][name][:, row])


def test_eviction_churn_no_stale_matches(served):
    tm, tp = served["llama3.2-1b"]
    rng = np.random.default_rng(11)
    prompts = [_rand(rng, tm.cfg.vocab, 8) for _ in range(3)]
    warm = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, kv_pages=5, share_prefix=True, warm_cache_pages=2,
                  decode_block=1)
    firsts = [warm.run([Request(prompt=p, max_new_tokens=5)])[0] for p in prompts]
    assert warm.prefix_evictions > 0  # the budget's sweep and a writer's grant both fired
    assert warm.prefix_cached_pages <= 2 and warm.pages_in_use == 0

    def followup(i):
        return np.concatenate([prompts[i], np.asarray(firsts[i].tokens, np.int64), _rand(rng, tm.cfg.vocab, 2)])

    f2 = followup(2)
    r2 = warm.run([Request(prompt=f2.copy(), max_new_tokens=4)])[0]
    assert r2.prefill_skipped > 0
    f0 = followup(0)
    r0 = warm.run([Request(prompt=f0.copy(), max_new_tokens=4)])[0]
    for f, r in ((f2, r2), (f0, r0)):
        cold = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, kv_pages=5, decode_block=1, prefill_chunk=4)
        assert r.tokens == cold.run([Request(prompt=f.copy(), max_new_tokens=4)])[0].tokens
    assert warm.pages_in_use == 0


def test_shared_prefix_refcount_lifecycle(served):
    tm, tp = served["llama3.2-1b"]
    rng = np.random.default_rng(5)
    sys = _rand(rng, tm.cfg.vocab, 8)
    pa = np.concatenate([sys, _rand(rng, tm.cfg.vocab, 2)])
    pb = np.concatenate([sys, _rand(rng, tm.cfg.vocab, 3)])
    eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, kv_pages=8, share_prefix=True, decode_block=1)
    donor = eng.submit(Request(prompt=pa, max_new_tokens=4))
    eng.step()
    assert eng.pages_in_use == 4
    follower = eng.submit(Request(prompt=pb, max_new_tokens=5))
    eng.step()
    assert eng.shared_page_hits == 2 and eng.shared_admissions == 1 and eng.pages_in_use == 6
    (shared,) = [g for g in eng.scheduler.slot_pages.values() if g.n_shared == 2]
    assert all(eng.page_pool.refcount(p) == 2 for p in shared.pages[:2])
    while not donor.done:
        eng.step()
    assert not follower.done and all(eng.page_pool.refcount(p) == 1 for p in shared.pages[:2])
    assert eng.pages_in_use == 4
    while eng.has_work:
        eng.step()
    assert eng.pages_in_use == 0 and eng.page_pool.n_free == 8
    assert donor.tokens == _solo(tm, tp, pa, 4) and follower.tokens == _solo(tm, tp, pb, 5)
    late = eng.submit(Request(prompt=pb, max_new_tokens=5))
    while eng.has_work:
        eng.step()
    assert eng.shared_admissions == 2 and late.tokens == follower.tokens  # revived cached pages


def test_shared_reserve_rollback_is_atomic(served):
    tm, tp = served["llama3.2-1b"]
    rng = np.random.default_rng(11)
    sys = _rand(rng, tm.cfg.vocab, 8)
    pa = np.concatenate([sys, _rand(rng, tm.cfg.vocab, 2)])
    pb = np.concatenate([sys, _rand(rng, tm.cfg.vocab, 3)])
    eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, kv_pages=4, share_prefix=True, decode_block=1)
    donor = eng.submit(Request(prompt=pa, max_new_tokens=4))
    eng.step()
    donor_pages = list(eng.scheduler.slot_pages[0].pages)
    follower = eng.submit(Request(prompt=pb, max_new_tokens=5))
    eng.step()  # the follower matches 2 pages, its tail cannot fit: rolled back
    assert eng.n_waiting == 1 and not donor.done
    assert all(eng.page_pool.refcount(p) == 1 for p in donor_pages)
    assert eng.pages_in_use == 4 and eng.peak_pages_in_use == 4
    while eng.has_work:
        eng.step()
    assert follower.tokens == _solo(tm, tp, pb, 5)
    assert eng.shared_admissions == 1 and eng.pages_in_use == 0


def test_shared_cow_degrades_when_fork_page_cannot_fit(served):
    """A fully covered prompt whose need is the whole pool: the fork's extra
    page cannot fit, so the boundary page is un-shared and prefilled."""
    tm, tp = served["llama3.2-1b"]
    prompt = _rand(np.random.default_rng(13), tm.cfg.vocab, 8)
    eng = Engine(tm, tp, n_slots=2, max_len=12, page_size=4, kv_pages=3, share_prefix=True, decode_block=1)
    first = eng.run([Request(prompt=prompt, max_new_tokens=4)])[0]
    again = eng.submit(Request(prompt=prompt, max_new_tokens=4))
    for _ in range(64):
        if not eng.has_work:
            break
        eng.step()
    assert again.done and again.tokens == first.tokens
    assert eng.cow_forks == 0 and eng.shared_admissions == 1 and eng.shared_page_hits == 1
    assert eng.pages_in_use == 0


def test_degraded_reservation_failure_restores_peak(served):
    tm, tp = served["llama3.2-1b"]
    rng = np.random.default_rng(17)
    px = _rand(rng, tm.cfg.vocab, 4)
    eng = Engine(tm, tp, n_slots=3, max_len=12, page_size=4, kv_pages=4, share_prefix=True, decode_block=1)
    blocker = eng.submit(Request(prompt=_rand(rng, tm.cfg.vocab, 3), max_new_tokens=5))
    eng.step()
    donor = eng.submit(Request(prompt=px, max_new_tokens=2))
    while not donor.done:
        eng.step()
    assert not blocker.done and eng.pages_in_use == 2
    eng.page_pool.reset_peak()
    follower = eng.submit(Request(prompt=px, max_new_tokens=8))
    eng.step()
    assert not follower.done and eng.n_waiting == 1
    assert eng.pages_in_use == 2 and eng.peak_pages_in_use == 2  # no phantom page from the revive
    while eng.has_work:
        eng.step()
    assert follower.done and eng.pages_in_use == 0


def test_same_batch_match_then_reserve_ordering(served):
    """A writer admitted in the same step as a matcher may not be granted the
    cached page the matcher just revived: it queues instead."""
    tm, tp = served["llama3.2-1b"]
    rng = np.random.default_rng(23)
    px = _rand(rng, tm.cfg.vocab, 4)
    eng = Engine(tm, tp, n_slots=3, max_len=MAX_LEN, page_size=4, kv_pages=4, share_prefix=True, decode_block=1)
    eng.run([Request(prompt=px, max_new_tokens=2)])
    assert eng.pages_in_use == 0 and eng.prefix_cached_pages == 1
    follow = np.concatenate([px, _rand(rng, tm.cfg.vocab, 4)])
    matcher = eng.submit(Request(prompt=follow, max_new_tokens=4))
    writer = eng.submit(Request(prompt=_rand(rng, tm.cfg.vocab, 5), max_new_tokens=2))
    eng.step()
    assert eng.shared_admissions == 1 and eng.n_waiting == 1 and eng.prefix_evictions == 0
    while eng.has_work:
        eng.step()
    assert matcher.done and writer.done
    cold = Engine(tm, tp, n_slots=1, max_len=MAX_LEN, page_size=4, kv_pages=4, prefill_chunk=4)
    assert matcher.tokens == cold.run([Request(prompt=follow.copy(), max_new_tokens=4)])[0].tokens


def test_drop_session_frees_the_branch_and_reset_forgets_all(served):
    tm, tp = served["qwen2-72b"]
    rng = np.random.default_rng(29)
    prompt = _rand(rng, tm.cfg.vocab, 6)
    eng = Engine(tm, tp, n_slots=2, max_len=32, page_size=4, share_prefix=True)
    r1 = eng.run([Request(prompt=prompt, max_new_tokens=7)])[0]
    other = eng.run([Request(prompt=_rand(rng, tm.cfg.vocab, 9), max_new_tokens=3)])[0]
    assert eng.prefix_cached_pages == 3 + 2
    assert eng.drop_session(prompt[:4]) == 3  # the chain and its decode-filled extension
    assert eng.prefix_cached_pages == 2 and eng.prefix_evictions == 0
    follow = np.concatenate([prompt, np.asarray(r1.tokens, np.int64)])
    assert eng.run([Request(prompt=follow, max_new_tokens=2)])[0].prefill_skipped == 0
    assert eng.drop_session(np.arange(3)) == 0  # no full page: nothing to drop
    eng.reset_prefix_cache()
    assert eng.prefix_cached_pages == 0 and eng.prefix_evictions == 0
    again = eng.run([Request(prompt=other.prompt.copy(), max_new_tokens=3)])[0]
    assert again.prefill_skipped == 0 and again.tokens == other.tokens
    flat = Engine(tm, tp, n_slots=1, max_len=8)
    assert flat.drop_session(prompt) == 0 and flat.prefix_cached_pages == 0


def test_sharing_options_need_paged_mode_and_reset_counters(served):
    tm, tp = served["llama3.2-1b"]
    for kw in (dict(share_prefix=True), dict(warm_cache_pages=2)):
        with pytest.raises(ValueError, match="page_size"):
            Engine(tm, tp, n_slots=1, max_len=8, **kw)
    rng = np.random.default_rng(31)
    prompt = _rand(rng, tm.cfg.vocab, 8)
    eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, share_prefix=True, warm_cache_pages=1)
    eng.run([Request(prompt=prompt, max_new_tokens=2)])  # 2 pages indexed, the budget keeps the head
    assert eng.prefix_evictions == 1 and eng.prefix_cached_pages == 1
    eng.run([Request(prompt=prompt, max_new_tokens=2)])
    assert eng.shared_admissions == 1 and eng.shared_page_hits == 1
    eng.reset_counters()
    assert (eng.shared_page_hits, eng.shared_admissions, eng.cow_forks, eng.skipped_prefill_tokens,
            eng.prefix_evictions) == (0, 0, 0, 0, 0)


# --------------------------------------------------------------------------- #
# across frameworks: one shared trace against the reference engine
# --------------------------------------------------------------------------- #
def test_shared_trace_matches_reference_engine_fp32():
    """Reduced qwen2-72b in fp32, QKV biases from a numpy seed, reference
    params bridged in: a trace with a shared system prefix, a COW follower
    and a session follow-up gives the reference engine's greedy tokens and
    sharing counters."""
    jcfg = dataclasses.replace(j_get_arch("qwen2-72b", reduced=True), dtype="float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    attn = dict(jp["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(0.02 * rng.standard_normal(attn[name].shape), jnp.float32)
    jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    tm = build_model(dataclasses.replace(get_arch("qwen2-72b", reduced=True), dtype="float32"), device="cpu")
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    sys = rng.integers(0, jcfg.vocab, size=(8,)).astype(np.int32)
    prompts = [np.concatenate([sys, rng.integers(0, jcfg.vocab, size=(n,)).astype(np.int32)]) for n in (3, 0, 5)]
    steps = (6, 5, 4)
    extra = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)

    def trace(make_engine, make_request):
        eng = make_engine()
        reqs = [eng.submit(make_request(prompts[0], steps[0]))]
        eng.step()
        eng.step()
        reqs += [eng.submit(make_request(p, s)) for p, s in zip(prompts[1:], steps[1:])]
        while eng.has_work:
            eng.step()
        follow = np.concatenate([prompts[0], np.asarray(reqs[0].tokens, np.int32), extra])
        reqs.append(eng.submit(make_request(follow, 3)))
        while eng.has_work:
            eng.step()
        return ([r.tokens for r in reqs], [r.prefill_skipped for r in reqs],
                (eng.shared_page_hits, eng.shared_admissions, eng.cow_forks, eng.skipped_prefill_tokens))

    kw = dict(n_slots=3, max_len=32, page_size=4, share_prefix=True)
    want = trace(lambda: JEngine(jm, jp, **kw), lambda p, s: JRequest(prompt=p, max_new_tokens=s))
    got = trace(lambda: Engine(tm, tp, **kw), lambda p, s: Request(prompt=p, max_new_tokens=s))
    assert got == want
    assert want[2][2] >= 1 and want[1][-1] > prompts[0].size  # a COW fork; the session matched past the prompt


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_serve_launcher_share_prefix_close_sessions(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "minitron-4b", "--reduced", "--device", "cpu", "--gen", "5", "--batch", "3",
                       "--page-size", "4", "--prefill-chunk", "8", "--share-prefix", "--warm-cache-pages", "16",
                       "--close-sessions"])
    out = capsys.readouterr().out
    assert "[shared]" in out and "cow_forks=" in out and "[sessions] closed 3" in out
    assert all(r.status == "ok" and len(r.tokens) == 5 for r in done)
    assert "cached now 0" in out
