"""Engine stage 4 in the port: rank tiers with certificates, the admission
policy (deadline shedding, degradation under pressure), preemption, fault
injection and quarantine, the step watchdog and the graceful drain, held
against the reference.

Pure host logic first, case for case against the reference's own classes
on the same inputs: ``slice_rank`` and ``min_rank`` (the port's tiers are
views of the stored factors, never copies), ``AdmissionPolicy``, the
scheduler's shedding and degradation, ``FaultInjector`` and
``StepWatchdog`` (the cases of tests/test_overload.py and
tests/test_fault_tolerance.py).  Then the engine: across frameworks, on
reduced models in fp32 compressed by the port's RSI and handed to both, each
tier's greedy tokens against the reference ``Engine``'s on every ported
dense and moe arch, and preemption's tokens (with and without prefix
sharing) against the reference's; inside the port, the reference's engine
cases of tests/test_overload.py and tests/test_engine_parity.py (the
recurrent families refuse tiers, equal priority never preempts, the
poisoned request alone errors, the drain finishes in-flight work), the
export to a second engine, the event sink, and the launcher's flags.
"""

import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.core.lowrank import min_rank as j_min_rank  # noqa: E402
from repro.core.lowrank import slice_rank as j_slice_rank  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import CompressionPolicy, compress_tree, spectralize_params  # noqa: E402
from repro_torch.core.lowrank import lowrank_params, min_rank, slice_rank  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.fault_tolerance import FaultInjector, StepWatchdog  # noqa: E402
from repro_torch.serving import AdmissionPolicy, Engine, Request  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

DENSE_MOE = ("llama3.2-1b", "minitron-4b", "qwen2-72b", "phi3.5-moe-42b-a6.6b")
RECURRENT = ("mamba2-130m", "zamba2-1.2b")
MAX_LEN = 16


# --------------------------------------------------------------------------- #
# slice_rank / min_rank: tiers are prefix views
# --------------------------------------------------------------------------- #
def _np_factored(rng, shape_a, shape_b):
    return {"a": rng.standard_normal(shape_a).astype(np.float32),
            "b": rng.standard_normal(shape_b).astype(np.float32)}


def _tree(rng):
    """A params tree of 2-D, layer-stacked and expert-stacked factors, a dense
    leaf and a list, as numpy (for the reference) and as the port keeps them
    (``lowrank_params``: row-padded storage)."""
    np_tree = {"layer": {"w": _np_factored(rng, (37, 13), (13, 50))},
               "stack": {"w": _np_factored(rng, (4, 32, 8), (4, 8, 48))},
               "moe": {"w": _np_factored(rng, (2, 3, 32, 9), (2, 3, 9, 40))},
               "dense": rng.standard_normal((16, 16)).astype(np.float32),
               "list": [_np_factored(rng, (8, 6), (6, 8))]}

    def port(node):
        if isinstance(node, dict) and "a" in node:
            return lowrank_params(torch.from_numpy(node["a"]), torch.from_numpy(node["b"]))
        if isinstance(node, dict):
            return {k: port(v) for k, v in node.items()}
        if isinstance(node, list):
            return [port(v) for v in node]
        return torch.from_numpy(node)

    return np_tree, port(np_tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict) and "a" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


@pytest.mark.parametrize("frac", [0.75, 0.5, 0.25, 1e-6])
def test_slice_rank_matches_reference_and_returns_views(frac):
    """Every factored leaf (2-D, layer- and expert-stacked) slices to the
    reference's values and shapes, as a view of the stored storage: A's
    padded row stride and B's expert stride are kept, nothing is copied;
    dense leaves pass through as the same objects."""
    np_tree, tree = _tree(np.random.default_rng(0))
    want = dict(_leaves(j_slice_rank(np_tree, frac)))
    out = slice_rank(tree, frac)
    for path, leaf in _leaves(out):
        stored = dict(_leaves(tree))[path]
        for name in ("a", "b"):
            np.testing.assert_array_equal(leaf[name].numpy(), np.asarray(want[path][name]))
            assert leaf[name]._base is not None or leaf[name].data_ptr() == stored[name].data_ptr()
            assert leaf[name].untyped_storage().data_ptr() == stored[name].untyped_storage().data_ptr()
            assert leaf[name].stride() == stored[name].stride()
    assert out["dense"] is tree["dense"]


def test_slice_rank_identity_validation_and_min_rank():
    np_tree, tree = _tree(np.random.default_rng(1))
    assert slice_rank(tree, 1.0) is tree
    for bad in (0.0, 1.5, -0.5):
        with pytest.raises(ValueError):
            slice_rank(tree, bad)
        with pytest.raises(ValueError):
            j_slice_rank(np_tree, bad)
    assert min_rank(tree) == j_min_rank(np_tree) == 6
    assert min_rank(slice_rank(tree, 0.5)) == j_min_rank(j_slice_rank(np_tree, 0.5)) == 3
    assert min_rank({"dense": torch.ones(4, 4)}) == 0


# --------------------------------------------------------------------------- #
# the admission policy and the scheduler's overload layer
# --------------------------------------------------------------------------- #
def _pair(prompt_len=4, max_new=4, **kw):
    return (Request(prompt=np.arange(prompt_len), max_new_tokens=max_new, **kw),
            JRequest(prompt=np.arange(prompt_len, dtype=np.int32), max_new_tokens=max_new, **kw))


@pytest.mark.parametrize("n_tiers,depth,frac", [(1, None, None), (3, 4, 0.25), (2, 1, None), (3, None, 0.5)])
def test_admission_policy_matches_reference(n_tiers, depth, frac):
    """choose_tier over a grid of requests (min_tier, tier, continuation) and
    pressures gives the reference's tier."""
    pol = AdmissionPolicy(n_tiers=n_tiers, degrade_queue_depth=depth, degrade_free_frac=frac)
    jpol = jsched.AdmissionPolicy(n_tiers=n_tiers, degrade_queue_depth=depth, degrade_free_frac=frac)
    for min_tier in (0, 1, 2, 7):
        for tier in (0, 1):
            for cont in (False, True):
                r, jr = _pair(min_tier=min_tier, tier=tier)
                if cont:
                    r._parent, jr._parent = _pair()
                for q in (0, 1, 4, 9):
                    for f in (1.0, 0.4, 0.1, 0.0):
                        assert pol.choose_tier(r, q, f) == jpol.choose_tier(jr, q, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_overload_matches_reference(seed):
    """A seeded random trace of submissions (some with deadlines already
    expired, some pinned to tier 0, continuations among them), admissions
    under changing pressure and releases, through both schedulers: the same
    placements and tiers, the same shed uids with the same reasons, queue
    depths and deadlines, and the same degraded count and events."""
    rng = np.random.default_rng(seed)
    pressure = {"f": 1.0}
    events, jevents = [], []
    pol = dict(n_tiers=3, degrade_queue_depth=3, degrade_free_frac=0.3)
    ts = tsched.Scheduler(tsched.SlotAllocator(2), policy=AdmissionPolicy(**pol), pressure=lambda: pressure["f"])
    js = jsched.Scheduler(jsched.SlotAllocator(2), policy=jsched.AdmissionPolicy(**pol),
                          pressure=lambda: pressure["f"])
    ts.on_event = lambda k, f: events.append((k, {x: y for x, y in f.items() if x != "waited_ms"}))
    js.on_event = lambda k, f: jevents.append((k, {x: y for x, y in f.items() if x != "waited_ms"}))
    uid = 0
    for _ in range(60):
        op = int(rng.integers(0, 4))
        if op <= 1:
            expired = rng.random() < 0.3
            kw = dict(deadline_ms=5.0 if expired or rng.random() < 0.3 else None,
                      min_tier=int(rng.integers(0, 4)))
            r, jr = _pair(**kw)
            now, cont = time.perf_counter(), rng.random() < 0.1
            for q, sched in ((r, ts), (jr, js)):
                q.uid, q.t_submit = uid, now - (1.0 if expired else 0.0)
                if cont:
                    q._parent = q  # a continuation: exempt from deadlines and degradation
                sched.enqueue(q)
            uid += 1
        elif op == 2:
            pressure["f"] = float(rng.choice([1.0, 0.5, 0.2]))
            got, want = ts.admit(), js.admit()
            assert [(s, q.uid, q.tier) for s, q in got] == [(s, q.uid, q.tier) for s, q in want]
        elif ts.allocator.n_active:
            slot = int(rng.choice([s for s in range(2) if ts.allocator.is_active(s)]))
            ts.release(slot)
            js.release(slot)
        shed, jshed = ts.drain_shed(), js.drain_shed()
        assert [(q.uid, q.status, q.rejected.reason, q.rejected.queue_depth, q.rejected.deadline_ms) for q in shed] == \
            [(q.uid, q.status, q.rejected.reason, q.rejected.queue_depth, q.rejected.deadline_ms) for q in jshed]
        assert all(q.rejected.waited_ms >= 0 and q.t_done > 0 for q in shed)
    assert ts.degraded == js.degraded and events == jevents
    assert any(k == "shed" for k, _ in events) and ts.degraded > 0


def test_scheduler_without_policy_ignores_deadlines():
    """Plain FIFO (no policy) never sheds: deadlines are policy semantics."""
    sched = tsched.Scheduler(tsched.SlotAllocator(1))
    stale, _ = _pair(deadline_ms=1.0)
    stale.t_submit = time.perf_counter() - 1.0
    sched.enqueue(stale)
    assert [r for _, r in sched.admit()] == [stale] and stale.status == "ok" and sched.drain_shed() == []


# --------------------------------------------------------------------------- #
# the fault injector and the watchdog
# --------------------------------------------------------------------------- #
def test_injector_windows_match_reference():
    kw = dict(deny_pages=(2, 4), slow_steps=(1, 3), slow_ms=1.0)
    inj, jinj = FaultInjector(**kw), jft.FaultInjector(**kw)
    for step in range(6):
        assert inj.deny_reserve(step) == jinj.deny_reserve(step)
        t0 = time.perf_counter()
        inj.on_step(step)
        slept = time.perf_counter() - t0
        jinj.on_step(step)
        assert (slept >= 1e-3) == (1 <= step < 3)
    assert inj.fired == jinj.fired == {"deny_pages": 2, "slow_step": 2}
    assert not FaultInjector().deny_reserve(3)


def test_injector_poison_resolves_like_reference():
    uid_of = {0: 3, 1: 7, 2: None}.get
    for nan in ((7, 10), (3, 0), (9, 4), (7, 15)):
        inj, jinj = FaultInjector(nan_logits=nan), jft.FaultInjector(nan_logits=nan)
        for done in (0, 4, 8, 12, 16):
            for block in (1, 4, 8):
                assert inj.poison_for(uid_of, 3, done, block) == jinj.poison_for(uid_of, 3, done, block)
        assert inj.fired == jinj.fired
    assert FaultInjector().poison_for(uid_of, 3, 0, 8) == (-1, -1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_watchdog_matches_reference(seed):
    """Random step times with injected slow steps, factors and windows: the
    same flags, straggler steps and medians after every observation."""
    rng = np.random.default_rng(seed)
    factor, window = float(rng.choice([2.0, 3.0])), int(rng.choice([8, 12, 50]))
    w, jw = StepWatchdog(factor, window), jft.StepWatchdog(factor, window)
    for step in range(80):
        t = float(rng.uniform(0.9, 1.1) * (5.0 if rng.random() < 0.1 else 1.0) * (3.0 if step > 50 else 1.0))
        assert w.observe(step, t) == jw.observe(step, t)
        assert w.median == jw.median
    assert w.straggler_steps == jw.straggler_steps and w.straggler_steps


def test_watchdog_warmup_regression_and_rebaseline():
    """The reference's cases: nothing flags in the first five steps; a step
    over factor x the rolling median flags, and a sustained slowdown
    re-baselines so only its edge flags; the median of an empty window is 0."""
    w = StepWatchdog(straggler_factor=2.0)
    assert w.observe(0, 100.0) is False
    assert not any(w.observe(i, 100.0 if i % 2 else 0.01) for i in range(1, 5))
    w = StepWatchdog(straggler_factor=3.0, window=8)
    for i in range(8):
        w.observe(i, 1.0)
    assert w.observe(8, 3.5) is True and w.observe(9, 2.9) is False
    for i in range(10, 18):
        w.observe(i, 2.9)
    assert w.median == 2.9 and w.observe(18, 3.5) is False and w.straggler_steps == [8]
    assert StepWatchdog(window=4).median == 0.0


# --------------------------------------------------------------------------- #
# the engine across frameworks: tiers and preemption
# --------------------------------------------------------------------------- #
def _to_jax(tree):
    """The port's params tree as the reference's (fp32 arrays; the row-padded
    factor views as contiguous arrays)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jax.numpy.asarray(np.ascontiguousarray(tree.numpy()))


def _compressed_pair(arch):
    """Reduced ``arch`` in fp32, spectralized and compressed by the port's RSI
    (alpha 0.5, q 2, min_dim 16, as the reference's tier test), and the same
    params in the reference's model."""
    tm = build_model(dataclasses.replace(get_arch(arch, reduced=True), dtype="float32"), device="cpu")
    tp = spectralize_params(tm.init(torch.Generator().manual_seed(0)), torch.Generator().manual_seed(9))
    tp, rep = compress_tree(tp, CompressionPolicy(alpha=0.5, q=2, min_dim=16), generator=torch.Generator().manual_seed(1))
    assert any(layer.compressed for layer in rep.layers)
    jm = j_build_model(dataclasses.replace(j_get_arch(arch, reduced=True), dtype="float32"))
    return jm, _to_jax(tp), tm, tp


@pytest.mark.parametrize("arch", DENSE_MOE)
def test_tier_tokens_match_reference_engine(arch):
    """Tiers (1.0, 0.5) served concurrently on one paged, prefix-sharing
    engine: each tier's greedy tokens are the reference Engine's on the same
    trace (both tiers' prompts repeat, so each tier's own index matches),
    every tier-1 factor is a view of the stored one, and the certificates
    agree with the reference's (tier 0 exactly zero, tier 1 positive and
    within 1e-3)."""
    jm, jp, tm, tp = _compressed_pair(arch)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tm.cfg.vocab, size=(9,)).astype(np.int32)
    tiers = (1.0, 0.5)

    def trace(eng, make):
        reqs = [eng.submit(make(prompt.copy(), 5, t)) for t in (0, 1)]
        eng.step()
        eng.step()
        reqs += [eng.submit(make(prompt.copy(), 4, t)) for t in (1, 0)]
        while eng.has_work:
            eng.step()
        return [r.tokens for r in reqs], eng

    kw = dict(n_slots=4, max_len=MAX_LEN, page_size=4, share_prefix=True, tiers=tiers, tier_q=2)
    want, jeng = trace(JEngine(jm, jp, **kw), lambda p, s, t: JRequest(prompt=p, max_new_tokens=s, tier=t))
    got, eng = trace(Engine(tm, tp, **kw), lambda p, s, t: Request(prompt=p, max_new_tokens=s, tier=t))
    assert got == want
    assert eng.shared_admissions == jeng.shared_admissions > 0
    for path, leaf in _leaves(eng._tier_params[1]):
        stored = dict(_leaves(tp))[path]
        assert leaf["a"].untyped_storage().data_ptr() == stored["a"].untyped_storage().data_ptr()
    c, jc = eng.tier_certificates, jeng.tier_certificates
    assert c[0].prob_deviation_bound == 0.0 and c[1].prob_deviation_bound > 0.0
    assert c[1].spectral_error == pytest.approx(jc[1].spectral_error, rel=1e-3)
    assert c[1].prob_deviation_bound == pytest.approx(jc[1].prob_deviation_bound, rel=1e-3)


@pytest.mark.parametrize("arch", RECURRENT)
def test_multi_tier_rejected_on_recurrent_families(arch):
    """A frozen slot's re-feeds integrate into recurrent state with another
    tier's params and never repair: the ssm and hybrid families refuse
    more than one tier, as the reference does, and take one."""
    tm = build_model(get_arch(arch, reduced=True), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="recurrent"):
        Engine(tm, tp, n_slots=2, max_len=MAX_LEN, tiers=(1.0, 0.5))
    Engine(tm, tp, n_slots=2, max_len=MAX_LEN, tiers=(1.0,))


@pytest.fixture(scope="module")
def llama_fp32():
    """Reduced llama3.2-1b in fp32, the reference's params bridged to the port."""
    jcfg = dataclasses.replace(j_get_arch("llama3.2-1b", reduced=True), dtype="float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_arch("llama3.2-1b", reduced=True), dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), device="cpu")


def _solo(tm, tp, prompt, steps, max_len=32):
    out = greedy_generate(tm, tp, {"tokens": torch.as_tensor(prompt[None]).long()}, steps=steps, max_len=max_len)
    return out[0].tolist()


@pytest.mark.parametrize("share", [True, False])
def test_preempt_resume_matches_reference(llama_fp32, share):
    """The pool holds one of the two requests: the priority-1 arrival preempts
    the running one, whose continuation resumes (with sharing, from its own
    rematerialized pages) and finishes with its uninterrupted tokens; both
    streams are the reference Engine's, one preemption, no page left."""
    jm, jp, tm, tp = llama_fp32
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(8,)).astype(np.int32) for _ in range(2)]
    steps = (10, 6)

    def trace(eng, make):
        r0 = eng.submit(make(prompts[0], steps[0], 0))
        eng.step()
        eng.step()
        emitted = len(r0.tokens)
        r1 = eng.submit(make(prompts[1], steps[1], 1))
        while eng.has_work:
            eng.step()
        return [r0.tokens, r1.tokens], (emitted, eng.preemptions, eng.pages_in_use, r0.status, r0.uid), eng

    kw = dict(n_slots=2, max_len=32, page_size=4, kv_pages=5, share_prefix=share, preempt=True, decode_block=2)
    want, jstate, _ = trace(JEngine(jm, jp, **kw), lambda p, s, pr: JRequest(prompt=p, max_new_tokens=s, priority=pr))
    got, state, eng = trace(Engine(tm, tp, **kw), lambda p, s, pr: Request(prompt=p, max_new_tokens=s, priority=pr))
    assert got == want and state == jstate
    assert 0 < state[0] < steps[0] and state[1:] == (1, 0, "ok", 0)
    assert got == [_solo(tm, tp, p, s) for p, s in zip(prompts, steps)]
    if share:
        assert eng.shared_admissions >= 1  # the continuation matched its own pages


def test_no_preemption_at_equal_priority(llama_fp32):
    _, _, tm, tp = llama_fp32
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(8,)).astype(np.int32) for _ in range(2)]
    eng = Engine(tm, tp, n_slots=2, max_len=32, page_size=4, kv_pages=5, preempt=True, decode_block=2)
    r0 = eng.submit(Request(prompt=prompts[0], max_new_tokens=10))
    eng.step()
    r1 = eng.submit(Request(prompt=prompts[1], max_new_tokens=6))
    while eng.has_work:
        eng.step()
    assert eng.preemptions == 0
    assert [r0.tokens, r1.tokens] == [_solo(tm, tp, prompts[0], 10), _solo(tm, tp, prompts[1], 6)]


# --------------------------------------------------------------------------- #
# the engine inside the port: the reference's overload cases
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def bf16():
    tm = build_model(get_arch("llama3.2-1b", reduced=True), device="cpu")
    return tm, tm.init(torch.Generator().manual_seed(0))


def _rand(rng, vocab, n):
    return rng.integers(0, vocab, size=(n,)).astype(np.int64)


def test_engine_degrades_admission_under_page_pressure():
    """With the pool nearly full a min_tier=1 request admits at tier 1 with
    its certificate, a min_tier=0 one stays at full rank, and the degraded
    request's tokens are those of the single-tier engine on slice_rank's
    params."""
    tm = build_model(get_arch("llama3.2-1b", reduced=True), device="cpu")
    tp = spectralize_params(tm.init(torch.Generator().manual_seed(0)), torch.Generator().manual_seed(9))
    tp, _ = compress_tree(tp, CompressionPolicy(alpha=0.5, q=2, min_dim=16), generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(30)
    p0, p1 = _rand(rng, tm.cfg.vocab, 8), _rand(rng, tm.cfg.vocab, 6)
    events = []
    eng = Engine(tm, tp, n_slots=2, max_len=32, page_size=4, kv_pages=10, decode_block=2, tiers=(1.0, 0.5),
                 tier_q=2, admission=AdmissionPolicy(n_tiers=2, degrade_free_frac=0.9),
                 on_event=lambda k, f: events.append(k))
    r0 = eng.submit(Request(prompt=p0, max_new_tokens=16, min_tier=0))
    eng.step()
    assert eng.n_active == 1 and eng._free_page_frac() < 0.9
    r1 = eng.submit(Request(prompt=p1, max_new_tokens=4, min_tier=1))
    while eng.has_work:
        eng.step()
    assert (r0.tier, r1.tier, eng.degraded_admissions) == (0, 1, 1) and events == ["degrade"]
    assert r1.certificate is not None and r1.certificate.prob_deviation_bound > 0.0
    assert r0.certificate.prob_deviation_bound == 0.0
    assert r0.status == r1.status == "ok" and (len(r0.tokens), len(r1.tokens)) == (16, 4)
    solo = Engine(tm, slice_rank(tp, 0.5), n_slots=1, max_len=32, page_size=4)
    assert solo.run([Request(prompt=p1, max_new_tokens=4)])[0].tokens == r1.tokens


def test_engine_sheds_expired_waiters_in_step(bf16):
    tm, tp = bf16
    rng = np.random.default_rng(31)
    eng = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, kv_pages=4, admission=AdmissionPolicy(n_tiers=1))
    r0 = eng.submit(Request(prompt=_rand(rng, tm.cfg.vocab, 8), max_new_tokens=8))
    waiter = eng.submit(Request(prompt=_rand(rng, tm.cfg.vocab, 4), max_new_tokens=4, deadline_ms=1.0))
    eng.step()
    time.sleep(0.01)
    finished = []
    while eng.has_work:
        finished.extend(eng.step())
    assert waiter in finished and waiter.status == "shed" and waiter.rejected.reason == "deadline-expired"
    assert waiter.rejected.uid == waiter.uid and waiter.tokens == []
    assert r0.status == "ok" and len(r0.tokens) == 8


def test_engine_graceful_drain_on_stop(bf16):
    """run(stop=...): the queue sheds with "shutdown", in-flight requests
    finish with every token (and the uninterrupted run's tokens)."""
    tm, tp = bf16
    rng = np.random.default_rng(32)
    reqs = [Request(prompt=_rand(rng, tm.cfg.vocab, 8), max_new_tokens=6) for _ in range(3)]
    eng = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, kv_pages=4)
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 2

    finished = eng.run(reqs, stop=stop)
    assert not eng.has_work and eng.pages_in_use == 0
    done = [r for r in finished if r.status == "ok"]
    shed = [r for r in finished if r.status == "shed"]
    assert len(done) >= 1 and len(shed) >= 1 and len(done) + len(shed) == 3
    for r in done:
        assert r.tokens == _solo(tm, tp, r.prompt, 6)
    assert all(r.rejected.reason == "shutdown" for r in shed)


def test_engine_drain_under_active_fault_injection(bf16):
    """A drain lands while a nan_logits fault quarantines a request: every
    request ends ok, error or shed ("shutdown"), none is lost, and no page,
    slot or reference is left."""
    tm, tp = bf16
    rng = np.random.default_rng(35)
    reqs = [Request(prompt=_rand(rng, tm.cfg.vocab, 6), max_new_tokens=8) for _ in range(4)]
    inj = FaultInjector(nan_logits=(0, 4))
    eng = Engine(tm, tp, n_slots=2, max_len=32, page_size=4, decode_block=2, injector=inj)
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 3

    finished = eng.run(reqs, stop=stop)
    assert not eng.has_work and inj.fired.get("nan_logits") == 1 and eng.quarantined == 1
    by_status: dict = {}
    for r in finished:
        by_status.setdefault(r.status, []).append(r)
    assert len(finished) == 4 and set(by_status) <= {"ok", "error", "shed"}
    assert len(by_status["error"]) == 1 and "non-finite" in by_status["error"][0].error
    assert by_status.get("shed") and all(r.rejected.reason == "shutdown" for r in by_status["shed"])
    assert all(len(r.tokens) == 8 for r in by_status.get("ok", []))
    assert eng.pages_in_use == 0 and eng.page_pool.n_free == eng.kv_pages and eng.scheduler.allocator.n_active == 0


@pytest.mark.parametrize("block", [1, 4])
def test_engine_quarantines_poisoned_request_others_unaffected(bf16, block):
    """Only the poisoned uid errors, with its tokens before the fault; every
    other request's tokens are the clean run's, and the engine serves on."""
    tm, tp = bf16
    rng = np.random.default_rng(33)
    prompts = [_rand(rng, tm.cfg.vocab, 6) for _ in range(3)]
    clean = Engine(tm, tp, n_slots=3, max_len=32, decode_block=block, injector=FaultInjector())
    refs = {r.uid: r.tokens for r in clean.run([Request(prompt=p, max_new_tokens=8) for p in prompts])}
    inj = FaultInjector(nan_logits=(1, 5))
    events = []
    eng = Engine(tm, tp, n_slots=3, max_len=32, decode_block=block, injector=inj,
                 on_event=lambda k, f: events.append((k, f["uid"])))
    by_uid = {r.uid: r for r in eng.run([Request(prompt=p, max_new_tokens=8) for p in prompts])}
    assert inj.fired.get("nan_logits") == 1 and eng.quarantined == 1 and events == [("quarantine", 1)]
    bad = by_uid[1]
    assert bad.status == "error" and "non-finite" in bad.error
    assert 0 < len(bad.tokens) < 8 and bad.tokens == refs[1][: len(bad.tokens)]
    assert all(by_uid[u].status == "ok" and by_uid[u].tokens == refs[u] for u in (0, 2))
    again = eng.run([Request(prompt=prompts[0], max_new_tokens=4)])[0]
    assert again.status == "ok" and again.tokens == refs[0][:4]


def test_injector_deny_pages_starves_admission_then_recovers(bf16):
    tm, tp = bf16
    rng = np.random.default_rng(34)
    inj = FaultInjector(deny_pages=(1, 3))
    eng = Engine(tm, tp, n_slots=1, max_len=32, page_size=4, kv_pages=8, injector=inj)
    r = eng.submit(Request(prompt=_rand(rng, tm.cfg.vocab, 6), max_new_tokens=4))
    eng.step()
    assert eng.n_waiting == 1 and inj.fired.get("deny_pages", 0) >= 1
    eng.step()
    assert eng.n_waiting == 1
    while eng.has_work:
        eng.step()
    assert r.status == "ok" and len(r.tokens) == 4


def test_watchdog_flags_injected_slow_steps(bf16):
    """slow_steps past the watchdog's warm-up make stragglers: each flagged
    step bumps straggler_flags and emits one "straggler" event."""
    tm, tp = bf16
    rng = np.random.default_rng(36)
    events = []
    eng = Engine(tm, tp, n_slots=2, max_len=48, decode_block=1, injector=FaultInjector(slow_steps=(12, 14),
                                                                                        slow_ms=300.0),
                 watchdog=StepWatchdog(straggler_factor=3.0, window=8), on_event=lambda k, f: events.append(k))
    eng.run([Request(prompt=_rand(rng, tm.cfg.vocab, 4), max_new_tokens=30) for _ in range(2)])
    assert eng.straggler_flags >= 1 and events.count("straggler") == eng.straggler_flags
    assert 12 in eng.watchdog.straggler_steps


@pytest.mark.parametrize("share", [True, False])
def test_export_inflight_resumes_on_a_second_engine(bf16, share):
    """export_inflight mid-run evicts every in-flight request (a chunking one
    as submitted, an active one as its continuation) and leaves no page or
    slot; the second engine finishes them with the uninterrupted tokens
    (folded into the original request objects)."""
    tm, tp = bf16
    rng = np.random.default_rng(37)
    prompts = [_rand(rng, tm.cfg.vocab, n) for n in (6, 13, 5)]
    kw = dict(n_slots=3, max_len=32, page_size=4, prefill_chunk=8, share_prefix=share, decode_block=2)
    eng = Engine(tm, tp, **kw)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=9)) for p in prompts]
    eng.step()
    eng.step()
    snap = eng.snapshot_inflight()
    assert {s["uid"] for s in snap} == {0, 1, 2}
    moved = eng.export_inflight()
    assert eng.exported == 3 and not eng.has_work and eng.pages_in_use == 0
    other = Engine(tm, tp, **kw)
    for r in moved:
        other.submit(r)
    while other.has_work:
        other.step()
    for r, p in zip(reqs, prompts):
        assert r.status == "ok" and r.tokens == _solo(tm, tp, p, 9)


def test_take_queue_and_shed_queue(bf16):
    tm, tp = bf16
    rng = np.random.default_rng(38)
    eng = Engine(tm, tp, n_slots=1, max_len=32)
    reqs = [eng.submit(Request(prompt=_rand(rng, tm.cfg.vocab, 4), max_new_tokens=3)) for _ in range(4)]
    eng.step()
    taken = eng.take_queue()
    assert taken == reqs[1:] and eng.n_waiting == 0
    for r in taken[:2]:
        eng.submit(r)
    shed = eng.shed_queue()
    assert [r.rejected.reason for r in shed] == ["shutdown", "shutdown"] and eng.n_waiting == 0
    assert [r.rejected.queue_depth for r in shed] == [2, 1]


def test_serve_launcher_overload_flags(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--gen", "6", "--batch", "4",
                       "--n-slots", "2", "--page-size", "4", "--compress-alpha", "0.3", "--q", "1",
                       "--tiers", "1.0,0.5", "--degrade-free-frac", "0.8", "--deadline-ms", "60000",
                       "--preempt", "--share-prefix"])
    out = capsys.readouterr().out
    assert "[overload] ok=4 shed=0" in out and "cert_bounds[t0<= 0 t1<=" in out
    assert all(r.status == "ok" and len(r.tokens) == 6 for r in done)
    assert any(r.tier == 1 for r in done)
