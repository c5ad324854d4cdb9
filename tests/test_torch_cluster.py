"""The port's replicated serving cluster, held against the reference.

Pure host logic first, case for case against the reference's own classes
on the same inputs, with exact equality: ``RoutingPolicy.pick`` and
``FailoverBudget.backoff_ms`` over seeded random loads and salts,
``backoff_s`` and ``RetryableStep`` (the cases of
tests/test_fault_tolerance.py), ``FaultInjector``'s replica-level faults and
their ``fired`` counts, and ``EventLog``'s lines for the same emits.

Then the cluster on a reduced llama3.2-1b in fp32, spectralized and
compressed by the port's RSI.  Across frameworks: two replicas with no
fault emit the reference ``Engine``'s greedy tokens on the same params (one
JAX engine run, module-scoped).  Inside the port, the cases of
tests/test_cluster.py: a kill fault (failover, restart, probation, rejoin),
a hang caught by the heartbeat alone, a straggler step caught by the
watchdog alone, budget exhaustion into a structured
``replica_lost`` rejection, the probation state machine, the graceful
drain, the launcher's cluster flags, and cross-replica resume for every
chunk-capable arch.  Token checks follow the reference's per-compute-path
contract: a root that never failed over equals a single engine serving the
same trace; a failed-over root's credited prefix equals that stream, and
each resumed tail equals a fresh engine serving the continuation.

Timing: kill faults are deterministic by step, and their heartbeat floor
(30 s) never fires.  The hang case derives its heartbeat floor (50 x the
measured step median, at least 0.5 s) and its hang (10 x the resulting
deadline), and the straggler case its slow step (30 x the median) and
death floor (15 x), from step times measured on this machine, so no result
rests on a wall-clock margin under 10x.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.core import CompressionPolicy, compress_tree, spectralize_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402
from repro_torch.serving import (Cluster, Engine, EventLog, FailoverBudget, FaultInjector, Request,  # noqa: E402
                                 RoutingPolicy, StepWatchdog)
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

MAX_LEN = 32
ENG_KW = dict(n_slots=2, max_len=MAX_LEN, page_size=4, prefill_chunk=4, decode_block=2, share_prefix=True)
KILL_HEARTBEAT_MS = 30000.0  # kill cases: never the death signal


# --------------------------------------------------------------------------- #
# pure level, case for case against the reference's classes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_routing_policy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pol, jpol = RoutingPolicy(), jsched.RoutingPolicy()
    for _ in range(50):
        n = int(rng.integers(1, 6))
        ids = rng.permutation(8)[:n]
        loads = [(int(i), int(rng.integers(0, 3)), int(rng.integers(0, 4))) for i in ids]
        assert pol.pick(loads) == jpol.pick(loads)
    # the hand cases: depth dominates, then pages, then the lowest id
    for loads in ([(0, 3, 0), (1, 1, 99)], [(0, 2, 8), (1, 2, 3)], [(2, 1, 4), (0, 1, 4), (1, 1, 4)]):
        assert pol.pick(loads) == jpol.pick(loads)
    with pytest.raises(ValueError):
        pol.pick([])


@pytest.mark.parametrize("seed", range(3))
def test_failover_budget_backoff_matches_reference_to_the_bit(seed):
    rng = np.random.default_rng(seed)
    assert FailoverBudget().backoff_ms(5, salt=7) == jsched.FailoverBudget().backoff_ms(5, salt=7) == 0.0
    for base, cap in ((10.0, 50.0), (float(rng.uniform(0.5, 20)), float(rng.uniform(20, 400))), (3.0, 1e9)):
        b = FailoverBudget(max_failovers=3, base_ms=base, cap_ms=cap)
        jb = jsched.FailoverBudget(max_failovers=3, base_ms=base, cap_ms=cap)
        for attempt in range(-1, 8):
            for salt in [0, 1, 17] + [int(s) for s in rng.integers(0, 2**31, size=4)]:
                d = b.backoff_ms(attempt, salt=salt)
                assert d == jb.backoff_ms(attempt, salt=salt)
                raw = min(base * 2.0 ** max(attempt, 0), cap)
                assert raw / 2 <= d <= raw
    assert len({FailoverBudget(base_ms=10.0).backoff_ms(2, salt=s) for s in range(8)}) > 1


def test_backoff_s_matches_reference_to_the_bit():
    rng = np.random.default_rng(3)
    for _ in range(200):
        attempt, salt = int(rng.integers(-1, 10)), int(rng.integers(0, 2**40))
        base, cap = float(rng.uniform(0, 1)), float(rng.uniform(0.01, 4))
        assert tft.backoff_s(attempt, base_s=base, cap_s=cap, salt=salt) == jft.backoff_s(
            attempt, base_s=base, cap_s=cap, salt=salt)
    assert tft.backoff_s(3, base_s=0.0, cap_s=1.0) == 0.0


def _flaky(n_fail, exc=RuntimeError, value=42):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise exc(f"flap {calls['n']}")
        return value

    return fn, calls


def _retry_case(name, cls):
    """One case of tests/test_fault_tolerance.py on ``cls``: what it returned
    or raised, the calls made, the counters and the sleeps recorded."""
    naps = []
    kw = {}
    if name == "exhaustion":
        fn, calls = _flaky(10**9)
        kw = dict(max_retries=2)
    elif name == "non_retryable":
        fn, calls = _flaky(10**9, exc=TypeError)
        kw = dict(max_retries=5, retryable=(ValueError,))
    elif name == "zero_budget":
        fn, calls = _flaky(10**9, exc=ValueError)
        kw = dict(max_retries=0)
    elif name == "backoff_off":
        fn, calls = _flaky(2)
        kw = dict(max_retries=3)
    elif name == "backoff_armed":
        fn, calls = _flaky(4, value="up")
        kw = dict(max_retries=4, base_delay_s=0.1, max_delay_s=0.4, jitter_salt=7)
    else:  # "no_sleep_after_final"
        fn, calls = _flaky(10**9, exc=ValueError)
        kw = dict(max_retries=2, base_delay_s=0.05)
    r = cls(fn, sleep=naps.append, **kw)
    outcomes = []
    for _ in range(2 if name == "exhaustion" else 1):  # the wrapper stays usable after exhaustion
        try:
            outcomes.append(("value", r()))
        except Exception as e:  # noqa: BLE001 - the case records what propagated
            outcomes.append((type(e).__name__, str(e)))
    return dict(outcomes=outcomes, calls=calls["n"], retries=r.total_retries, attempts=r.total_attempts,
                backoffs=r.backoffs, backoff_s=r.total_backoff_s, naps=naps)


@pytest.mark.parametrize("case", ["exhaustion", "non_retryable", "zero_budget", "backoff_off", "backoff_armed",
                                  "no_sleep_after_final"])
def test_retryable_step_matches_reference(case):
    got, want = _retry_case(case, tft.RetryableStep), _retry_case(case, jft.RetryableStep)
    assert got == want
    if case == "backoff_armed":
        assert got["naps"] == [tft.backoff_s(k, base_s=0.1, cap_s=0.4, salt=7) for k in range(4)]
    if case == "exhaustion":
        assert got["outcomes"] == [("RuntimeError", "flap 3"), ("RuntimeError", "flap 6")]


def _drive_injector(inj):
    """The same replica-step calls on an injector: which raised (and how), and
    its fired counts."""
    raised = []
    for step in range(1, 9):
        for replica in (0, 1, 2):
            try:
                inj.on_replica_step(replica, step)
            except Exception as e:  # noqa: BLE001
                raised.append((replica, step, type(e).__name__, str(e)))
    return raised, dict(inj.fired)


@pytest.mark.parametrize("faults", [
    dict(kill_replica=(1, 4)),
    dict(hang_replica=(0, 2), hang_s=0.0),
    dict(slow_replica=(2, 3, 6), slow_ms=0.01),
    dict(kill_replica=(0, 5), hang_replica=(1, 1), hang_s=0.0, slow_replica=(1, 2, 8), slow_ms=0.01),
    dict(slow_replica=(0, 1, 4), slow_ms=0.0),  # a zero slow never fires
], ids=["kill", "hang", "slow", "all", "slow_zero"])
def test_injector_replica_faults_match_reference(faults):
    raised, fired = _drive_injector(FaultInjector(**faults))
    jraised, jfired = _drive_injector(jft.FaultInjector(**faults))
    assert fired == jfired and [r[:3] for r in raised] == [r[:3] for r in jraised]
    assert [r[3] for r in raised] == [r[3] for r in jraised]
    if "kill_replica" in faults:
        assert fired["kill_replica"] == 1 and raised[0][2] == "ReplicaKilled"
        assert issubclass(tft.ReplicaKilled, RuntimeError)


def test_injector_fired_count_is_locked_across_threads():
    """One injector serves every replica thread: concurrent slow faults lose
    no count."""
    inj = FaultInjector(slow_replica=(0, 0, 10**9), slow_ms=1e-6)

    def hammer():
        for i in range(500):
            inj.on_replica_step(0, i)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert inj.fired["slow_replica"] == 2000


def test_event_log_lines_match_reference(tmp_path):
    logs = {}
    for name, cls in (("port", EventLog), ("ref", jcluster.EventLog)):
        path = tmp_path / f"{name}.jsonl"
        log = cls(str(path))
        log.emit("replica_dead", {"replica": 1, "reason": "heartbeat-miss"})
        log.emit("bare")
        sink = log.sink(replica=3)
        sink("shed", {"uid": 7, "reason": "deadline-expired", "waited_ms": 1.5})
        sink("degrade", {"uid": 8, "tier": 1, "replica": 9})  # a field overrides a tag
        log.emit("odd", {"value": np.float32(0.5), "path": tmp_path})  # not JSON: str() of it
        log.close()
        log.emit("after_close", {})  # dropped, never raised
        logs[name] = [json.loads(line) for line in path.read_text().splitlines()]
    port, ref = logs["port"], logs["ref"]
    assert [list(r) for r in port] == [list(r) for r in ref]
    assert [{k: v for k, v in r.items() if k != "t_ms"} for r in port] == \
        [{k: v for k, v in r.items() if k != "t_ms"} for r in ref]
    assert all(isinstance(r["t_ms"], float) for r in port) and len(port) == 5


# --------------------------------------------------------------------------- #
# the cluster on a reduced llama
# --------------------------------------------------------------------------- #
def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jax.numpy.asarray(np.ascontiguousarray(tree.numpy()))


@pytest.fixture(scope="module")
def llama():
    """Reduced llama3.2-1b in fp32, spectralized and compressed by the port's
    RSI; the same params in the reference's model."""
    tm = build_model(dataclasses.replace(get_arch("llama3.2-1b", reduced=True), dtype="float32"), device="cpu")
    tp = spectralize_params(tm.init(torch.Generator().manual_seed(0)), torch.Generator().manual_seed(9))
    tp, rep = compress_tree(tp, CompressionPolicy(alpha=0.5, q=2, min_dim=16),
                            generator=torch.Generator().manual_seed(1))
    assert any(layer.compressed for layer in rep.layers)
    jm = j_build_model(dataclasses.replace(j_get_arch("llama3.2-1b", reduced=True), dtype="float32"))
    return tm, tp, jm, _to_jax(tp)


def _trace(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, vocab, size=(int(rng.integers(4, 7)),)).astype(np.int32),
                 max_new=int(rng.integers(8, 12))) for _ in range(n)]


def _build(trace, cls=Request):
    return [cls(prompt=t["prompt"].copy(), max_new_tokens=t["max_new"]) for t in trace]


def _factory(tm, tp, **kw):
    def make(_rid):
        return Engine(tm, tp, **{**ENG_KW, **kw})

    return make


def _single(tm, tp, trace):
    """The trace on one engine of the replicas' configuration."""
    reqs = _build(trace)
    Engine(tm, tp, **ENG_KW).run(reqs)
    assert all(r.status == "ok" for r in reqs)
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def trace_refs(llama):
    """Trace 1, its greedy tokens on one reference (JAX) Engine and on one of
    the port's, both of the replicas' configuration."""
    tm, tp, jm, jp = llama
    trace = _trace(tm.cfg.vocab, 6, seed=1)
    jreqs = _build(trace, JRequest)
    JEngine(jm, jp, **ENG_KW).run(jreqs)
    assert all(r.status == "ok" for r in jreqs)
    return trace, [list(r.tokens) for r in jreqs], _single(tm, tp, trace)


def _replay(tm, tp, prompt, max_new):
    req = Request(prompt=prompt, max_new_tokens=max_new)
    Engine(tm, tp, **ENG_KW).run([req])
    return list(req.tokens)


def _check_streams(clu, reqs, refs, trace, tm, tp):
    """The per-compute-path token contract (module docstring); returns how
    many roots failed over."""
    n_failed_over = 0
    resume_points = clu.stats()["resume_points"]
    for i, r in enumerate(reqs):
        assert r.status == "ok", f"req {i}: {r.status} ({r.rejected})"
        got = list(r.tokens)
        assert len(got) == trace[i]["max_new"]
        splits = resume_points.get(r.uid)
        if not splits:
            assert got == refs[i], f"unfailed req {i} diverged from the single engine"
            continue
        n_failed_over += 1
        assert got[: splits[0]] == refs[i][: splits[0]], f"req {i}: credited prefix not bit-identical"
        bounds = list(splits) + [len(got)]
        for j, k in enumerate(splits):
            end = bounds[j + 1]
            if end <= k:
                continue  # the replica died before the resume emitted anything
            cont = np.concatenate([trace[i]["prompt"], np.asarray(got[:k], np.int32)])
            assert got[k:end] == _replay(tm, tp, cont, trace[i]["max_new"] - k)[: end - k], (
                f"req {i}: resumed tail diverged from the continuation replay")
    return n_failed_over


def _drive_to_healthy(clu, rid, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        clu.check_health()
        if clu.replicas[rid].state == "healthy":
            return
        time.sleep(0.01)
    pytest.fail(f"replica {rid} never rejoined (state={clu.replicas[rid].state})")


def test_cluster_without_fault_matches_reference_engine(llama, trace_refs):
    tm, tp, _, _ = llama
    trace, jtokens, single = trace_refs
    clu = Cluster(_factory(tm, tp), 2, heartbeat_ms=KILL_HEARTBEAT_MS, straggler_min_s=1e9)
    try:
        reqs = _build(trace)
        done = clu.run(reqs, timeout_s=120.0)
        assert sorted(r.uid for r in done) == list(range(len(trace)))
        assert all(r.status == "ok" for r in reqs)
        assert [list(r.tokens) for r in reqs] == jtokens == single
        stats = clu.stats()
        assert stats["failovers"] == stats["replica_deaths"] == stats["exhausted"] == 0
        assert all(rep.eng.steps > 0 for rep in clu.replicas)  # the router spread the trace
    finally:
        clu.close()


def test_cluster_kill_failover_restart_rejoin(llama, trace_refs, tmp_path):
    tm, tp, _, _ = llama
    trace, _, refs = trace_refs
    inj = FaultInjector(kill_replica=(0, 3))
    log_path = tmp_path / "events.jsonl"
    log = EventLog(str(log_path))
    clu = Cluster(_factory(tm, tp), 2, heartbeat_ms=KILL_HEARTBEAT_MS, budget=FailoverBudget(max_failovers=3),
                  injector=inj, probation_s=0.05, straggler_min_s=1e9, event_log=log)
    try:
        reqs = _build(trace)
        clu.run(reqs, timeout_s=120.0)
        assert inj.fired.get("kill_replica") == 1
        rep0 = clu.replicas[0]
        with rep0.health_lock:
            step_error = rep0.step_error
        assert isinstance(step_error, tft.ReplicaKilled)
        assert rep0.state == "dead" and not rep0.thread_alive
        stats = clu.stats()
        assert stats["replica_deaths"] == 1 and stats["failovers"] >= 1 and stats["exhausted"] == 0
        assert _check_streams(clu, reqs, refs, trace, tm, tp) >= 1  # the kill landed on live work

        # a second run before the restart: the killed replica stays down
        between_trace = _trace(tm.cfg.vocab, 2, seed=8)
        between = _build(between_trace)
        clu.run(between, timeout_s=120.0)
        assert not rep0.thread_alive and rep0.state == "dead"
        assert [list(r.tokens) for r in between] == _single(tm, tp, between_trace)

        inj.kill_replica = None  # disarm before the fresh engine steps
        with pytest.raises(RuntimeError):
            clu.restart_replica(1)  # a live replica is not rebuilt
        old, survivor = rep0.eng, clu.replicas[1].eng
        more_trace, late_trace = _trace(tm.cfg.vocab, 4, seed=9), _trace(tm.cfg.vocab, 2, seed=10)
        more, late = _build(more_trace), _build(late_trace)
        state = {"restarted": False, "late": False}

        def during():  # polled on the monitor thread: restart while replica 1 serves
            if not state["restarted"] and survivor.n_active > 0:
                clu.restart_replica(0)
                state["restarted"] = True
            elif state["restarted"] and not state["late"] and clu.replicas[0].state == "healthy":
                for r in late:
                    clu.submit(r)
                state["late"] = True
            return False

        clu.run(more, stop=during, timeout_s=120.0)
        assert state["restarted"]
        if not state["late"]:  # replica 1 finished first: route the two after the rejoin
            _drive_to_healthy(clu, 0)
            clu.run(late, timeout_s=120.0)
        assert clu.replicas[0].eng is not old and old._graphs == {}
        assert clu.replicas[0].thread_alive and clu.replicas[0].state == "healthy"
        assert clu.stats()["rejoins"] == 1
        assert [list(r.tokens) for r in more + late] == _single(tm, tp, more_trace + late_trace)
        assert clu.replicas[0].eng.steps > 0  # the restarted engine served a late request
    finally:
        clu.close()
        log.close()
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    kinds = [e["event"] for e in events]
    for kind in ("replica_dead", "failover", "failover_resumed", "replica_restart", "replica_probation",
                 "replica_rejoin"):
        assert kind in kinds, kinds
    dead = next(e for e in events if e["event"] == "replica_dead")
    assert dead["replica"] == 0 and dead["reason"] == "step-error:ReplicaKilled"
    assert kinds.index("replica_restart") < kinds.index("replica_probation") < kinds.index("replica_rejoin")


def _warm(eng, vocab):
    """Run a few requests, then reseed the watchdog with steady step times
    (the adaptive deadline reads them)."""
    for t in _trace(vocab, 3, seed=123):
        eng.run([Request(prompt=t["prompt"], max_new_tokens=t["max_new"])])
    eng.watchdog = StepWatchdog()
    eng.run(_build(_trace(vocab, 2, seed=124)))
    eng.reset_prefix_cache()
    eng.reset_counters()


def test_cluster_hang_caught_by_heartbeat_alone(llama, trace_refs):
    tm, tp, _, _ = llama
    trace, _, refs = trace_refs
    inj = FaultInjector(hang_replica=(0, 3))
    clu = Cluster(_factory(tm, tp), 2, injector=inj, budget=FailoverBudget(max_failovers=3), probation_s=0.05,
                  straggler_min_s=1e9)
    try:
        for rep in clu.replicas:
            _warm(rep.eng, tm.cfg.vocab)
        median = max(rep.eng.watchdog.median for rep in clu.replicas)
        clu.heartbeat_ms = max(0.5, 50 * median) * 1e3
        inj.hang_s = 10 * max(clu._deadline_s(rep) for rep in clu.replicas)
        reqs = _build(trace)
        clu.run(reqs, timeout_s=120.0 + inj.hang_s)
        assert inj.fired.get("hang_replica") == 1
        stats = clu.stats()  # nothing raised: only the silent heartbeat caught it
        assert stats["heartbeat_misses"] == 1 and stats["replica_deaths"] == 1
        assert stats["failovers"] >= 1 and stats["exhausted"] == 0
        with clu.replicas[0].health_lock:
            assert clu.replicas[0].step_error is None
        assert _check_streams(clu, reqs, refs, trace, tm, tp) >= 1
        # the hung thread lives on: once the hang ends it drains and rejoins
        assert clu.replicas[0].thread_alive
        _drive_to_healthy(clu, 0, timeout_s=inj.hang_s + 30.0)
        assert clu.stats()["rejoins"] == 1
        assert clu.replicas[0].eng.pages_in_use == 0  # the drain released every page
    finally:
        clu.close()


def test_cluster_straggler_death(llama, trace_refs):
    """One slow step inside replica 0's engine (the engine-level fault, so
    its watchdog times it): flagged above 3 x the median, and above the
    cluster's floor, it is the only death signal (the heartbeat floor is
    30 s).  The fault is armed at the replica's next step, so no healthy
    step comes before it; the floor is at least 1 s (and 15 x the measured
    median), and the slow step 4 x the floor, so a healthy step would have
    to stall for a second under the suite's load to die, and the injected
    one exceeds the floor four-fold."""
    tm, tp, _, _ = llama
    trace, _, refs = trace_refs
    eng_inj = FaultInjector()

    def make(rid):
        eng = Engine(tm, tp, **ENG_KW)
        if rid == 0:
            eng.injector = eng_inj
        return eng

    clu = Cluster(make, 2, heartbeat_ms=KILL_HEARTBEAT_MS, budget=FailoverBudget(max_failovers=3), probation_s=0.05)
    try:
        for rep in clu.replicas:
            _warm(rep.eng, tm.cfg.vocab)
        clu.straggler_min_s = max(1.0, 15 * max(rep.eng.watchdog.median for rep in clu.replicas))
        slow_s = 4 * clu.straggler_min_s
        base = clu.replicas[0].eng._step_idx  # the engine's next step is base + 1
        eng_inj.slow_ms, eng_inj.slow_steps = slow_s * 1e3, (base + 1, base + 2)
        reqs = _build(trace)
        clu.run(reqs, timeout_s=120.0)
        assert eng_inj.fired.get("slow_step") == 1 and clu.replicas[0].eng.straggler_flags >= 1
        stats = clu.stats()
        assert stats["heartbeat_misses"] == 0 and stats["replica_deaths"] == 1 and stats["exhausted"] == 0
        assert clu.replicas[1].state == "healthy"
        _check_streams(clu, reqs, refs, trace, tm, tp)
        _drive_to_healthy(clu, 0)  # its thread lives: it drains and rejoins
    finally:
        clu.close()


def test_cluster_budget_exhaustion_structured_rejection(llama):
    tm, tp, _, _ = llama
    inj = FaultInjector(kill_replica=(0, 3))
    clu = Cluster(_factory(tm, tp), 1, heartbeat_ms=KILL_HEARTBEAT_MS, budget=FailoverBudget(max_failovers=0),
                  injector=inj, straggler_min_s=1e9)
    try:
        reqs = _build(_trace(tm.cfg.vocab, 2, seed=4))
        clu.run(reqs, timeout_s=120.0)
        assert inj.fired.get("kill_replica") == 1
        stats = clu.stats()
        assert stats["exhausted"] == 2 and stats["failovers"] == 0
        for r in reqs:  # nothing vanishes: every root ends with a reason
            assert r.status == "shed" and r.rejected is not None
            assert r.rejected.reason == "replica_lost" and r.rejected.uid == r.uid
    finally:
        clu.close()


def test_cluster_probation_rejoin_state_machine(llama):
    tm, tp, _, _ = llama
    clu = Cluster(_factory(tm, tp), 1, heartbeat_ms=50.0, cold_grace_s=0.05, probation_s=0.1, straggler_min_s=1e9)
    try:
        clu.start()
        rep = clu.replicas[0]
        deadline = time.monotonic() + 5.0
        while rep.state == "healthy" and time.monotonic() < deadline:
            with rep.health_lock:  # a wedged device: the beat stops
                rep.last_beat = time.monotonic() - 1.0
            clu.check_health()
        assert rep.state == "dead" and clu.stats()["heartbeat_misses"] >= 1
        with rep.health_lock:
            assert rep.state_cmd == "drain"
        deadline = time.monotonic() + 5.0
        while rep.state == "dead" and time.monotonic() < deadline:
            clu.check_health()
            time.sleep(0.01)
        assert rep.state == "probation"
        with rep.health_lock:
            assert rep.drained
        t_probation = time.monotonic()
        _drive_to_healthy(clu, 0)
        assert time.monotonic() - t_probation >= clu.probation_s * 0.5
        assert clu.stats()["rejoins"] == 1
        with rep.health_lock:
            assert rep.state_cmd == "run"
    finally:
        clu.close()


def test_cluster_graceful_drain(llama):
    """The first ``stop()`` once a slot is busy: the queued roots shed with
    "shutdown", the in-flight ones finish with the single engine's tokens
    (12 requests of 16 tokens on 2 slots: the rest of the trace takes ~100
    decode blocks, the stop lands within a poll)."""
    tm, tp, _, _ = llama
    rng = np.random.default_rng(21)
    trace = [dict(prompt=rng.integers(0, tm.cfg.vocab, size=(5,)).astype(np.int32), max_new=16) for _ in range(12)]
    refs = _single(tm, tp, trace)
    clu = Cluster(_factory(tm, tp), 1, heartbeat_ms=KILL_HEARTBEAT_MS, straggler_min_s=1e9)
    try:
        reqs = _build(trace)
        done = clu.run(reqs, stop=lambda: clu.replicas[0].eng.n_active > 0, timeout_s=120.0)
        ok = [r for r in done if r.status == "ok"]
        shed = [r for r in done if r.status == "shed"]
        assert len(ok) + len(shed) == len(trace) and ok and shed
        assert all(r.rejected.reason == "shutdown" and r.tokens == [] for r in shed)
        assert all(r.tokens == refs[r.uid] for r in ok)
        assert clu.replicas[0].eng.pages_in_use == 0 and not clu.replicas[0].eng.has_work
    finally:
        clu.close()


def test_launcher_cluster_flags(tmp_path, capsys):
    """``--replicas 2 --heartbeat-ms --max-failovers --event-log`` on the CPU:
    every request served, the ``[cluster]`` line, a ``[paged rN]`` line a
    replica, and the event log's lines (every admission degrades to tier 1
    under ``--degrade-queue-depth 1``: one ``degrade`` line each, tagged
    with its replica)."""
    path = tmp_path / "events.jsonl"
    done = serve.main(["--arch", "llama3.2-1b", "--reduced", "--replicas", "2", "--heartbeat-ms", "30000",
                       "--max-failovers", "2", "--event-log", str(path), "--device", "cpu", "--batch", "4",
                       "--n-slots", "1", "--prompt-len", "6", "--gen", "5", "--page-size", "4",
                       "--compress-alpha", "0.3", "--tiers", "1.0,0.5", "--degrade-queue-depth", "1"])
    out = capsys.readouterr().out
    assert len(done) == 4 and all(r.status == "ok" and len(r.tokens) == 5 for r in done)
    assert ("[cluster] replicas=2 failovers=0 prefix_match=0 replica_deaths=0 heartbeat_misses=0 rejoins=0 "
            "replica_lost_rejections=0") in out
    assert "[paged r0]" in out and "[paged r1]" in out and f"[events] JSON lines appended to {path}" in out
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert sorted(e["uid"] for e in events if e["event"] == "degrade") != []
    assert all(e["event"] == "degrade" and e["replica"] in (0, 1) and e["tier"] == 1 for e in events)
    assert len(events) == 4 and {e["replica"] for e in events} == {0, 1}


CHUNK_ARCHS = [a for a in ARCH_IDS if get_arch(a, reduced=True).family in ("dense", "moe")
               and get_arch(a, reduced=True).sliding_window is None]


@pytest.mark.parametrize("arch_id", CHUNK_ARCHS)
def test_cross_replica_resume_bit_exact(arch_id):
    """export_inflight() on replica A, submit on replica B: the credited prefix
    is the undisturbed stream's, and the resumed tail is what a fresh engine
    emits for that continuation, for every arch the chunked-prefill path
    serves (the reference's case)."""
    tm = build_model(get_arch(arch_id, reduced=True), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, tm.cfg.vocab, size=(6,)).astype(np.int64)
    steps = 8
    kw = dict(n_slots=2, max_len=MAX_LEN, page_size=4, prefill_chunk=4, decode_block=2)
    ref = Engine(tm, tp, **kw).run([Request(prompt=prompt.copy(), max_new_tokens=steps)])[0]
    refs = list(ref.tokens)
    assert len(refs) == steps

    eng_a = Engine(tm, tp, **kw)
    r = eng_a.submit(Request(prompt=prompt.copy(), max_new_tokens=steps))
    guard = 0
    while len(r.tokens) < 3 and guard < 64:
        eng_a.step()
        guard += 1
    assert 0 < len(r.tokens) < steps, "the export must happen mid-decode"
    conts = eng_a.export_inflight()
    assert len(conts) == 1 and eng_a.exported == 1 and not eng_a.has_work and eng_a.pages_in_use == 0
    emitted = list(r.tokens)
    assert emitted == refs[: len(emitted)], "credited prefix diverged"

    eng_b = Engine(tm, tp, **kw)
    eng_b.submit(conts[0])
    while eng_b.has_work:
        eng_b.step()
    assert r.status == "ok" and len(r.tokens) == steps
    tail = list(r.tokens)[len(emitted):]
    replay = Request(prompt=np.concatenate([prompt, np.asarray(emitted, np.int64)]),
                     max_new_tokens=steps - len(emitted))
    Engine(tm, tp, **kw).run([replay])
    assert tail == list(replay.tokens), f"{arch_id}: resumed tail diverged from the continuation replay"
