"""The port's training path against the reference, on the CPU.

On the CPU every kernel wrapper runs its plain version, and under grad the
dispatch runs each op through its autograd Function (``runtime/dispatch.py``),
whose backward is the plain code the card runs too.  The same seeded inputs
go through the JAX package: its losses, ``jax.vjp`` of its functions and its
``make_train_step``; params are built by the reference and carried over with
``bridge.params_from_numpy``.

Tolerances (fp32 throughout):
* cross-entropy values and feature gradients: rtol 1e-5 (summation order);
* each Function's gradients against ``jax.vjp``: 1e-5 of the largest
  gradient (the frameworks sum in different orders; measured ~5e-7);
* the train step over two steps: loss, aux and grad norm rtol 1e-5; every
  updated leaf atol 2e-4 (= 0.2 x the learning rate: AdamW's and
  Adafactor's first steps divide each gradient by its own magnitude, so an
  element whose gradient is near zero moves by up to a learning rate on a
  last-bit difference; measured 1e-4 at most) and rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.core import CompressionPolicy as JPolicy  # noqa: E402
from repro.core import compress_tree as j_compress_tree  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.attention import _flash as j_flash  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

LR = 1e-3
STEP_TOL = dict(rtol=1e-5, atol=2e-4)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x, grad=True):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(grad)


def _through(t: torch.Tensor, fn: str) -> bool:
    """Whether ``t``'s autograd graph holds a node of the Function ``fn``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        if type(node).__name__ == f"{fn}Backward":
            return True
        seen.add(node)
        todo += [n for n, _ in node.next_functions]
    return False


def _vjp(fn, primals, cotangent):
    """(out, grads) of ``fn`` at ``primals`` by ``jax.vjp``, jitted whole (one compile)."""
    return jax.jit(lambda p, c: (lambda o, f: (o, f(c)))(*jax.vjp(fn, *p)))(primals, cotangent)


def _close_grads(got, want, rel=1e-5):
    """Each of ``got`` (tensors) within ``rel`` of the largest |value| of its ``want``."""
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g is not None and tuple(g.shape) == w.shape
        np.testing.assert_allclose(tensor_to_numpy(g), w, rtol=0, atol=rel * float(np.abs(w).max()))


# --------------------------------------------------------------------------- #
# cross-entropy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_softmax_xent_matches_reference(z_loss):
    logits, tgt = _randn((2, 6, 48), 0, 3.0), np.random.default_rng(1).integers(0, 40, (2, 6))
    want = j_ts.softmax_xent(jnp.asarray(logits), jnp.asarray(tgt), real_vocab=40, z_loss=z_loss)
    got = t_ts.softmax_xent(_t(logits, False), torch.as_tensor(tgt), real_vocab=40, z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("S,n_chunks", [(12, 16), (16, 4), (7, 16)], ids=["halved_to_4", "divides", "prime_plain"])
def test_chunked_softmax_xent_value_and_feature_grad(S, n_chunks):
    """The chunked loss (padded vocab masked, z-loss) and its gradient with
    respect to the features, the head a tied table through the logits
    Function; n_chunks halves until it divides S (7: down to the plain loss)."""
    B, d, Vp, V = 2, 8, 48, 40
    feats, table = _randn((B, S, d), 2), _randn((Vp, d), 3, 0.5)
    tgt = np.random.default_rng(4).integers(0, V, (B, S))

    def j_loss(x):
        head = lambda h: jnp.matmul(h, jnp.asarray(table).T, preferred_element_type=jnp.float32)  # noqa: E731
        return j_ts.chunked_softmax_xent(x, jnp.asarray(tgt), head, real_vocab=V, n_chunks=n_chunks)

    want, want_g = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(feats))
    x, tab = _t(feats), _t(table, False)
    got = t_ts.chunked_softmax_xent(x, torch.as_tensor(tgt), lambda h: dispatch.logits_apply(h, tab),
                                    real_vocab=V, n_chunks=n_chunks)
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-8)


# --------------------------------------------------------------------------- #
# gradients through each Function, against jax.vjp of the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_lowrank_function_grads_match_reference(stacked):
    lead = (3,) if stacked else ()
    x, A, B = _randn(lead + (10, 32), 5), _randn(lead + (32, 6), 6, 0.2), _randn(lead + (6, 24), 7, 0.4)
    dy = _randn(lead + (10, 24), 8)
    y, want = _vjp(jref.lowrank_matmul_ref, (jnp.asarray(x), jnp.asarray(A), jnp.asarray(B)), jnp.asarray(dy))
    tx, tA, tB = _t(x), _t(A), _t(B)
    got = dispatch.lowrank_apply(tx, tA, tB)
    assert _through(got, "LowrankFn")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    _close_grads(torch.autograd.grad(got, (tx, tA, tB), torch.from_numpy(dy)), want)


FLASH_CASES = {  # B, Sq, Skv, H, KV, hd, vd, causal, window, q_offset, (q_chunk, kv_chunk) of the twin's own check
    "causal": (2, 16, 16, 4, 2, 16, 16, True, None, 0, (8, 4)),
    "window": (2, 16, 16, 4, 2, 16, 16, True, 5, 0, (8, 4)),
    "q_offset": (2, 12, 20, 4, 2, 16, 16, True, None, 8, (4, 4)),
    "g4": (2, 16, 16, 8, 2, 16, 16, True, None, 0, None),
    "mla_192_128": (1, 16, 16, 2, 2, 192, 128, True, None, 0, None),
    "noncausal": (2, 16, 16, 4, 2, 16, 16, False, None, 0, None),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_function_grads_match_reference_vjp(case):
    """FlashFn (the plain forward with its lse, then the twin of _flash_bwd)
    against jax.vjp of the reference's custom-VJP ``_flash`` at its default
    chunks; for the masked cases also the twin called directly at small
    chunks (several q and kv chunk pairs, the emptied ones skipped) against
    ``_flash`` at the same chunks."""
    B, Sq, Skv, H, KV, hd, vd, causal, window, qo, small = FLASH_CASES[case]
    q, k, v = _randn((B, Sq, H, hd), 9), _randn((B, Skv, KV, hd), 10), _randn((B, Skv, KV, vd), 11)
    do = _randn((B, Sq, H, vd), 12)
    for q_chunk, kv_chunk in ((2048, 1024),) + ((small,) if small else ()):
        out, want = _vjp(lambda a, b, c: j_flash(a, b, c, causal, window, q_chunk, kv_chunk, qo),  # noqa: B023
                         (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), jnp.asarray(do))
        tq, tk, tv = _t(q), _t(k), _t(v)
        if q_chunk == 2048:
            got_out = dispatch.flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=qo)
            assert _through(got_out, "FlashFn")
            got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(do))
        else:
            got_out, lse = tref.flash_fwd_ref(tq.detach(), tk.detach(), tv.detach(), causal=causal, window=window,
                                              q_offset=qo)
            got = tref.flash_bwd_ref(tq.detach(), tk.detach(), tv.detach(), got_out, lse, torch.from_numpy(do),
                                     causal=causal, window=window, q_offset=qo, q_chunk=q_chunk, kv_chunk=kv_chunk)
        _close_grads([got_out], [out])
        _close_grads(got, want)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_logits_function_grads_match_reference(tied, monkeypatch):
    """The logits Function against jax.vjp of the reference's fp32-accumulated
    head product; a block of 16 vocab rows, so the backward walks 3 blocks."""
    monkeypatch.setattr(tref, "LOGITS_BWD_ROWS", 16)
    x, table = _randn((2, 5, 8), 13), _randn((40, 8) if tied else (8, 40), 14, 0.5)
    dl = _randn((2, 5, 40), 15)
    head = (lambda t: t.T) if tied else (lambda t: t)
    out, want = _vjp(lambda a, t: jnp.matmul(a, head(t), preferred_element_type=jnp.float32),
                     (jnp.asarray(x), jnp.asarray(table)), jnp.asarray(dl))
    tx, tt = _t(x), _t(table)
    got = dispatch.logits_apply(tx, tt, tied=tied)
    assert _through(got, "LogitsFn")
    _close_grads([got], [out])
    _close_grads(torch.autograd.grad(got, (tx, tt), torch.from_numpy(dl)), want)


def test_ssd_function_grads_match_reference_mamba2_forward():
    """A whole Mamba2 layer (its scan through SsdScanFn) against jax.vjp of the
    reference's XLA ``mamba2_forward``: the gradients of the input and of
    every parameter.  L = 12 at chunk 4: three chunks of carried state."""
    jcfg = dataclasses.replace(j_get_arch("mamba2-130m", reduced=True), dtype="float32", ssm_chunk=4)
    tcfg = dataclasses.replace(get_arch("mamba2-130m", reduced=True), dtype="float32", ssm_chunk=4)
    jp = jax.device_get(jax.jit(lambda k: j_ssm.mamba2_init(k, jcfg, jnp.float32))(jax.random.PRNGKey(0)))
    u, dy = _randn((2, 12, jcfg.d_model), 16), _randn((2, 12, jcfg.d_model), 17)
    out, (want_p, want_u) = _vjp(lambda p, x: j_ssm.mamba2_forward(p, x, jcfg), (jp, jnp.asarray(u)),
                                 jnp.asarray(dy))
    leaves = [(path, t.requires_grad_()) for path, t in _flat(params_from_numpy(jp, "cpu"))]
    tu = _t(u)
    dispatch.reset_counters()
    got = t_ssm.mamba2_forward(t_ts.tree_from_paths(leaves), tu, tcfg)
    assert dispatch.counters_by_path().get(("ssd_scan", dispatch.PATH_REFERENCE)) == 1 and _through(got, "SsdScanFn")
    _close_grads([got], [out])
    grads = torch.autograd.grad(got, [tu] + [t for _, t in leaves], torch.from_numpy(dy))
    _close_grads(grads, [want_u] + [w for _, w in _flat(jax.device_get(want_p))])


# --------------------------------------------------------------------------- #
# no silent detach
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["decode_attention", "paged_decode_attention", "sketch_matmul", "mla_absorbed"])
def test_kernel_without_backward_raises_under_grad(op):
    """The guard's decision for a kernel with no backward: on ``cuda`` under
    ``auto``, an operand that requires grad in grad mode raises; without
    grad mode, on the CPU, or under ``reference`` it passes."""
    x = torch.zeros((2, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match=op):
        dispatch.check_no_backward(op, x, device_type="cuda")
    with torch.no_grad():
        dispatch.check_no_backward(op, x, device_type="cuda")
    dispatch.check_no_backward(op, x.detach(), device_type="cuda")
    dispatch.check_no_backward(op, x, device_type="cpu")
    dispatch.check_no_backward(op, x, device_type="cuda", config=dispatch.DispatchConfig(backend="reference"))


def test_dispatch_takes_the_functions_only_under_auto_and_grad():
    x, A, B = _t(_randn((4, 16), 0)), _t(_randn((16, 3), 1)), _t(_randn((3, 8), 2))
    assert _through(dispatch.lowrank_apply(x, A, B), "LowrankFn")
    with dispatch.use_dispatch(backend="reference"):  # autograd through the plain version itself
        assert not _through(dispatch.lowrank_apply(x, A, B), "LowrankFn")
    with torch.no_grad():
        assert dispatch.lowrank_apply(x, A, B).grad_fn is None


def test_checkpointed_functions_keep_the_forwards_dispatch_on_another_thread():
    """Autograd runs a CUDA backward, and so the checkpointed forward it
    recomputes, on its own thread, where the caller's thread-local dispatch
    config is not installed: ``bound_to_dispatch`` carries it over."""
    import threading

    seen = []
    with dispatch.use_dispatch(backend="reference"):
        bound = dispatch.bound_to_dispatch(lambda: seen.append(dispatch.active_dispatch().backend))
    worker = threading.Thread(target=bound)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and seen == ["reference"]
    assert dispatch.active_dispatch().backend == "auto"


# --------------------------------------------------------------------------- #
# the optimizer keeps each leaf's storage, the model's remat keeps its numerics
# --------------------------------------------------------------------------- #
def test_apply_updates_keeps_padded_factor_rows():
    a = _build.aligned_rows(torch.randn(6, 5))
    assert a.stride() == (8, 1)
    new = t_opt.apply_updates({"a": a}, {"a": torch.full((6, 5), 0.5)})["a"]
    assert new.stride() == a.stride() and new.data_ptr() != a.data_ptr()
    torch.testing.assert_close(new, a + 0.5, rtol=0, atol=0)


def test_remat_block_matches_no_remat_bitwise():
    """cfg.remat == "block" (groups of 2 blocks under torch.utils.checkpoint)
    changes the memory schedule only: loss and every gradient are the same
    bits as without it."""
    base = dataclasses.replace(get_arch("llama3.2-1b", reduced=True), dtype="float32", n_layers=3)
    batch = {k: torch.as_tensor(v) for k, v in JSyntheticLM(base, batch=2, seq=8, seed=1).at_step(0).items()}
    params = build_model(base, device="cpu").init(torch.Generator().manual_seed(0))
    outs = []
    for remat, group in (("none", 1), ("block", 2)):
        model = build_model(dataclasses.replace(base, remat=remat, remat_group=group), device="cpu")
        live = t_ts.tree_from_paths([(p, t.detach().requires_grad_()) for p, t in t_ts.tree_paths(params)])
        logits, _ = model.forward(live, batch)
        loss = t_ts.softmax_xent(logits, batch["targets"], real_vocab=base.vocab)
        outs.append([loss] + list(torch.autograd.grad(loss, [t for _, t in t_ts.tree_paths(live)])))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the train step against the reference's make_train_step
# --------------------------------------------------------------------------- #
STEP_CASES = {  # arch, compressed by the reference, optimizer, accum_steps
    "llama_compressed": ("llama3.2-1b", True, "adamw", 1),
    "mamba2_adafactor_accum2": ("mamba2-130m", False, "adafactor", 2),
    "phi_moe_aux": ("phi3.5-moe-42b-a6.6b", False, "adamw", 1),
}


def _optimizer(mod, name):
    return {"adamw": lambda: mod.adamw(mod.constant_schedule(LR)),
            "adafactor": lambda: mod.adafactor(mod.constant_schedule(LR))}[name]()


@pytest.fixture(scope="module")
def reference_steps():
    """case -> (initial params, [metrics of step 1, step 2], params after two
    steps), all numpy, from the reference's jitted make_train_step (params
    from a jitted init, and RSI compression at alpha 0.5, q = 4, min_dim 32)."""
    runs = {}

    def get(case):
        if case not in runs:
            arch, compressed, opt_name, accum = STEP_CASES[case]
            # remat off on this side (a shorter compile): it changes the reference's memory
            # schedule, not its numbers; the port's side keeps remat "block"
            cfg = dataclasses.replace(j_get_arch(arch, reduced=True), dtype="float32", remat="none")
            model, opt = j_build_model(cfg), _optimizer(j_opt, opt_name)

            def build(k0, k1):
                p = model.init(k0)
                return j_compress_tree(p, JPolicy(alpha=0.5, q=4, min_dim=32), k1)[0] if compressed else p

            p0 = jax.device_get(jax.jit(build)(jax.random.PRNGKey(0), jax.random.PRNGKey(1)))
            state = j_ts.TrainState(params=p0, opt_state=opt.init(p0), step=jnp.zeros((), jnp.int32))
            step = jax.jit(j_ts.make_train_step(model, opt, accum_steps=accum))
            data = JSyntheticLM(cfg, batch=4, seq=16, seed=3)
            metrics = []
            for i in range(2):
                state, m = step(state, jax.tree_util.tree_map(jnp.asarray, data.at_step(i)))
                metrics.append({k: float(v) for k, v in m.items()})
            runs[case] = (p0, metrics, jax.device_get(state.params))
        return runs[case]

    return get


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(reference_steps, case):
    """Two fp32 steps of the port's make_train_step from the reference's params
    and batches: loss, aux, grad norm each step, and every leaf after."""
    arch, _, opt_name, accum = STEP_CASES[case]
    p0, want_metrics, want_params = reference_steps(case)
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32")
    assert cfg.remat == "block"
    model, opt = build_model(cfg, device="cpu"), _optimizer(t_opt, opt_name)
    params = params_from_numpy(p0, "cpu")
    state = t_ts.TrainState(params=params, opt_state=opt.init(params), step=torch.zeros((), dtype=torch.int32))
    step = t_ts.make_train_step(model, opt, accum_steps=accum)
    data = JSyntheticLM(cfg, batch=4, seq=16, seed=3)
    dispatch.reset_counters()
    for i in range(2):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in data.at_step(i).items()})
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want_metrics[i][k], rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")
    if arch == "phi3.5-moe-42b-a6.6b":
        assert want_metrics[0]["aux_loss"] > 0
    assert int(state.step) == 2
    got = dict(_flat(state.params))
    want = dict(_flat(want_params))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(tensor_to_numpy(got[path]), np.asarray(want[path], np.float32), **STEP_TOL,
                                   err_msg=path)
    # the forward went through the Functions: the lowrank Function on a compressed model, the
    # flash one on every attention family, the logits one on every step
    paths = dispatch.counters_by_path()
    assert paths.get(("logits", dispatch.PATH_REFERENCE), 0) > 0
    if arch != "mamba2-130m":
        assert paths.get(("flash_attention", dispatch.PATH_REFERENCE), 0) > 0
