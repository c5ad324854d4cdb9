"""The rest of the port's RSI core against the reference, on the CPU, fp32:
``normalized_error``, ``effective_rank``, ``matmul_count``, the energy rank
rule, the Theorem 3.2 certificates, ``classification_dataset`` and the
optimizers.

Randomness is handed over, never shared: the reference draws each Omega and
each power-method start vector from its keys, and the port is given the same
values (``omega=``, ``omega_fn=``, ``v0=``).  Results are compared as S,
A @ B, errors and certificate fields, never raw U / Vt (eigh's sign).
Tolerances: normalized errors and certificate fields rtol 1e-3 (the two
frameworks' Cholesky / eigh round differently and the power method
amplifies it); ``effective_rank`` rtol 1e-5; ranks, decisions, counts and
the dataset exact; one optimizer step rtol 1e-4.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.llama3_2_1b import REDUCED as J_REDUCED  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

jcore = importlib.import_module("repro.core")
jbounds, jcompress, jrsi, jspectral = (importlib.import_module(f"repro.core.{m}")
                                       for m in ("bounds", "compress", "rsi", "spectral"))
jsynth = importlib.import_module("repro.data.synthetic")
jopt = importlib.import_module("repro.train.optimizer")
core = importlib.import_module("repro_torch.core")
bounds, compress, lowrank, rsi, spectral = (importlib.import_module(f"repro_torch.core.{m}")
                                            for m in ("bounds", "compress", "lowrank", "rsi", "spectral"))
synth = importlib.import_module("repro_torch.data.synthetic")
opt = importlib.import_module("repro_torch.train.optimizer")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the sweep needs hypothesis, as tests/test_bounds.py does
    given = None


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _normal(key, shape):
    return _t(jax.random.normal(key, shape, dtype=jnp.float32))


def _jax_omega_fn(jparams, key, n_layers):
    """The Omegas the reference's compress_tree draws, keyed by (path, layer):
    a stacked leaf's factors use the leaf key's split, the energy probe (layer
    None) the leaf key itself."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    keys = dict(zip(names, jax.random.split(key, len(names))))

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], n_layers)[layer]
        return _normal(k, shape)

    return omega_fn


@pytest.fixture(scope="module")
def slow_decay():
    C, D = 96, 160
    s = jspectral.vgg_like_spectrum(C)
    W = jspectral.synth_spectrum_matrix(jax.random.PRNGKey(0), C, D, s)
    return W, np.asarray(s)


# --------------------------------------------------------------------------- #
# spectral / rsi
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("q", [1, 2, 4])
def test_normalized_error_matches_reference(slow_decay, q):
    W, s = slow_decay
    k = 10
    res = jrsi.rsi(W, k, q, jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(4)
    want = jspectral.normalized_error(W, res.U, res.S, res.Vt, float(s[k]), key)
    got = spectral.normalized_error(_t(W), _t(res.U), _t(res.S), _t(res.Vt), float(s[k]),
                                    v0=_normal(key, (W.shape[1],)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
    # the port's own RSI, given the reference's Omega, lands on the same error
    omega = _normal(jax.random.PRNGKey(3), (W.shape[1], k))
    mine = rsi.rsi(_t(W), k, q, omega=omega)
    got2 = spectral.normalized_error(_t(W), mine.U, mine.S, mine.Vt, float(s[k]), v0=_normal(key, (W.shape[1],)))
    np.testing.assert_allclose(float(got2), float(want), rtol=1e-3)


@pytest.mark.parametrize("name", ["vgg", "flat", "zero_tail", "one"])
def test_effective_rank_matches_reference(name):
    s = {"vgg": np.asarray(jspectral.vgg_like_spectrum(200)), "flat": np.ones(37, np.float32),
         "zero_tail": np.concatenate([np.linspace(5, 1, 20), np.zeros(12)]).astype(np.float32),
         "one": np.array([3.0], np.float32)}[name]
    want = float(jspectral.effective_rank(jnp.asarray(s)))
    np.testing.assert_allclose(float(spectral.effective_rank(_t(s))), want, rtol=1e-5)


@pytest.mark.parametrize("q", [1, 2, 3, 4, 7])
def test_matmul_count_matches_reference(q):
    assert rsi.matmul_count(q) == jrsi.matmul_count(q) == core.matmul_count(q)


def test_core_exports_every_reference_name():
    names = [n for n in dir(jcore) if not n.startswith("_") and not isinstance(getattr(jcore, n), type(jcore))]
    missing = [n for n in names + ["certify_tier"] if not hasattr(core, n)]
    assert not missing, missing


# --------------------------------------------------------------------------- #
# the energy rank rule
# --------------------------------------------------------------------------- #
def test_energy_rule_sharp_spectrum():
    """tests/test_core_rsi.py::test_compress_tree_energy_rule on the port:
    eight large singular values of 256 hold 95% of the energy, so the rule
    picks a tiny rank.  The probe (rank 170) is numerically rank 8, so
    CholeskyQR fails in fp32: the reference's probe gives NaN singular
    values and rank 1; the port's RSI orthonormalizes that sketch by
    Householder QR, counts it in the layer's report, and finds the true
    rank, 8, from the reference's Omega and from its own."""
    s = jnp.concatenate([jnp.full((8,), 100.0), jnp.full((248,), 0.01)])
    W = jspectral.synth_spectrum_matrix(jax.random.PRNGKey(0), 256, 512, s).T
    jp = {"layer": {"wq": W}}
    jpolicy = jcompress.CompressionPolicy(rank_rule="energy", energy=0.95, q=3, min_dim=10)
    _, _, jrep = jcompress.compress_tree(jp, jpolicy, jax.random.PRNGKey(1))
    assert jrep.layers[0].rank <= 16, jrep.layers[0]
    # the port departs from the reference here on purpose: its NaN probe gives rank 1
    assert jrep.layers[0].rank == 1, jrep.layers[0]
    policy = compress.CompressionPolicy(rank_rule="energy", energy=0.95, q=3, min_dim=10)
    tp = {"layer": {"wq": _t(W)}}
    for kw in ({"omega_fn": _jax_omega_fn(jp, jax.random.PRNGKey(1), 1)},
               {"generator": torch.Generator().manual_seed(0)}):
        tcp, rep = compress.compress_tree(tp, policy, **kw)
        assert rep.layers[0].compressed
        assert rep.layers[0].rank == 8, rep.layers[0]
        assert rep.layers[0].qr_fallbacks > 0, rep.layers[0]
        approx = lowrank.materialize(tcp["layer"]["wq"])
        assert float(torch.linalg.matrix_norm(_t(W) - approx, ord=2)) < 0.02


@pytest.mark.parametrize("energy", [0.6, 0.8, 0.95])
def test_energy_rank_stated_matrix(energy):
    """A stated spectrum whose cumulative energy sits far from every
    threshold tested: the rule's rank is the exact answer, in both
    frameworks.  s_i = 2^(-i/8), i < 64, on a 64 x 128 matrix."""
    s = 2.0 ** (-np.arange(64) / 8.0)
    W = jspectral.synth_spectrum_matrix(jax.random.PRNGKey(2), 64, 128, jnp.asarray(s, jnp.float32))
    probe = (64 * 128 - 1) // (64 + 128)
    c2 = np.cumsum(s[:probe] ** 2) / np.sum(s[:probe] ** 2)
    want = int(np.searchsorted(c2, energy)) + 1
    assert np.min(np.abs(c2 - energy)) > 1e-3  # no rank within rounding of the threshold
    jp = {"w": W}
    jpol = jcompress.CompressionPolicy(rank_rule="energy", energy=energy, q=2, min_dim=8, break_even_only=False)
    _, _, jrep = jcompress.compress_tree(jp, jpol, jax.random.PRNGKey(5))
    pol = compress.CompressionPolicy(rank_rule="energy", energy=energy, q=2, min_dim=8, break_even_only=False)
    _, rep = compress.compress_tree({"w": _t(W)}, pol, omega_fn=_jax_omega_fn(jp, jax.random.PRNGKey(5), 1))
    assert rep.layers[0].rank == jrep.layers[0].rank == want


def test_energy_rule_matches_reference_on_reduced_llama():
    q = 2
    cfg = dataclasses.replace(J_REDUCED, dtype="float32")
    jparams = jspectral.spectralize_params(j_build_model(cfg).init(jax.random.PRNGKey(0)), jax.random.PRNGKey(9))
    key = jax.random.PRNGKey(1)
    jpolicy = jcompress.CompressionPolicy(rank_rule="energy", energy=0.9, q=q, min_dim=32)
    jcp, _, jrep = jcompress.compress_tree(jparams, jpolicy, key)
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    tpolicy = compress.CompressionPolicy(rank_rule="energy", energy=0.9, q=q, min_dim=32)
    tcp, trep = compress.compress_tree(tparams, tpolicy, omega_fn=_jax_omega_fn(jparams, key, cfg.n_layers))
    assert [(l.path, l.rank, l.compressed) for l in trep.layers] == [
        (l.path, l.rank, l.compressed) for l in jrep.layers]
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    n = 0
    for group in ("attn", "mlp"):
        for name, jleaf in jcp["layers"][group].items():
            if not jcore.is_lowrank(jleaf):
                continue
            tleaf = tcp["layers"][group][name]
            for i in range(cfg.n_layers):
                want = np.asarray(jleaf["a"][i] @ jleaf["b"][i])
                got = (tleaf["a"][i] @ tleaf["b"][i]).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
                n += 1
    assert n > 0


def test_unknown_rank_rule_raises():
    with pytest.raises(ValueError):
        compress.compress_tree({"w": torch.ones(64, 64)}, compress.CompressionPolicy(rank_rule="nope", min_dim=8),
                               generator=torch.Generator())


# --------------------------------------------------------------------------- #
# Theorem 3.2 certificates
# --------------------------------------------------------------------------- #
def _fields(c):
    return (c.spectral_error, c.feature_radius, c.prob_deviation_bound)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_certify_head_matches_reference(k):
    C, D = 10, 64
    W = jax.random.normal(jax.random.PRNGKey(0), (C, D)) * 0.3
    A, B = jrsi.rsi_factors(W, k, 3, jax.random.PRNGKey(1))
    calib = jax.random.normal(jax.random.PRNGKey(2), (128, D))
    key = jax.random.PRNGKey(3)
    want = jbounds.certify_head(W, A @ B, calib, key, rank=k, q=3, radius_slack=1.1)
    got = bounds.certify_head(_t(W), _t(A @ B), _t(calib), v0=_normal(key, (D,)), rank=k, q=3, radius_slack=1.1)
    np.testing.assert_allclose(_fields(got), _fields(want), rtol=1e-3)
    assert (got.rank, got.q) == (want.rank, want.q)
    for margin in (0.0, 2 * want.prob_deviation_bound + 0.1):
        assert got.guarantees_top1_stability(margin) == want.guarantees_top1_stability(margin)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("tier", [3, 6, 12])
def test_certify_tier_matches_reference(stacked, tier):
    C, D, r = 48, 80, 12
    s = jspectral.vgg_like_spectrum(C)
    n = 3 if stacked else 1
    Ws = [jspectral.synth_spectrum_matrix(jax.random.PRNGKey(10 + i), C, D, s) for i in range(n)]
    pairs = [jrsi.rsi_factors(W, r, 2, jax.random.PRNGKey(20 + i)) for i, W in enumerate(Ws)]
    a = jnp.stack([p[0] for p in pairs]) if stacked else pairs[0][0]
    b = jnp.stack([p[1] for p in pairs]) if stacked else pairs[0][1]
    key = jax.random.PRNGKey(5)
    want = jbounds.certify_tier(a, b, tier, key, q=2, feature_radius=2.5)
    got = bounds.certify_tier(_t(a), _t(b), tier, v0=_normal(key, (D,)), q=2, feature_radius=2.5)
    np.testing.assert_allclose(_fields(got), _fields(want), rtol=1e-3)
    assert (got.rank, got.q) == (want.rank, want.q)
    # the dropped tail's norm is the largest dropped singular value
    if tier < r:
        tail = max(float(torch.linalg.matrix_norm(_t(a).reshape(-1, C, r)[i, :, tier:]
                                                  @ _t(b).reshape(-1, r, D)[i, tier:, :], ord=2))
                   for i in range(n))
        np.testing.assert_allclose(got.spectral_error, tail, rtol=1e-3)
    else:
        assert got.spectral_error == 0.0


def test_softmax_jacobian_matches_reference():
    u = np.random.default_rng(0).standard_normal(12).astype(np.float32) * 4
    np.testing.assert_allclose(bounds.softmax_jacobian(_t(u)).numpy(),
                               np.asarray(jbounds.softmax_jacobian(jnp.asarray(u))), rtol=1e-5, atol=1e-7)
    assert bounds.softmax_perturbation_bound(0.3, 2.0) == jbounds.softmax_perturbation_bound(0.3, 2.0)


def _lemma_3_1(seed, C, scale):
    """Row sums of |J_sigma| equal 2 s_i (1 - s_i) and are <= 1/2."""
    u = torch.from_numpy(np.random.default_rng(seed).standard_normal(C).astype(np.float32) * scale)
    J = bounds.softmax_jacobian(u).numpy()
    s = torch.softmax(u, dim=-1).numpy()
    row_sums = np.abs(J).sum(axis=1)
    np.testing.assert_allclose(row_sums, 2 * s * (1 - s), atol=1e-5)
    assert (row_sums <= 0.5 + 1e-6).all()
    np.testing.assert_allclose(J, np.diag(s) - np.outer(s, s), atol=1e-6)


def _theorem_3_2(seed, C, D, k_frac):
    """||softmax(W~h+b) - softmax(Wh+b)||_inf <= 1/2 R ||W-W~||_2 for random
    W, the port's RSI W~ and a batch of features with ||h|| <= R."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((C, D), generator=g)
    b = torch.randn((C,), generator=g)
    k = max(1, int(k_frac * min(C, D)))
    A, B = rsi.rsi_factors(W, k, 2, generator=g)
    W_approx = A @ B
    h = torch.randn((32, D), generator=g)
    R = float(torch.max(torch.linalg.vector_norm(h, dim=-1)))
    spec_err = float(torch.linalg.svdvals((W - W_approx).double())[0])
    p = torch.softmax(h @ W.T + b, dim=-1)
    p2 = torch.softmax(h @ W_approx.T + b, dim=-1)
    lhs = float(torch.max(torch.abs(p - p2)))
    assert lhs <= bounds.softmax_perturbation_bound(spec_err, R) + 1e-5, (lhs, spec_err, R)


@pytest.mark.parametrize("seed", range(6))
def test_lemma_3_1_jacobian_row_sums_seeds(seed):
    rng = np.random.default_rng(100 + seed)
    _lemma_3_1(seed, int(rng.integers(2, 25)), float(rng.uniform(0.1, 20.0)))


@pytest.mark.parametrize("seed", range(6))
def test_theorem_3_2_bound_holds_seeds(seed):
    rng = np.random.default_rng(200 + seed)
    _theorem_3_2(seed, int(rng.integers(3, 17)), int(rng.integers(8, 65)), float(rng.uniform(0.2, 0.9)))


if given is not None:
    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), C=st.integers(2, 24), scale=st.floats(0.1, 20.0))
    def test_lemma_3_1_jacobian_row_sums(seed, C, scale):
        _lemma_3_1(seed, C, scale)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), C=st.integers(3, 16), D=st.integers(8, 64), k_frac=st.floats(0.2, 0.9))
    def test_theorem_3_2_bound_holds(seed, C, D, k_frac):
        _theorem_3_2(seed, C, D, k_frac)


def test_certificate_end_to_end():
    """tests/test_bounds.py::test_certificate_end_to_end on the port."""
    g = torch.Generator().manual_seed(0)
    C, D, k = 10, 64, 4
    W = torch.randn((C, D), generator=g) * 0.3
    A, B = rsi.rsi_factors(W, k, 3, generator=g)
    calib = torch.randn((128, D), generator=g)
    cert = bounds.certify_head(W, A @ B, calib, g, rank=k, q=3)
    p = torch.softmax(calib @ W.T, dim=-1)
    p2 = torch.softmax(calib @ (A @ B).T, dim=-1)
    assert float(torch.max(torch.abs(p - p2))) <= cert.prob_deviation_bound + 1e-4
    assert cert.guarantees_top1_stability(margin=2 * cert.prob_deviation_bound + 0.1)
    assert not cert.guarantees_top1_stability(margin=0.0)


# --------------------------------------------------------------------------- #
# data and optimizers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n,dim,margin", [(0, 8192, 256, 0.18), (1, 100, 17, 1.5), (123, 5, 3, 0.0)])
def test_classification_dataset_bitwise(seed, n, dim, margin):
    got = synth.classification_dataset(seed, n, dim, 10, margin=margin)
    want = jsynth.classification_dataset(seed, n, dim, 10, margin=margin)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"dense": {"w": (12, 20), "b": (20,)}, "stack": (3, 8, 6), "scale": ()}

    def make(sh):
        if isinstance(sh, dict):
            return {k: make(v) for k, v in sh.items()}
        return rng.standard_normal(sh).astype(np.float32)

    return make(shapes)


def _tree_t(tree):
    return {k: _tree_t(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(tree)


def _assert_trees(got, want, rtol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k], rtol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-7)


OPTIMIZERS = {
    "adamw": (lambda m, lr: m.adamw(lr)),
    "adamw_no_decay": (lambda m, lr: m.adamw(lr, weight_decay=0.0, b2=0.999)),
    "adafactor": (lambda m, lr: m.adafactor(lr)),
    "adafactor_decay": (lambda m, lr: m.adafactor(lr, weight_decay=0.05, clip_threshold=0.5)),
    "sgdm": (lambda m, lr: m.sgdm(lr)),
    "sgdm_nesterov": (lambda m, lr: m.sgdm(lr, nesterov=True)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    """Two updates (so the moments are not zero) at steps 6 and 7 of a cosine
    schedule: the updates, the state and the params after apply_updates."""
    params, g1, g2 = _opt_tree(0), _opt_tree(1), _opt_tree(2)
    jo = OPTIMIZERS[name](jopt, jopt.cosine_schedule(1e-2, 4, 20))
    to = OPTIMIZERS[name](opt, opt.cosine_schedule(1e-2, 4, 20))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _tree_t(params)
    ts = to.init(tp)
    for step, g in ((6, g1), (7, g2)):
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jnp.int32(step))
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(_tree_t(g), ts, tp, step)
        tp = opt.apply_updates(tp, tu)
        _assert_trees(tu, ju, 1e-4)
        _assert_trees(ts, js, 1e-4)
        _assert_trees(tp, jp, 1e-4)


@pytest.mark.parametrize("sched", ["cosine", "linear", "constant"])
def test_schedules_match_reference(sched):
    make = {"cosine": lambda m: m.cosine_schedule(3e-3, 20, 400), "linear": lambda m: m.linear_schedule(1e-3, 10, 100),
            "constant": lambda m: m.constant_schedule(5e-4)}[sched]
    jf, tf = make(jopt), make(opt)
    for step in (0, 1, 5, 10, 19, 20, 21, 99, 200, 399, 400, 450):
        np.testing.assert_allclose(float(tf(step)), float(jf(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _opt_tree(3)
    jc, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tc, tn = opt.clip_by_global_norm(_tree_t(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(opt.global_norm(_tree_t(g))), float(jopt.global_norm(g)), rtol=1e-6)
    _assert_trees(tc, jc, 1e-6)
