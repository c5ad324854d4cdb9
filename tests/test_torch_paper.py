"""The paper's experiments on the port against the reference's scripts, on
the CPU, fp32, at small sizes: Table 4.1's training and grid, Fig 4.1 and
Fig 4.2, the compression CLI and the quickstart.

The reference's own functions are loaded from ``benchmarks/`` (the MLP, its
training loop, ``vit_like_spectrum``) and run beside the port's twins; every
random draw is handed to the port (the test matrices, each Omega, the MLP's
init, the blend matrix, the error's start vector).  Tolerances: normalized
errors rtol 1e-3; trained params rtol 1e-4 after one update and 1e-3 after
20 steps (Adam's normalized steps carry each rounding difference forward);
ratios exact; top-1 and top-5 within 2 test rows of 512 (a row whose two
top logits lie within rounding of each other may flip).
"""

import contextlib
import importlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jcore = importlib.import_module("repro.core")
jcompress = importlib.import_module("repro.core.compress")
jlaunch = importlib.import_module("repro.launch.compress")
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import lowrank  # noqa: E402
from repro_torch.experiments import fig4_1, fig4_2, quickstart, table4_1  # noqa: E402
from repro_torch.launch import compress as tlaunch  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmarks"


def _bench(name):
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jt41, jf42 = _bench("table4_1"), _bench("fig4_2")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _normal(key, shape):
    return _t(jax.random.normal(key, shape, dtype=jnp.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), jax.device_get(tree))


def _assert_params(got, want, rtol):
    for layer, leaves in want.items():
        for name, w in leaves.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[layer][name].numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max())


def _jax_omega_fn(jparams, key):
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    keys = dict(zip(names, jax.random.split(key, len(names))))
    return lambda name, layer, shape: _normal(keys[name], shape)


# --------------------------------------------------------------------------- #
# Table 4.1
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mlp_data():
    Xtr, ytr, Xte, yte = table4_1.datasets(n_test=512)
    # the reference's quirk: the test set comes from the train set's means
    _, _, means = jt41.classification_dataset(0, 8192, jt41.DIMS[0], jt41.DIMS[-1], margin=jt41.MARGIN)
    rng = np.random.default_rng(123)
    want_y = rng.integers(0, jt41.DIMS[-1], size=512).astype(np.int32)
    np.testing.assert_array_equal(yte, want_y)
    np.testing.assert_array_equal(Xte, means[want_y] + rng.standard_normal((512, jt41.DIMS[0])).astype(np.float32))
    return Xtr, ytr, Xte, yte


@pytest.mark.parametrize("steps,rtol", [(2, 1e-4), (20, 1e-3)])
def test_table4_1_training_matches_reference(mlp_data, steps, rtol):
    """The port's autograd + AdamW training from the reference's init (step 0
    of the warm-up schedule has lr 0, so 2 steps make one update)."""
    Xtr, ytr, _, _ = mlp_data
    jinit = jt41._init_mlp(jax.random.PRNGKey(0))
    want = jt41._train_mlp(jinit, jnp.asarray(Xtr), jnp.asarray(ytr), steps=steps)
    got = table4_1.train_mlp(params_from_numpy(_np_tree(jinit), device="cpu"), torch.as_tensor(Xtr),
                             torch.as_tensor(ytr), steps=steps)
    _assert_params(got, _np_tree(want), rtol)


def test_table4_1_pipeline_matches_reference(mlp_data):
    """Train, blend with the slow-decay matrix and refit (20 + 20 steps),
    given the reference's init and blend matrix."""
    Xtr, ytr, _, _ = mlp_data
    jinit = jt41._init_mlp(jax.random.PRNGKey(0))
    jp = jt41._train_mlp(jinit, jnp.asarray(Xtr), jnp.asarray(ytr), steps=20)
    W = jcore.synth_spectrum_matrix(jax.random.PRNGKey(41), 512, 512, jcore.vgg_like_spectrum(512))
    jp["fc1"]["w"] = 0.5 * jp["fc1"]["w"] + 0.5 * W / jnp.linalg.norm(W) * jnp.linalg.norm(jp["fc1"]["w"])
    jp = jt41._train_mlp(jp, jnp.asarray(Xtr), jnp.asarray(ytr), steps=20)
    res = table4_1.run(alphas=(0.4,), qs=(2,), steps=20, refit_steps=20, n_test=512, device="cpu",
                       init_params=_np_tree(jinit), blend_fn=lambda i, shape: _t(W),
                       omega_fn=_jax_omega_fn(jp, jax.random.PRNGKey(7)))
    _assert_params(res["params"], _np_tree(jp), 1e-3)


def test_table4_1_grid_matches_reference(mlp_data):
    """The alpha x q grid on the reference's trained params and Omegas."""
    _, _, Xte, yte = mlp_data
    Xtr, ytr = mlp_data[:2]
    jp = jt41._train_mlp(jt41._init_mlp(jax.random.PRNGKey(0)), jnp.asarray(Xtr), jnp.asarray(ytr), steps=20)
    alphas, qs = (0.8, 0.6, 0.4, 0.2), (1, 4)
    want_base = jt41._accuracy(jp, jnp.asarray(Xte), jnp.asarray(yte))
    want = []
    for alpha in alphas:
        for q in qs:
            pol = jcompress.CompressionPolicy(alpha=alpha, q=q, min_dim=64, break_even_only=False)
            newp, _, rep = jcompress.compress_tree(jp, pol, jax.random.PRNGKey(7))
            want.append((rep.ratio, jt41._accuracy(newp, jnp.asarray(Xte), jnp.asarray(yte))))
    res = table4_1.run(alphas=alphas, qs=qs, n_test=512, device="cpu", trained_params=_np_tree(jp),
                       omega_fn=_jax_omega_fn(jp, jax.random.PRNGKey(7)))
    tol = 2 / 512 + 1e-9
    for k in ("top1", "top5"):
        assert abs(res["baseline"][k] - want_base[k]) <= tol
    assert [round(r["ratio"], 3) for r in res["rows"][::len(qs)]] == [1.461, 1.101, 0.739, 0.380]
    for row, (ratio, acc) in zip(res["rows"], want):
        assert row["ratio"] == ratio
        for k in ("top1", "top5"):
            assert abs(row[k] - acc[k]) <= tol, (row, acc)


# --------------------------------------------------------------------------- #
# Fig 4.1 and Fig 4.2 at 128 x 512
# --------------------------------------------------------------------------- #
def _jax_fig(W, s, ks, qs, trials, trial_seed, err_key):
    """The reference scripts' loop at a stated shape: each trial's Omega from
    PRNGKey(trial_seed + t), the error's start vector from ``err_key``."""
    out = {}
    for k in ks:
        for q in qs:
            errs = []
            for t in range(trials):
                res = jcore.rsi(W, k, q, jax.random.PRNGKey(trial_seed + t))
                errs.append(float(jcore.normalized_error(W, res.U, res.S, res.Vt, float(s[k]),
                                                         jax.random.PRNGKey(err_key))))
            out[(k, q)] = float(np.mean(errs))
    return out


def _omega_fn(D, trial_seed):
    return lambda k, q, t: _normal(jax.random.PRNGKey(0 if t is None else trial_seed + t), (D, k))


@pytest.mark.parametrize("fig", ["4_1", "4_2"])
def test_fig_errors_match_reference(fig):
    C, D, ks, qs, trials = 128, 512, (8, 16), (1, 4), 2
    if fig == "4_1":
        s, w_key, trial_seed, err_key, mod = jcore.vgg_like_spectrum(C), 0, 100, 7, fig4_1
        np.testing.assert_allclose(fig4_1.vgg_like_spectrum(C).numpy(), np.asarray(s), rtol=1e-6)
    else:
        s, w_key, trial_seed, err_key, mod = jf42.vit_like_spectrum(C), 1, 200, 8, fig4_2
        np.testing.assert_allclose(fig4_2.vit_like_spectrum(C).numpy(), np.asarray(s), rtol=1e-6)
    W = jcore.synth_spectrum_matrix(jax.random.PRNGKey(w_key), C, D, s)
    want = _jax_fig(W, s, ks, qs, trials, trial_seed, err_key)
    got = mod.run(trials=trials, ks=ks, qs=qs, shape=(C, D), device="cpu", W=_t(W),
                  omega_fn=_omega_fn(D, trial_seed), v0=_normal(jax.random.PRNGKey(err_key), (D,)))
    assert (got["C"], got["D"]) == (C, D)
    for row in got["rows"]:
        np.testing.assert_allclose(row["normalized_error"], want[(row["k"], row["q"])], rtol=1e-3)
        assert row["seconds"] > 0
    for k in ks:  # the paper's claim at this size too
        by_q = {r["q"]: r["normalized_error"] for r in got["rows"] if r["k"] == k}
        assert by_q[4] < by_q[1]
    if fig == "4_2":
        assert got["svd_seconds"] > 0 and all(r["svd_speedup"] > 0 for r in got["rows"])


def test_fig_default_draws_and_csv(capsys):
    """With nothing handed in, the twins draw from their own generators."""
    r1 = fig4_1.run(trials=1, ks=(8,), qs=(1, 3), shape=(64, 256), device="cpu")
    r2 = fig4_2.run(trials=1, ks=(8,), qs=(1, 3), shape=(64, 256), device="cpu")
    fig4_1.emit_csv(r1)
    fig4_2.emit_csv(r2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("fig4_1/k=8/q=1,") and out[2].startswith("fig4_2/exact_svd,")
    for r in (r1, r2):
        assert r["rows"][1]["normalized_error"] < r["rows"][0]["normalized_error"]
        assert all(row["normalized_error"] > 0.99 for row in r["rows"])


# --------------------------------------------------------------------------- #
# the compression CLI and the quickstart
# --------------------------------------------------------------------------- #
def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def test_cli_alpha_report_matches_reference():
    argv = ["--arch", "llama3.2-1b", "--reduced", "--min-dim", "32"]
    (_, jrep), _ = _quiet(jlaunch.main, argv)
    (tparams, trep), text = _quiet(tlaunch.main, argv + ["--device", "cpu"])
    assert [(l.path, l.rank, l.compressed) for l in trep.layers] == [
        (l.path, l.rank, l.compressed) for l in jrep.layers]
    assert trep.ratio == jrep.ratio
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    assert text.splitlines()[0] == trep.summary()
    assert lowrank.is_lowrank(tparams["layers"]["mlp"]["w_gate"])


@pytest.mark.parametrize("rule", ["alpha", "energy"])
def test_cli_errors_lines(rule):
    (_, rep), text = _quiet(tlaunch.main, ["--arch", "llama3.2-1b", "--reduced", "--min-dim", "32",
                                           "--rank-rule", rule, "--errors", "--device", "cpu"])
    errs = [float(line.rsplit(":", 1)[1]) for line in text.splitlines() if "spectral err" in line]
    compressed = [l for l in rep.layers if l.compressed]
    assert len(errs) == len(compressed) > 0
    assert all(np.isfinite(e) and e > 0 for e in errs)
    assert all(l.rank < lowrank.break_even_rank(*l.shape[-2:]) for l in compressed)


def test_quickstart_runs():
    out, text = _quiet(quickstart.main, ["--device", "cpu"])
    assert out["errors"][4] < out["errors"][2] < out["errors"][1]
    assert "certificate:" in text and out["certificate"].prob_deviation_bound > 0
