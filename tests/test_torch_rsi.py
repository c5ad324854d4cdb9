"""The port's RSI core (rsi, spectral, compress_tree) against the reference.

Randomness cannot be shared across frameworks, so the JAX side draws every
Gaussian test matrix from its own keys and the port is handed the same
values (``omega=`` / ``omega_fn=``).  ``eigh`` fixes singular vectors only up
to sign, so results are compared as S, A @ B and the normalized error —
never raw U / Vt.  Comparisons run in fp32 (tolerances 1e-4 relative on the
products: the two frameworks' Cholesky/eigh differ in rounding).
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

# both core packages re-export a function named `rsi`, which shadows the
# submodule of that name as a package attribute: import the modules by name
jcompress, jrsi, jspectral = (importlib.import_module(f"repro.core.{m}") for m in ("compress", "rsi", "spectral"))
compress, lowrank, rsi, spectral = (
    importlib.import_module(f"repro_torch.core.{m}") for m in ("compress", "lowrank", "rsi", "spectral")
)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def slow_decay():
    C, D = 96, 160
    s = jspectral.vgg_like_spectrum(C)
    W = jspectral.synth_spectrum_matrix(jax.random.PRNGKey(0), C, D, s)
    return W, np.asarray(s)


def test_vgg_like_spectrum_matches_reference():
    np.testing.assert_allclose(spectral.vgg_like_spectrum(300).numpy(),
                               np.asarray(jspectral.vgg_like_spectrum(300)), rtol=1e-6)


@pytest.mark.parametrize("q", [1, 3])
def test_rsi_matches_reference_with_shared_omega(slow_decay, q):
    W, _ = slow_decay
    k = 12
    key = jax.random.PRNGKey(5)
    ref = jrsi.rsi(W, k, q, key)
    omega = jax.random.normal(key, (W.shape[1], k), dtype=jnp.float32)
    got = rsi.rsi(_t(W), k, q, omega=_t(omega))
    np.testing.assert_allclose(got.S.numpy(), np.asarray(ref.S), rtol=1e-4)
    approx_ref = np.asarray((ref.U * ref.S[None, :]) @ ref.Vt)
    approx = ((got.U * got.S[None, :]) @ got.Vt).numpy()
    np.testing.assert_allclose(approx, approx_ref, rtol=1e-4, atol=1e-4)
    A, B = rsi.rsi_factors(_t(W), k, q, omega=_t(omega))
    jA, jB = jrsi.rsi_factors(W, k, q, key)
    np.testing.assert_allclose((A @ B).numpy(), np.asarray(jA @ jB), rtol=1e-4, atol=1e-4)


def test_rsi_q4_beats_rsvd(slow_decay):
    """The paper's claim on a slow-decay spectrum: q = 4 gives a smaller
    normalized error than q = 1 (RSVD), and never below the optimum 1."""
    W, s = slow_decay
    k = 12
    g = torch.Generator().manual_seed(0)
    v0 = torch.randn(W.shape[1], generator=torch.Generator().manual_seed(1))
    errs = {}
    for q in (1, 4):
        A, B = rsi.rsi_factors(_t(W), k, q, generator=g)
        errs[q] = float(spectral.normalized_error_factored(_t(W), A, B, float(s[k]), v0=v0, iters=64))
    assert errs[4] <= errs[1], errs
    assert errs[4] > 0.98, errs


def test_normalized_error_matches_reference(slow_decay):
    W, s = slow_decay
    k = 10
    A, B = jrsi.rsi_factors(W, k, 2, jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(4)
    want = jspectral.normalized_error_factored(W, A, B, s[k], key)
    v0 = jax.random.normal(key, (W.shape[1],), dtype=jnp.float32)
    got = spectral.normalized_error_factored(_t(W), _t(A), _t(B), float(s[k]), v0=_t(v0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_cholesky_qr2_orthonormal():
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((200, 24)).astype(np.float32))
    Q = rsi.cholesky_qr2(X)
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(24), atol=1e-5)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jrsi.cholesky_qr2(jnp.asarray(X.numpy()))),
                               rtol=1e-4, atol=1e-4)


def test_rsi_falls_back_to_householder_where_cholesky_qr_breaks_down():
    """From the second iteration on cond(X) ~ (s_1 / s_k)^2: past fp32's reach
    the Gram is not positive definite and CholeskyQR2 raises (the reference
    returns NaN factors there).  The port orthonormalizes that X by
    Householder QR, counted in QR_FALLBACKS, so RSI returns finite factors
    near the best rank k."""
    C, D, k = 160, 240, 48
    s = torch.tensor([10.0 ** (-i / 12) for i in range(C)])  # s_k = 1e-4: cond(X) ~ 1e8
    W = spectral.synth_spectrum_matrix(C, D, s, generator=torch.Generator().manual_seed(0))
    Y = torch.randn((D, k), generator=torch.Generator().manual_seed(1))
    X = W @ (W.T @ torch.linalg.qr(W @ Y)[0])  # the second iteration's sketch
    with pytest.raises(torch.linalg.LinAlgError):
        rsi.cholesky_qr2(X)
    before = rsi.QR_FALLBACKS.count
    Q = rsi._orthonormalize(X, "cholesky_qr2")
    assert rsi.QR_FALLBACKS.count == before + 1
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(k), atol=1e-5)
    A, B = rsi.rsi_factors(W, k, 3, omega=Y)
    assert bool(torch.isfinite(A).all() and torch.isfinite(B).all())
    err = float(torch.linalg.matrix_norm(W - A @ B, ord=2)) / float(s[k])
    assert err < 1.5, err


def test_synth_spectrum_and_spectralize():
    s = spectral.vgg_like_spectrum(40)
    W = spectral.synth_spectrum_matrix(40, 72, s, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(torch.linalg.svdvals(W).numpy(), s.numpy(), rtol=1e-4)
    p = {"w": torch.randn(3, 48, 64), "norm": torch.ones(3, 16), "b": torch.randn(64)}
    out = spectral.spectralize_params(p, torch.Generator().manual_seed(1))
    assert out["norm"] is p["norm"] and out["b"] is p["b"]
    for i in range(3):
        np.testing.assert_allclose(float(out["w"][i].norm()), float(p["w"][i].norm()), rtol=1e-4)
        sv = torch.linalg.svdvals(out["w"][i])
        s48 = spectral.vgg_like_spectrum(48)
        np.testing.assert_allclose((sv / sv[0]).numpy(), (s48 / s48[0]).numpy(), rtol=1e-3)


def test_stacked_norm_scales_are_never_compressed():
    """The reference's exclude pattern misses (L, d) norm stacks, which at
    min_dim <= L it compresses as matrices; the port excludes them."""
    p = {"layers": {"attn_norm": {"scale": torch.ones(16, 64)}, "mlp": {"w": torch.randn(64, 96)}}}
    _, rep = compress.compress_tree(p, compress.CompressionPolicy(alpha=0.3, q=1, min_dim=16),
                                    generator=torch.Generator().manual_seed(0))
    by_path = {l.path: l for l in rep.layers}
    assert by_path["layers/attn_norm/scale"].reason == "policy-excluded"
    assert by_path["layers/mlp/w"].compressed


def test_rsi_flops_matches_reference():
    assert rsi.rsi_flops(2048, 8192, 615, 4) == jrsi.rsi_flops(2048, 8192, 615, 4)
    assert rsi.rsi_flops(300, 500, 40, 2, oversample=8) == jrsi.rsi_flops(300, 500, 40, 2, oversample=8)


def _jax_omega_fn(jparams, key):
    """The Omegas the reference's compress_tree draws, keyed by (path, layer)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    keys = dict(zip(names, jax.random.split(key, len(names))))
    L = J_REDUCED.n_layers

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], L)[layer]
        return _t(jax.random.normal(k, shape, dtype=jnp.float32))

    return omega_fn


def test_compress_tree_matches_reference():
    q = 2
    cfg = dataclasses.replace(J_REDUCED, dtype="float32")
    jparams = jspectral.spectralize_params(j_build_model(cfg).init(jax.random.PRNGKey(0)),
                                           jax.random.PRNGKey(9))
    policy = jcompress.CompressionPolicy(alpha=0.3, q=q, min_dim=32)
    key = jax.random.PRNGKey(1)
    jcp, _, jrep = jcompress.compress_tree(jparams, policy, key)
    tpolicy = compress.CompressionPolicy(alpha=0.3, q=q, min_dim=32)
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    tcp, trep = compress.compress_tree(tparams, tpolicy, omega_fn=_jax_omega_fn(jparams, key))
    assert trep.ratio == pytest.approx(jrep.ratio)
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    # same decisions (the port also names stacked norm scales "policy-excluded",
    # where the reference skips these (2, 64) stacks on min-dim)
    assert [(l.path, l.rank, l.compressed) for l in trep.layers] == [
        (l.path, l.rank, l.compressed) for l in jrep.layers
    ]
    n = 0
    for group in ("attn", "mlp"):
        for name, jleaf in jcp["layers"][group].items():
            tleaf = tcp["layers"][group][name]
            assert lowrank.is_lowrank(tleaf)
            assert tuple(tleaf["a"].shape) == jleaf["a"].shape
            for i in range(cfg.n_layers):
                want = np.asarray(jleaf["a"][i] @ jleaf["b"][i])
                got = (tleaf["a"][i] @ tleaf["b"][i]).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
                n += 1
    assert n == 7 * cfg.n_layers
