"""minitron-4b and qwen2-72b in the port, held against the reference.

Reduced minitron-4b (2 layers, d 48, 3/1 heads: G = 3, the first main-path
model whose G is not a power of two) and reduced qwen2-72b (2 layers, d 64,
4/2 heads, QKV bias), reference params bridged in.  Both frameworks
initialise ``bq``/``bk``/``bv`` to zeros, which would prove nothing about
the bias, so the reference's biases are first filled from a numpy seed
with N(0, 0.02) values.

fp32 config: logits at rtol/atol 1e-4 (summation order and transcendental
implementations differ between the frameworks) and greedy tokens equal.
bf16: logits within 5e-2 of the reference's largest value (one ulp apart
at a rounding boundary propagates through the layers).  ``compress_tree``:
the same decisions and ranks (the 1-D biases stay dense), A @ B at rtol
1e-3, the port handed the reference's Omegas.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.train.serve_step import greedy_generate as j_greedy  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import lowrank  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

jcompress = importlib.import_module("repro.core.compress")
compress = importlib.import_module("repro_torch.core.compress")

ARCHS = ("minitron-4b", "qwen2-72b")
B, S, GEN = 2, 10, 5


def _with_bias(jparams, seed: int = 0):
    """The reference's tree with bq/bk/bv drawn from N(0, 0.02) (numpy seed)."""
    rng = np.random.default_rng(seed)
    attn = dict(jparams["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = jnp.asarray(0.02 * rng.standard_normal(attn[name].shape), attn[name].dtype)
    return {**jparams, "layers": {**jparams["layers"], "attn": attn}}


@pytest.fixture(scope="module")
def archs():
    """{arch: (reference cfg, reference params fp32 with biases drawn)}."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(j_get_arch(arch, reduced=True), dtype="float32")
        out[arch] = (jcfg, _with_bias(j_build_model(jcfg).init(jax.random.PRNGKey(0))))
    return out


def _models(arch, dtype):
    jcfg = dataclasses.replace(j_get_arch(arch, reduced=True), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(arch, reduced=True), dtype=dtype)
    return j_build_model(jcfg), build_model(tcfg, device="cpu")


def _params(archs, arch, dtype):
    jp = archs[arch][1]
    if dtype == "bfloat16":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def _tol(dtype, want):
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))


def test_configs_are_the_reference_configs():
    """CONFIG and REDUCED field for field, over the fields the port's config
    has (qwen2's optimizer and accum_steps among them)."""
    for arch in ARCHS:
        for reduced in (False, True):
            want = dataclasses.asdict(j_get_arch(arch, reduced=reduced))
            got = dataclasses.asdict(get_arch(arch, reduced=reduced))
            assert got == {k: want[k] for k in got}
    assert (j_get_arch("qwen2-72b").optimizer, j_get_arch("qwen2-72b").accum_steps) == ("adafactor", 4)
    assert (get_arch("qwen2-72b").optimizer, get_arch("qwen2-72b").accum_steps) == ("adafactor", 4)
    assert get_arch("minitron-4b").n_heads // get_arch("minitron-4b").n_kv_heads == 3
    assert get_arch("qwen2-72b").qkv_bias and not get_arch("minitron-4b").qkv_bias


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_every_arch_has_the_reference_training_fields(reduced):
    """remat, remat_group, optimizer and accum_steps of all ten archs equal the
    reference's (adafactor with 4 and 8 microbatches for qwen2-72b and
    deepseek-v2-236b, the defaults elsewhere)."""
    from repro_torch.configs.registry import ARCH_IDS

    fields = ("remat", "remat_group", "optimizer", "accum_steps")
    for arch in ARCH_IDS:
        want, got = j_get_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields], arch
    assert get_arch("deepseek-v2-236b").optimizer == "adafactor" and get_arch("deepseek-v2-236b").accum_steps == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_param_count_matches_reference(arch):
    assert analytic_param_count(get_arch(arch)) == j_analytic_param_count(j_get_arch(arch))
    assert analytic_param_count(get_arch(arch, reduced=True)) == j_analytic_param_count(j_get_arch(arch, reduced=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(archs, arch, dtype):
    jm, tm = _models(arch, dtype)
    jp, tp = _params(archs, arch, dtype)
    if tm.cfg.qkv_bias:
        assert float(tp["layers"]["attn"]["bk"].float().abs().max()) > 0
    toks = _tokens(tm.cfg.vocab)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}
    want = np.asarray(jm.forward(jp, jb)[0], np.float32)
    got = tm.forward(tp, tb)[0]
    np.testing.assert_allclose(tensor_to_numpy(got), want, **_tol(dtype, want))
    want_l, want_c = jm.prefill(jp, jb, S + GEN)
    got_l, got_c = tm.prefill(tp, tb, S + GEN)
    want_l = np.asarray(want_l, np.float32)
    np.testing.assert_allclose(tensor_to_numpy(got_l), want_l, **_tol(dtype, want_l))
    for name in ("k", "v"):
        wc = np.asarray(want_c["layers"][name].astype(jnp.float32))
        np.testing.assert_allclose(tensor_to_numpy(got_c["layers"][name]), wc, **_tol(dtype, wc))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_fp32(archs, arch):
    jm, tm = _models(arch, "float32")
    jp, tp = _params(archs, arch, "float32")
    toks = _tokens(tm.cfg.vocab, seed=1)
    want = np.asarray(j_greedy(jm, jp, {"tokens": jnp.asarray(toks)}, steps=GEN, max_len=S + GEN))
    got = greedy_generate(tm, tp, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}, steps=GEN, max_len=S + GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_omega_fn(jparams, key, n_layers):
    """The Omegas the reference's compress_tree draws, keyed by (path, layer)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    keys = dict(zip(names, jax.random.split(key, len(names))))

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], n_layers)[layer]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))

    return omega_fn


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_tree_matches_reference(archs, arch):
    jcfg, jp = archs[arch]
    key = jax.random.PRNGKey(1)
    jcp, _, jrep = jcompress.compress_tree(jp, jcompress.CompressionPolicy(alpha=0.3, q=2, min_dim=16), key)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    tcp, trep = compress.compress_tree(tp, compress.CompressionPolicy(alpha=0.3, q=2, min_dim=16),
                                       omega_fn=_jax_omega_fn(jp, key, jcfg.n_layers))
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    assert [(l.path, l.rank, l.compressed) for l in trep.layers] == [
        (l.path, l.rank, l.compressed) for l in jrep.layers]
    n = 0
    for group in ("attn", "mlp"):
        for name, jleaf in jcp["layers"][group].items():
            tleaf = tcp["layers"][group][name]
            if name.startswith("b"):  # the QKV biases stay dense, as in the reference
                assert not lowrank.is_lowrank(tleaf) and tleaf.dim() == 2
                np.testing.assert_array_equal(tensor_to_numpy(tleaf), np.asarray(jleaf))
                continue
            if not lowrank.is_lowrank(jleaf):
                assert not lowrank.is_lowrank(tleaf)
                continue
            for i in range(jcfg.n_layers):
                want = np.asarray(jleaf["a"][i] @ jleaf["b"][i])
                got = (tleaf["a"][i] @ tleaf["b"][i]).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
                n += 1
    assert n >= 5 * jcfg.n_layers
