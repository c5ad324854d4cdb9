"""The port's SSM slice against the reference: the SSD scan's plain
versions, the Mamba2 block, reduced mamba2-130m and zamba2-1.2b (dense and
RSI-compressed), and the serving engine on both.

Inputs are made from a seed with numpy (or drawn by JAX and bridged in) and
go through the JAX function and its port twin on the CPU.  The JAX SSD
kernel runs in interpret mode, as the reference's own tests run it.  On the
CPU the port's ``ssd_scan`` wrapper runs its plain version; the CUDA kernel
is held against that version on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances: the scan in fp32 2e-5 of the largest value (another summation
order: torch's einsum contractions and cumsum against XLA's), and 3e-2 in
bf16 (y is rounded to bf16; one ulp is 2^-8 relative, and both sides round
the same x̄ but may land on neighbouring values of y); blocks and models
fp32 1e-4 (matmuls, softplus, silu and exp of two frameworks, through every
layer); a bf16 block 5e-2 of the reference's largest value (a value one ulp
apart propagates), and a bf16 model one bf16 ulp of the largest value
against the reference run op by op (see
test_forward_prefill_and_decode_match_reference).  Greedy tokens are
compared exactly in fp32.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import mamba2_130m as j_mamba2  # noqa: E402
from repro.configs import zamba2_1_2b as j_zamba2  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.train.serve_step import greedy_generate as j_greedy  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import analytic_param_count, build_model  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

jcompress, jspectral = (importlib.import_module(f"repro.core.{m}") for m in ("compress", "spectral"))
compress, lowrank = (importlib.import_module(f"repro_torch.core.{m}") for m in ("compress", "lowrank"))

ARCHS = {"mamba2-130m": j_mamba2, "zamba2-1.2b": j_zamba2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCAN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _to_torch(a, dtype="float32"):
    """A JAX array as a torch tensor of ``dtype`` with the same values."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(DTYPES[dtype][1])


def _close_rel(got, want, rel):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(tensor_to_numpy(got), want, rtol=0, atol=rel * float(np.abs(want).max()))


def _model_close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(tensor_to_numpy(got), want, **tol)


def _scan_inputs(Bsz, L, nh, hd, s, dtype, seed=0):
    """(x, dt, B, C, A) as JAX arrays: x, B, C in ``dtype``; dt fp32 after
    softplus; A = -exp(A_log) as the model's init makes it."""
    rng = np.random.default_rng(seed)
    jd = DTYPES[dtype][0]
    x = jnp.asarray(rng.standard_normal((Bsz, L, nh, hd)), jnp.float32).astype(jd)
    dt = jax.nn.softplus(jnp.asarray(rng.standard_normal((Bsz, L, nh)), jnp.float32))
    Bm = jnp.asarray(rng.standard_normal((Bsz, L, s)) / s**0.5, jnp.float32).astype(jd)
    Cm = jnp.asarray(rng.standard_normal((Bsz, L, s)) / s**0.5, jnp.float32).astype(jd)
    A = -jnp.exp(jnp.log(jnp.linspace(1.0, 16.0, nh)))
    return x, dt, Bm, Cm, A


# --------------------------------------------------------------------------- #
# the SSD scan's plain versions
# --------------------------------------------------------------------------- #
# L values that keep, halve and collapse the chunk: 16 and 32 divide, 24
# halves 16 to 8, 20 to 4, a prime 13 above chunk 8 falls to Q = 1, and L = 1
SCAN_CASES = [(2, 32, 3, 8, 16, 16), (2, 24, 2, 16, 8, 16), (1, 20, 2, 8, 16, 16), (2, 13, 3, 8, 8, 8),
              (1, 1, 2, 8, 4, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bsz,L,nh,hd,s,chunk", SCAN_CASES)
def test_plain_scan_matches_pallas_kernel_raw_x(Bsz, L, nh, hd, s, chunk, dtype):
    """The TPU kernel's contract: raw x, x̄ = x * dt kept in fp32.  The plain
    version (the wrapper's CPU path) against ``ssd_scan_pallas`` in
    interpret mode, y and the final state."""
    x, dt, Bm, Cm, A = _scan_inputs(Bsz, L, nh, hd, s, dtype)
    want_y, want_s = ssd_scan_pallas(x, dt, Bm, Cm, A, chunk=chunk, interpret=True)
    got_y, got_s = ssd_scan(*(_to_torch(a, d) for a, d in ((x, dtype), (dt, "float32"), (Bm, dtype), (Cm, dtype),
                                                           (A, "float32"))), chunk=chunk, round_xbar=False)
    assert got_y.dtype == DTYPES[dtype][1] and got_s.dtype == torch.float32
    _close_rel(got_y, want_y, SCAN_TOL[dtype])
    _close_rel(got_s, want_s, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bsz,L,nh,hd,s,chunk", SCAN_CASES)
def test_plain_scan_matches_model_scan_and_oracle(Bsz, L, nh, hd, s, chunk, dtype):
    """The model's contract: x̄ rounded to x's dtype before the scan.  The
    chunked plain version against ``_ssd_chunk_scan`` (same chunk rule) and
    the sequential oracle ``ssd_scan_ref`` against the reference's oracle."""
    x, dt, Bm, Cm, A = _scan_inputs(Bsz, L, nh, hd, s, dtype, seed=1)
    xbar = (x.astype(jnp.float32) * dt[..., None]).astype(x.dtype)
    want_y, want_s = jssm._ssd_chunk_scan(xbar, dt, Bm, Cm, A, chunk)
    tx, tdt, tB, tC, tA = (_to_torch(a, d) for a, d in ((x, dtype), (dt, "float32"), (Bm, dtype), (Cm, dtype),
                                                         (A, "float32")))
    got_y, got_s = tref.ssd_scan_plain(tx, tdt, tB, tC, tA, chunk=chunk, round_xbar=True)
    np.testing.assert_array_equal(tensor_to_numpy(tref.ssd_xbar(tx, tdt, True)),
                                  np.asarray(xbar.astype(jnp.float32)))
    _close_rel(got_y, want_y, SCAN_TOL[dtype])
    _close_rel(got_s, want_s, 2e-5)
    seq_y, seq_s = jref.ssd_scan_ref(xbar, dt, Bm, Cm, A)
    got_y, got_s = tref.ssd_scan_ref(_to_torch(xbar, dtype), tdt, tB, tC, tA)
    _close_rel(got_y, seq_y, SCAN_TOL[dtype])
    _close_rel(got_s, seq_s, 2e-5)


def test_scan_contracts_and_chunk_rule():
    """The two x̄ contracts agree in fp32 and differ in bf16; the chunk rule
    is the reference's; the chunked scan with a carried state0 continues the
    unchunked one."""
    assert [tref.ssd_chunk_len(L, 16) for L in (32, 24, 20, 17, 13, 1)] == [16, 8, 4, 1, 13, 1]
    x, dt, Bm, Cm, A = (_to_torch(a) for a in _scan_inputs(2, 24, 2, 8, 8, "float32", seed=2))
    y0, s0 = tref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=8, round_xbar=False)
    y1, s1 = tref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=8, round_xbar=True)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    yr, _ = tref.ssd_scan_plain(xb, dt, Bb, Cb, A, chunk=8, round_xbar=False)
    yb, _ = tref.ssd_scan_plain(xb, dt, Bb, Cb, A, chunk=8, round_xbar=True)
    assert not torch.equal(yr, yb)
    xbar = tref.ssd_xbar(x, dt, False)
    _, s_half = tref.ssd_chunk_scan_ref(xbar[:, :16], dt[:, :16], Bm[:, :16], Cm[:, :16], A, 8)
    y_rest, s_rest = tref.ssd_chunk_scan_ref(xbar[:, 16:], dt[:, 16:], Bm[:, 16:], Cm[:, 16:], A, 8, state0=s_half)
    torch.testing.assert_close(y_rest, y0[:, 16:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_rest, s0, rtol=1e-5, atol=1e-5)


def test_dispatch_ssd_scan_paths_and_counter():
    """The op's counter signature is (B, L, nh, hd, s); on the CPU (and under
    ``reference``) it takes the plain version, whichever the contract."""
    x, dt, Bm, Cm, A = (_to_torch(a) for a in _scan_inputs(2, 12, 3, 16, 8, "float32", seed=3))
    dispatch.reset_counters()
    with dispatch.use_dispatch(backend="auto"):
        got = dispatch.ssd_scan(x, dt, Bm, Cm, A, chunk=4, round_xbar=True)
    with dispatch.use_dispatch(backend="reference"):
        dispatch.ssd_scan(x, dt, Bm, Cm, A, chunk=4, round_xbar=False)
    assert dispatch.counters() == {("ssd_scan", "reference", (2, 12, 3, 16, 8)): 2}
    want = tref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=4, round_xbar=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="operands on"):
        ssd_scan(x, dt, Bm, Cm, A.to("meta"))


# --------------------------------------------------------------------------- #
# the Mamba2 block
# --------------------------------------------------------------------------- #
def _cfgs(arch, dtype, **kw):
    jcfg = dataclasses.replace(ARCHS[arch].REDUCED, dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_arch(arch, reduced=True), dtype=dtype, **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv_matches_reference(dtype):
    rng = np.random.default_rng(4)
    jd = DTYPES[dtype][0]
    x = jnp.asarray(rng.standard_normal((2, 7, 12)), jnp.float32).astype(jd)
    w = jnp.asarray(rng.standard_normal((4, 12)) / 2, jnp.float32).astype(jd)
    tail = jnp.asarray(rng.standard_normal((2, 3, 12)), jnp.float32).astype(jd)
    for t in (None, tail):
        want = jssm._causal_depthwise_conv(x, w, t)
        got = tssm._causal_depthwise_conv(_to_torch(x, dtype), _to_torch(w, dtype),
                                          None if t is None else _to_torch(t, dtype))
        assert got.dtype == DTYPES[dtype][1]
        _model_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [13, 2])
def test_mamba2_forward_and_decode_match_reference(L, dtype):
    """The block's prefill output and decode cache (conv tails zero-padded
    where L < width - 1, which the reference's slice cannot take), then
    two decode steps, against the JAX block on the same params."""
    jcfg, tcfg = _cfgs("mamba2-130m", dtype)
    jp = jssm.mamba2_init(jax.random.PRNGKey(5), jcfg, DTYPES[dtype][0])
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    u = jnp.asarray(np.random.default_rng(6).standard_normal((2, L, jcfg.d_model)), jnp.float32)
    u = u.astype(DTYPES[dtype][0])
    tu = _to_torch(u, dtype)
    got, gc = tssm.mamba2_forward(tp, tu, tcfg, return_cache=True)
    want, wc = jssm.mamba2_forward(jp, u, jcfg, return_cache=True) if L >= jcfg.ssm_conv_width - 1 else (
        jssm.mamba2_forward(jp, u, jcfg), None)
    if wc is None:
        # The reference cannot slice a tail from fewer than width - 1 rows.
        # Zero rows in front change nothing (no bias: their projections and
        # x̄ are 0, and a zero state decays to 0), so its cache of the
        # zero-padded input is the cache this input must leave.
        _, wc = jssm.mamba2_forward(jp, jnp.concatenate([jnp.zeros_like(u), u], axis=1), jcfg, return_cache=True)
    _model_close(got, want, dtype)
    for k in ("conv_x", "conv_B", "conv_C", "state"):
        assert gc[k].dtype == (torch.float32 if k == "state" else DTYPES[dtype][1])
        _model_close(gc[k], wc[k], dtype)
    for step in range(2):
        v = jnp.asarray(np.random.default_rng(7 + step).standard_normal((2, 1, jcfg.d_model)), jnp.float32)
        v = v.astype(DTYPES[dtype][0])
        want, wc = jssm.mamba2_decode(jp, v, wc, jcfg)
        got, gc2 = tssm.mamba2_decode(tp, _to_torch(v, dtype), gc, tcfg)
        assert gc2 is gc  # updated in place
        _model_close(got, want, dtype)
        for k in ("conv_x", "state"):
            _model_close(gc[k], wc[k], dtype)


def test_mamba2_init_tree_matches_reference():
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "bfloat16")
        jflat, _ = jax.tree_util.tree_flatten_with_path(jssm.mamba2_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
        want = {"/".join(p.key for p in path): (tuple(a.shape), str(a.dtype)) for path, a in jflat}
        tp = tssm.mamba2_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
        got = {path: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for path, t in compress._leaves(tp)}
        assert got == want
        np.testing.assert_allclose(tensor_to_numpy(tp["A_log"]), np.asarray(jflat[0][1].astype(jnp.float32)))


# --------------------------------------------------------------------------- #
# compression of the mamba leaves and the shared block
# --------------------------------------------------------------------------- #
def _jax_omega_fn(jparams, key):
    """The Omegas the reference's compress_tree draws, keyed by (path, flat
    index): one key per leaf, split over every layer of a stacked leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = ["/".join(str(getattr(p, "key", p)) for p in path) for path, _ in flat]
    counts = {n: int(np.prod(leaf.shape[:-2])) for n, (_, leaf) in zip(names, flat)}
    keys = dict(zip(names, jax.random.split(key, len(names))))

    def omega_fn(name, layer, shape):
        k = keys[name] if layer is None else jax.random.split(keys[name], counts[name])[layer]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))

    return omega_fn


@pytest.fixture(scope="module")
def dense_f32():
    """Reduced mamba2-130m and zamba2-1.2b, fp32, spectralized (the paper's regime)."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch, "float32")
        out[arch] = jspectral.spectralize_params(j_build_model(jcfg).init(jax.random.PRNGKey(0)),
                                                 jax.random.PRNGKey(9))
    return out


POLICY = dict(alpha=0.3, q=2, min_dim=8)  # min_dim 8 reaches w_dt (64 x 8) at the reduced widths


@pytest.mark.parametrize("arch", list(ARCHS))
def test_compress_tree_matches_reference_on_mamba_leaves(dense_f32, arch):
    """The port's decisions equal the reference's: the conv kernels, dt_bias,
    A_log, D_param and the norms stay dense; w_z, w_x, w_B, w_C, out_proj
    and w_dt are compressed (the ``dt_`` exclusion matches a path segment
    that STARTS with dt_, which w_dt does not); the hybrid's unstacked
    shared block crosses the bridge and compresses as 2-D leaves."""
    key = jax.random.PRNGKey(1)
    jcp, _, jrep = jcompress.compress_tree(dense_f32[arch], jcompress.CompressionPolicy(**POLICY), key)
    tparams = params_from_numpy(jax.device_get(dense_f32[arch]), device="cpu")
    tcp, trep = compress.compress_tree(tparams, compress.CompressionPolicy(**POLICY),
                                       omega_fn=_jax_omega_fn(dense_f32[arch], key))
    assert (trep.params_before, trep.params_after) == (jrep.params_before, jrep.params_after)
    decisions = [(l.path, l.rank, l.compressed) for l in trep.layers]
    assert decisions == [(l.path, l.rank, l.compressed) for l in jrep.layers]
    by_path = {p: c for p, _, c in decisions}
    for name in ("w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj"):
        assert by_path[f"layers/mamba/{name}"], name
    for name in ("conv_x", "conv_B", "conv_C"):
        assert not by_path[f"layers/mamba/{name}"], name
    assert not by_path["embed"]
    if arch == "zamba2-1.2b":
        assert by_path["shared_attn/attn/wq"] and by_path["shared_attn/mlp/w_gate"] and by_path["lm_head"]
    for name in ("w_dt", "w_x"):
        t, j = tcp["layers"]["mamba"][name], jcp["layers"]["mamba"][name]
        want = np.asarray(jnp.matmul(j["a"], j["b"]))
        np.testing.assert_allclose(torch.matmul(t["a"], t["b"]).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------------------- #
# the reduced models
# --------------------------------------------------------------------------- #
B, S, GEN = 2, 12, 6


@pytest.fixture(scope="module")
def params_by_arch(dense_f32):
    """Per arch and dtype: dense (spectralized) and RSI-compressed from them
    with the reference's Omegas; bf16 trees are the fp32 ones cast."""
    out = {}
    for arch, dense in dense_f32.items():
        comp, _, _ = jcompress.compress_tree(dense, jcompress.CompressionPolicy(**POLICY), jax.random.PRNGKey(1))
        f32 = {"dense": dense, "compressed": comp}
        out[arch] = {"float32": f32, "bfloat16": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), f32)}
    return out


def _models(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    return j_build_model(jcfg), build_model(tcfg, device="cpu")


def _tokens(vocab, shape, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "compressed"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_prefill_and_decode_match_reference(params_by_arch, arch, kind, dtype):
    """Logits, prefill with ``last_index`` (the cache of every leaf), then a
    flat decode step and the same step through a paged cache.

    In bf16 the reference runs op by op (``jax.disable_jit``): jitted, XLA
    fuses each block's bf16 elementwise ops and skips roundings that the
    op-by-op run makes, which moves the reference's own bf16 logits by 2-3%
    of their largest value (up to 8% of a row's) on these models.  The port
    rounds where the op-by-op reference rounds, so bf16 is held to one bf16
    ulp (2^-8) of the largest value: what is left is fp32 summation order
    inside the matmuls."""
    jm, tm = _models(arch, dtype)
    jp = params_by_arch[arch][dtype][kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert lowrank.is_lowrank(tp["layers"]["mamba"]["w_x"]) == (kind == "compressed")
    close = _model_close if dtype == "float32" else (lambda got, want, _: _close_rel(got, want, 2.0**-8))
    jb, tb = _tokens(tm.cfg.vocab, (B, S), 0)
    last = np.array([S - 1, S - 4], np.int32)
    max_len = 20  # whole pages of 4, so the paged step reads the flat step's cache length
    with jax.disable_jit(dtype == "bfloat16"):
        want, _ = jm.forward(jp, jb)
        want_l, want_c = jm.prefill(jp, jb, max_len, last_index=jnp.asarray(last))
        nxt = np.array(jnp.argmax(want_l, axis=-1))[:, None]
        want_d, _ = jm.decode_step(jp, want_c, jnp.asarray(nxt, jnp.int32), S)
    got, aux = tm.forward(tp, tb)
    assert got.dtype == torch.float32 and aux == 0.0
    close(got, want, dtype)

    got_l, got_c = tm.prefill(tp, tb, max_len, last_index=torch.from_numpy(last))
    close(got_l, want_l, dtype)
    assert set(got_c) == set(want_c)
    for sub in want_c:
        for name in want_c[sub]:
            assert tuple(got_c[sub][name].shape) == want_c[sub][name].shape
            close(got_c[sub][name], want_c[sub][name], dtype)

    paged, mask = tm.init_cache_paged(B, max_len, 4, 10)
    assert all(not m for m in mask["layers"].values())
    assert ("shared_attn" in mask) == (arch == "zamba2-1.2b")
    assert all(mask.get("shared_attn", {}).values())
    _scatter_into_pages(paged, mask, got_c, page=4)
    got_d, _ = tm.decode_step(tp, got_c, torch.from_numpy(nxt).long(), S)
    close(got_d, want_d, dtype)
    got_p, _ = tm.decode_step(tp, paged, torch.from_numpy(nxt).long(), S)
    assert torch.equal(got_p, got_d)


def _scatter_into_pages(paged, mask, flat, *, page):
    """Copy a flat prefill cache into a paged one: slot b's positions on
    pages 2b, 2b + 1, ... (a block table the test writes), the slot leaves
    as they are."""
    bt = paged["block_table"]
    n_tbl = bt.shape[1]
    bt.copy_(torch.arange(bt.shape[0] * n_tbl, dtype=torch.int32).reshape(bt.shape))
    for sub, leaves in mask.items():
        for name, is_paged in leaves.items():
            src = flat[sub][name]
            if not is_paged:
                paged[sub][name].copy_(src)
                continue
            L, Bsz, Smax = src.shape[:3]
            pad = src.new_zeros((L, Bsz, n_tbl * page) + tuple(src.shape[3:]))
            pad[:, :, :Smax] = src
            rows = pad.reshape((L, Bsz * n_tbl, page) + tuple(src.shape[3:]))
            paged[sub][name][:, bt.reshape(-1).long()] = rows


@pytest.mark.parametrize("kind", ["dense", "compressed"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_generate_matches_reference_fp32(params_by_arch, arch, kind):
    jm, tm = _models(arch, "float32")
    jp = params_by_arch[arch]["float32"][kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jb, tb = _tokens(tm.cfg.vocab, (B, S), 1)
    want = np.asarray(j_greedy(jm, jp, jb, steps=GEN, max_len=S + GEN))
    got = greedy_generate(tm, tp, tb, steps=GEN, max_len=S + GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_count_arch_and_hybrid_schedule():
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    for arch, mod in ARCHS.items():
        assert analytic_param_count(get_arch(arch)) == j_analytic_param_count(mod.CONFIG)
        assert analytic_param_count(get_arch(arch, reduced=True)) == j_analytic_param_count(mod.REDUCED)
        for field in ("family", "n_layers", "d_model", "vocab", "ssm_state", "ssm_expand", "ssm_head_dim",
                      "ssm_conv_width", "ssm_chunk", "attn_every", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                      "rope_theta", "tie_embeddings", "d_inner", "n_ssm_heads"):
            for reduced in (False, True):
                want = getattr(mod.REDUCED if reduced else mod.CONFIG, field)
                assert getattr(get_arch(arch, reduced=reduced), field) == want, (arch, field)
    full = get_arch("zamba2-1.2b")
    assert tlm._hybrid_segments(full) == jlm._hybrid_segments(j_zamba2.CONFIG) == [(6, True)] * 6 + [(2, False)]
    assert tlm._n_shared_apps(full) == 6
    assert build_model(full, device="cpu").prefill_chunk is None


# --------------------------------------------------------------------------- #
# the serving engine
# --------------------------------------------------------------------------- #
MAX_LEN = 20


@pytest.fixture(scope="module")
def engine_models(params_by_arch):
    out = {}
    for arch in ARCHS:
        jm, tm = _models(arch, "float32")
        jp = params_by_arch[arch]["float32"]["compressed"]
        out[arch] = (jm, jp, tm, params_from_numpy(jax.device_get(jp), device="cpu"))
    return out


def _drive(eng, make_request, specs, *, stagger: int = 0):
    """Submit ``specs`` [(prompt, max_new)]: all at once, or the last one
    ``stagger`` engine steps after the others."""
    head = specs if not stagger else specs[:-1]
    reqs = [eng.submit(make_request(p, n)) for p, n in head]
    for _ in range(stagger):
        eng.step()
    if stagger:
        reqs.append(eng.submit(make_request(*specs[-1])))
    while eng.has_work:
        eng.step()
    return [list(r.tokens) for r in reqs]


def _specs(vocab, lens, gens, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(n,)).astype(np.int32), g) for n, g in zip(lens, gens)]


@pytest.mark.parametrize("mode", [{}, dict(page_size=4)], ids=["flat", "paged"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_matches_reference_engine(engine_models, arch, mode):
    """Compressed reduced models in fp32, two slots, decode block 4: requests
    0 and 1 (one prompt length) are admitted at once as ONE unpadded
    micro-batch; request 0 stops after 2 tokens and its slot stays frozen
    (its recurrent rows drift) until request 2 (another length) is admitted
    into it; request 3 arrives two steps later, staggered.  The port's
    engine emits the JAX engine's greedy tokens, and each request the
    tokens greedy generation of its prompt alone gives."""
    jm, jp, tm, tp = engine_models[arch]
    specs = _specs(tm.cfg.vocab, (6, 6, 5, 7), (2, 9, 5, 4))
    want = _drive(JEngine(jm, jp, n_slots=2, max_len=MAX_LEN, decode_block=4, **mode),
                  lambda p, n: JRequest(prompt=p, max_new_tokens=n), specs, stagger=2)
    eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, decode_block=4, **mode)
    got = _drive(eng, lambda p, n: Request(prompt=p, max_new_tokens=n), specs, stagger=2)
    assert got == want
    for (p, n), toks in zip(specs, got):
        alone = greedy_generate(tm, tp, {"tokens": torch.as_tensor(p[None]).long()}, steps=n, max_len=MAX_LEN)
        assert toks == alone[0].tolist()
    # every prefill micro-batch holds one prompt length, never padded
    assert eng.prefill_batches[0] == (2, 6, (6, 6))
    assert all(P == lens[0] and set(lens) == {lens[0]} for _, P, lens in eng.prefill_batches)


def test_engine_mamba2_reserves_zero_pages(engine_models):
    """No mamba2 cache leaf is paged: a paged engine reserves zero pages,
    and its resident bytes are the whole cache."""
    _, _, tm, tp = engine_models["mamba2-130m"]
    eng = Engine(tm, tp, n_slots=2, max_len=MAX_LEN, page_size=4, kv_pages=3)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in _specs(tm.cfg.vocab, (9, 4), (8, 8))]
    assert eng._page_need(reqs[0]) == 0
    while eng.has_work:
        eng.step()
    assert all(r.status == "ok" and len(r.tokens) == 8 for r in reqs)
    assert eng.peak_pages_in_use == 0 and eng.kv_bytes_peak == eng.kv_bytes_capacity
    zeng = Engine(*engine_models["zamba2-1.2b"][2:], n_slots=2, max_len=MAX_LEN, page_size=4)
    req = zeng.submit(Request(prompt=np.arange(9), max_new_tokens=3))
    assert zeng._page_need(req) == 3 and zeng._bytes_per_page > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_bf16_paged_equals_flat_and_block_size_invariant(arch):
    """bf16 (the served dtype), compressed in the port itself: paged tokens
    equal the flat engine's bit for bit, and decode blocks of 1, 3 and 8
    emit the same tokens."""
    _, tcfg = _cfgs(arch, "bfloat16")
    tm = build_model(tcfg, device="cpu")
    tp, _ = compress.compress_tree(tm.init(torch.Generator().manual_seed(3)),
                                   compress.CompressionPolicy(alpha=0.3, q=2, min_dim=16),
                                   generator=torch.Generator().manual_seed(4))
    specs = _specs(tcfg.vocab, (9, 3, 9, 12), (7, 7, 5, 6), seed=5)
    out = {}
    for name, kw in {"flat": dict(decode_block=8), "paged": dict(page_size=4, decode_block=8),
                     "block1": dict(decode_block=1), "block3": dict(page_size=4, decode_block=3)}.items():
        eng = Engine(tm, tp, n_slots=3, max_len=24, **kw)
        out[name] = _drive(eng, lambda p, n: Request(prompt=p, max_new_tokens=n), specs, stagger=1)
        assert [len(t) for t in out[name]] == [n for _, n in specs]
    assert out["paged"] == out["flat"] == out["block1"] == out["block3"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_launchers_on_reduced_ssm_archs(capsys, arch):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--reduced", "--engine", "static", "--batch", "2", "--prompt-len", "6",
                      "--gen", "3", "--compress-alpha", "0.3", "--q", "2", "--device", "cpu"])
    assert tuple(out.shape) == (2, 3)
    text = capsys.readouterr().out
    assert "[static]" in text and "ssd_scan" in text and "lowrank_matmul" in text
    done = serve.main(["--arch", arch, "--reduced", "--compress-alpha", "0.3", "--device", "cpu", "--gen", "4",
                       "--page-size", "4", "--prefill-chunk", "2"])
    text = capsys.readouterr().out
    assert all(r.status == "ok" and len(r.tokens) == 4 for r in done)
    assert "[continuous]" in text and "[paged]" in text and "prefill_chunks=0" in text
    assert ("peak_pages=0" in text) == (arch == "mamba2-130m")
    assert ("paged_decode_attention" in text) == (arch == "zamba2-1.2b")
