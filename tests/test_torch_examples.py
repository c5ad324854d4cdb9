"""The port's ``kernels/ops.py`` and its twins of the serving and training examples.

``repro_torch.kernels.ops``: each function against ``repro.kernels.ops`` on
the same seeded numpy inputs.  The JAX side runs as its own tests run it on
the CPU: backend ``auto``, which there takes the XLA paths, and for the SSD
scan the Pallas kernel in interpret mode (``use_dispatch(backend="pallas")``),
whose contract the port's ``ops.ssd_scan`` keeps: raw x, x̄ = x * dt formed in
fp32 and never rounded.  On the CPU the port's functions run the kernels'
plain versions.  Tolerances: fp32 2e-5 (the two frameworks sum in different
orders), bf16 3e-2 (one bf16 ulp is 2^-8 relative, and both sides round the
same intermediates but may land on neighbouring values); the SSD scan's
state 2e-5 of its largest value in both dtypes (it stays fp32).

The examples: ``experiments.compress_and_serve`` and
``experiments.continuous_serving`` through ``main([..., "--device", "cpu"])``
at small sizes, their printed lines in the reference scripts' formats, and
``continuous_serving``'s own greedy-parity assertion, plain and with
``--sessions``.  The training examples, ``experiments.train_lowrank_lm`` and
``experiments.rsi_plus_lora``, cut to a few steps, with their own
assertions (the final loss under 7.0; the adapters learn).
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.runtime.dispatch import use_dispatch as j_use_dispatch  # noqa: E402
from repro_torch.experiments import compress_and_serve, continuous_serving, rsi_plus_lora, train_lowrank_lm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _randn(shape, seed, scale=None):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x / (shape[-1] ** 0.25 if scale is None else scale)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)), **TOL[dtype])


def _counted(op):
    """Calls of dispatch op ``op`` recorded so far, any path."""
    return sum(n for (o, _path), n in dispatch.counters_by_path().items() if o == op)


# --------------------------------------------------------------------------- #
# kernels/ops.py against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_sketch_matmul(dtype):
    ja, ta = _pair(_randn((48, 96), 0), dtype)
    jb, tb = _pair(_randn((96, 40), 1), dtype)
    before = _counted("sketch_matmul")
    got = ops.sketch_matmul(ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (48, 40)
    assert _counted("sketch_matmul") == before + 1
    _close(got, jops.sketch_matmul(ja, jb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_shape,a_shape,b_shape", [
    ((2, 3, 64), (64, 8), (8, 48)),  # leading batch dims on x, 2-D factors
    ((3, 5, 64), (3, 64, 8), (3, 8, 48)),  # stacked (L, ...) factors: the batched kernel's call
], ids=["batch_dims", "stacked"])
def test_ops_lowrank_matmul(x_shape, a_shape, b_shape, dtype):
    jx, tx = _pair(_randn(x_shape, 2), dtype)
    jA, tA = _pair(_randn(a_shape, 3), dtype)
    jB, tB = _pair(_randn(b_shape, 4), dtype)
    got = ops.lowrank_matmul(tx, tA, tB)
    assert got.shape == x_shape[:-1] + (b_shape[-1],) and got.dtype == DTYPES[dtype][1]
    _close(got, jops.lowrank_matmul(jx, jA, jB), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ssd_scan_raw_xbar_matches_pallas_kernel(dtype):
    """The TPU kernel's contract at the keyword default chunk (128, so one
    chunk of 32 here): x̄ = x * dt in fp32, never rounded.  In bf16 the
    model's rounded x̄ is another function; the ops twin is the kernel's."""
    Bsz, L, nh, hd, s = 2, 32, 3, 8, 16
    rng = np.random.default_rng(5)
    jd, td = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((Bsz, L, nh, hd)), jnp.float32).astype(jd)
    dt = jax.nn.softplus(jnp.asarray(rng.standard_normal((Bsz, L, nh)), jnp.float32))
    Bm = jnp.asarray(rng.standard_normal((Bsz, L, s)) / s**0.5, jnp.float32).astype(jd)
    Cm = jnp.asarray(rng.standard_normal((Bsz, L, s)) / s**0.5, jnp.float32).astype(jd)
    A = -jnp.exp(jnp.log(jnp.linspace(1.0, 16.0, nh)))
    with j_use_dispatch(backend="pallas"):  # interpret mode on the CPU
        want_y, want_s = jops.ssd_scan(x, dt, Bm, Cm, A)

    def t(a, d):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(d)

    got_y, got_s = ops.ssd_scan(t(x, td), t(dt, torch.float32), t(Bm, td), t(Cm, td), t(A, torch.float32))
    assert got_y.dtype == td and got_s.dtype == torch.float32
    want_y = np.asarray(want_y.astype(jnp.float32))
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(got_y.float().numpy(), want_y, rtol=0, atol=TOL[dtype]["atol"] * np.abs(want_y).max())
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=2e-5 * np.abs(want_s).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention(causal, dtype):
    """At G = 1: the reference's op takes as many K/V heads as query heads
    (the port's also groups them, as its other tests check)."""
    jq, tq = _pair(_randn((2, 16, 4, 16), 6), dtype)
    jk, tk = _pair(_randn((2, 16, 4, 16), 7), dtype)
    jv, tv = _pair(_randn((2, 16, 4, 16), 8), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (2, 16, 4, 16)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_decode_attention(dtype):
    jq, tq = _pair(_randn((3, 1, 4, 16), 9), dtype)
    jk, tk = _pair(_randn((3, 24, 2, 16), 10), dtype)
    jv, tv = _pair(_randn((3, 24, 2, 16), 11), dtype)
    valid = np.zeros((3, 24), bool)
    valid[0, :24] = True
    valid[1, :7] = True  # a ragged row; row 2 fully masked gives zeros
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    assert float(got[2].float().abs().max()) == 0.0
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(valid)), dtype)


# --------------------------------------------------------------------------- #
# the serving examples
# --------------------------------------------------------------------------- #
def test_compress_and_serve_twin(capsys):
    out = compress_and_serve.main(["--batch", "2", "--prompt-len", "8", "--gen", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"dense: [\d.]+M params, [\d.]+ tok/s", lines[0])
    for line, q in zip(lines[1:], (1, 4)):
        assert re.fullmatch(rf"alpha=0\.3 q={q}: ratio=[\d.]+, [\d.]+ tok/s, token agreement vs dense = [\d.]+%",
                            line), line
    assert len(lines) == 3
    assert out["dense_tokens"].shape == (2, 6)
    for q in (1, 4):
        run = out["runs"][q]
        assert 0.0 < run["ratio"] < 1.0 and 0.0 <= run["agreement"] <= 1.0
        assert run["tokens"].shape == (2, 6)


@pytest.mark.parametrize("argv", [[], ["--sessions"]], ids=["plain", "sessions"])
def test_continuous_serving_twin(argv, capsys):
    """The example's own parity assertion runs inside ``main``: the greedy
    request equals ``greedy_generate`` on its prompt alone."""
    out = continuous_serving.main(["--n-slots", "2", "--n-requests", "3", "--device", "cpu"] + argv)
    text = capsys.readouterr().out
    n = 3 + (1 if argv else 0)  # --sessions implies --paged, which adds the chunk-prefilled long prompt
    assert re.search(rf"^\[engine\] {n} requests \(2 slots\), \d+ tokens in [\d.]+s", text, re.M)
    assert f"[parity] request {out['parity_uid']} matches greedy_generate exactly: OK" in text
    assert len(re.findall(r"^  req \d+: prompt", text, re.M)) == n
    assert all(r.status == "ok" and len(r.tokens) == r.max_new_tokens for r in out["done"])
    if argv:
        assert re.search(r"^\[paged\] \d+ pages of 8 tokens", text, re.M)
        assert re.search(r"^\[shared\] \d+ prefix pages mapped read-only", text, re.M)
        assert len(out["turns"]) == 3 and len(re.findall(r"^  turn \d: prompt", text, re.M)) == 3
        # each follow-up turn extends the previous prompt and reply: it matches past the system prompt
        assert all(t.prefill_skipped >= 16 for t in out["turns"][1:])
    else:
        assert "[paged]" not in text and out["turns"] == []


# --------------------------------------------------------------------------- #
# the training examples
# --------------------------------------------------------------------------- #
def test_train_lowrank_lm_twin(capsys):
    """Reduced mamba2-130m compressed at alpha 0.5 and trained 10 steps through
    the launcher; the example's own assertion (final loss under 7.0) runs
    inside ``main``, and the factor leaves moved."""
    state, metrics = train_lowrank_lm.main(["--steps", "10", "--device", "cpu"])
    text = capsys.readouterr().out
    assert re.search(r"^\[compress\] compressed \d+/\d+ tensors", text, re.M)
    assert re.search(r"^step    10  loss [\d.]+  aux 0\.0000  gnorm [\d.]+", text, re.M)
    assert "low-rank training OK" in text and float(metrics["loss"]) < 7.0 and int(state.step) == 10
    factored = [v for v in state.params["layers"]["mamba"].values() if isinstance(v, dict) and "a" in v]
    assert factored and all(torch.isfinite(f["a"]).all() for f in factored)


def test_rsi_plus_lora_twin(capsys):
    """Adapters on the frozen RSI factors of reduced llama3.2-1b: the example's
    own assertion (the adapters learn) runs inside ``main``; only the
    adapters moved, and lora_merge stacks the ranks."""
    cfg_params, losses = rsi_plus_lora.main(["--steps", "20", "--device", "cpu"])
    text = capsys.readouterr().out
    assert re.search(r"^backbone: compressed \d+/\d+ tensors", text, re.M)
    assert re.search(r"^trainable adapter params: [\d,]+ / [\d,]+ \([\d.]+%\)$", text, re.M)
    assert "RSI + LoRA OK" in text and len(losses) == 20
    wq = cfg_params["layers"]["attn"]["wq"]
    assert float(wq["lora_b"].abs().max()) > 0  # zero at first: it learned
    merged = rsi_plus_lora.lora_merge(cfg_params)["layers"]["attn"]["wq"]
    assert set(merged) == {"a", "b"} and merged["a"].shape[-1] == wq["a"].shape[-1] + rsi_plus_lora.LORA_RANK
