"""The port's slice end to end against the reference: reduced llama3.2-1b
(2 layers, d 64), dense and RSI-compressed, reference params bridged in.

fp32 config: logits allclose at rtol/atol 1e-4 (summation order and
transcendental implementations differ between the frameworks; 1e-4 leaves
room for two layers of that) and greedy tokens equal.  bf16 (the served
dtype): logits within 5e-2 of the reference's scale — both sides round
the same activations to bf16, but a value near a rounding boundary can
land one ulp (2^-8 relative) apart and that difference propagates.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.llama3_2_1b import CONFIG as J_FULL  # noqa: E402
from repro.configs.llama3_2_1b import REDUCED as J_REDUCED  # noqa: E402
from repro.core import CompressionPolicy as JPolicy  # noqa: E402
from repro.core import compress_tree as j_compress_tree  # noqa: E402
from repro.core import spectralize_params as j_spectralize  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.model import analytic_param_count as j_analytic_param_count  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.train.serve_step import greedy_generate as j_greedy  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import lowrank  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models.model import LMModule, analytic_param_count, build_model  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

B, S, GEN = 2, 12, 6
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _models(dtype):
    jcfg = dataclasses.replace(J_REDUCED, dtype=dtype)
    tcfg = dataclasses.replace(get_arch("llama3.2-1b", reduced=True), dtype=dtype)
    return j_build_model(jcfg), build_model(tcfg, device="cpu")


@pytest.fixture(scope="module")
def params_by_dtype():
    """Reference params per dtype: dense (spectralized, the paper's regime)
    and RSI-compressed from them; the bf16 trees are the fp32 ones cast."""
    jm, _ = _models("float32")
    dense = j_spectralize(jm.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(9))
    comp, _, _ = j_compress_tree(dense, JPolicy(alpha=0.3, q=2, min_dim=32), jax.random.PRNGKey(1))
    f32 = {"dense": dense, "compressed": comp}
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), f32)
    return {"float32": f32, "bfloat16": bf16}


def _batch():
    toks = JSyntheticLM(J_REDUCED, batch=B, seq=S, kind="serve", seed=0).at_step(0)["tokens"]
    np.testing.assert_array_equal(toks, SyntheticLM(J_REDUCED, batch=B, seq=S, kind="serve").at_step(0)["tokens"])
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks, dtype=torch.int64)}


def _tol(dtype, want):
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=0, atol=5e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_and_prefill_match_reference(params_by_dtype, kind, dtype):
    jm, tm = _models(dtype)
    jp = params_by_dtype[dtype][kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    if kind == "compressed":
        assert lowrank.is_lowrank(tp["layers"]["mlp"]["w_gate"])
    jb, tb = _batch()
    want, _ = jm.forward(jp, jb)
    got, _ = tm.forward(tp, tb)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(tensor_to_numpy(got), want, **_tol(dtype, want))

    want_l, want_c = jm.prefill(jp, jb, S + GEN)
    got_l, got_c = tm.prefill(tp, tb, S + GEN)
    want_l = np.asarray(want_l)
    np.testing.assert_allclose(tensor_to_numpy(got_l), want_l, **_tol(dtype, want_l))
    for name in ("k", "v"):
        wc = np.asarray(want_c["layers"][name].astype(jnp.float32))
        assert tuple(got_c["layers"][name].shape) == wc.shape
        np.testing.assert_allclose(tensor_to_numpy(got_c["layers"][name]), wc, **_tol(dtype, wc))


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_greedy_generate_matches_reference_fp32(params_by_dtype, kind):
    jm, tm = _models("float32")
    jp = params_by_dtype["float32"][kind]
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jb, tb = _batch()
    want = np.asarray(j_greedy(jm, jp, jb, steps=GEN, max_len=S + GEN))
    got = greedy_generate(tm, tp, tb, steps=GEN, max_len=S + GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_step_updates_cache_in_place(params_by_dtype):
    _, tm = _models("float32")
    tp = params_from_numpy(jax.device_get(params_by_dtype["float32"]["dense"]), device="cpu")
    _, tb = _batch()
    _, cache = tm.prefill(tp, tb, S + 2)
    k_before = cache["layers"]["k"]
    ptr = k_before.data_ptr()
    _, cache2 = tm.decode_step(tp, cache, torch.zeros((B, 1), dtype=torch.int64), S)
    assert cache2["layers"]["k"].data_ptr() == ptr
    assert torch.any(cache2["layers"]["k"][:, :, S] != 0)


def test_decode_step_takes_scalar_or_vector_positions(params_by_dtype):
    """A scalar position and the same position as a (B,) vector give the
    same logits and the same cache."""
    _, tm = _models("float32")
    tp = params_from_numpy(jax.device_get(params_by_dtype["float32"]["dense"]), device="cpu")
    _, tb = _batch()
    tok = torch.zeros((B, 1), dtype=torch.int64)
    outs = []
    for pos in (S, torch.full((B,), S, dtype=torch.int64)):
        _, cache = tm.prefill(tp, tb, S + 2)
        outs.append(tm.decode_step(tp, cache, tok, pos))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1]["layers"]["k"], outs[1][1]["layers"]["k"], rtol=0, atol=0)


def test_lm_module_owns_the_params(params_by_dtype):
    _, tm = _models("float32")
    tp = params_from_numpy(jax.device_get(params_by_dtype["float32"]["compressed"]), device="cpu")
    mod = LMModule(tm, tp)
    assert "layers__mlp__w_gate__a" in dict(mod.named_buffers())
    _, tb = _batch()
    want, _ = tm.forward(tp, tb)
    torch.testing.assert_close(mod(tb["tokens"]), want, rtol=0, atol=0)
    assert analytic_param_count(tm.cfg) == j_analytic_param_count(J_REDUCED)
    assert get_arch("llama3.2-1b").param_count() == j_analytic_param_count(J_FULL)


def test_bridge_keeps_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)), jnp.bfloat16)
    t = params_from_numpy({"w": jax.device_get(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))


def test_build_model_runs_on_the_card_by_default():
    """Without device="cpu", entry points run on the card — and raise where
    there is none, never falling back to the CPU quietly."""
    cfg = get_arch("llama3.2-1b", reduced=True)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


def test_unported_archs_and_families_raise():
    # h2o-danube's sliding-window attention (the SWA ring) is not ported
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_arch("h2o-danube-1.8b")
    cfg = dataclasses.replace(get_arch("llama3.2-1b", reduced=True), family="vlm")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(cfg, device="cpu")
    # moe is ported with GQA attention; MLA attention (deepseek-v2) is not
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b", reduced=True), kv_lora_rank=8)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(cfg, device="cpu")


def test_port_imports_no_jax_and_no_reference():
    """Importing every repro_torch module loads no jax* and no repro.* module."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'repro.'))"
        " or n == 'repro')\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_serve_launcher_static_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "llama3.2-1b", "--reduced", "--engine", "static", "--batch", "2", "--prompt-len",
                      "6", "--gen", "3", "--compress-alpha", "0.3", "--q", "2", "--device", "cpu"])
    assert tuple(out.shape) == (2, 3)
    text = capsys.readouterr().out
    assert "[compress]" in text and "lowrank_matmul" in text and "decode_attention" in text
