"""The port's multi-device layer against the reference's, on CPU ranks.

One module fixture runs the reference once in a child process on 8 fake
XLA devices (the device count must be set before jax starts, as in
``tests/test_distributed.py``), at that file's sizes: distributed RSI on a
(2, 4) mesh, expert-parallel MoE (reduced phi3.5-moe, 8 experts, nothing
dropped), the GPipe pipeline over a (4,) "pod" mesh and one PowerSGD
all-reduce over 8 data devices; it writes their inputs and outputs to an
``.npz``.  A second fixture spawns the port's 8 gloo ranks once on those
inputs (``runtime/distributed.py::spawn``, a file store, one intra-op
thread a rank; the rank program is ``tests/torch_ranks.py``).

Tolerances (fp32 throughout; the frameworks sum in other orders):
* distributed RSI: the reconstruction within 1e-4 (relative Frobenius) of
  the reference's, as the reference holds its own to the single device;
* EP MoE: within 2e-4 of the reference's EP output and of its single-device
  ``_moe_local``; the aux loss within 1e-5 of the reference's EP aux (the
  same per-shard estimator);
* GPipe: within 1e-5 of the reference's, and bit for bit the port's own
  sequential forward over the same microbatches;
* PowerSGD, from the reference's initial Q: within twice the reference's
  own distance from a float64 evaluation of the same step (max abs).  One
  step orthonormalizes P = mean(G Q) by CholeskyQR, whose error grows as
  cond(P)^2 eps; at the reference test's data cond(P) = 171, and the
  reference's fp32 result lies ~9e-3 from the float64 one, so no two fp32
  orders of summation agree to 1e-5.  The byte counts exactly equal;
* the elastic reshard (2, 4) -> (8, 1): bit for bit;
* the TSQR redo: on the energy rule's sharp spectrum (eight singular
  values of 100, the rest 0.01: the fp32 Gram of the probe's sketch is not
  positive definite) every rank redoes X by TSQR and counts it; the top
  eight singular values within 1e-5 of the single-device port's
  (Householder) and each reconstruction within 0.02 of W in the spectral
  norm, as the single-device energy test holds it (the directions past the
  eighth are noise at 0.01 either way).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import torch_ranks  # noqa: E402
from repro_torch.core.rsi import QR_FALLBACKS, rsi  # noqa: E402
from repro_torch.runtime import distributed  # noqa: E402
from repro_torch.runtime.distributed import MeshSpec, assemble  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = MeshSpec((2, 4), ("data", "model"))

_REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch
from repro.core import spectral, synth_spectrum_matrix, vgg_like_spectrum
from repro.core.distributed_rsi import distributed_rsi
from repro.core.gradient_compression import PowerSGDConfig, comm_bytes, compress_allreduce, init_powersgd
from repro.data.synthetic import SyntheticLM
from repro.models import moe
from repro.models.model import build_model
from repro.runtime.compat import make_mesh, shard_map
from repro.sharding.rules import MeshRules, use_rules
from repro.train import optimizer as jopt, train_step as jts
from repro.train.pipeline_parallel import gpipe_apply

out = {}
def spec(a):
    s = tuple(a.sharding.spec)
    return json.dumps(s + (None,) * (a.ndim - len(s)))
def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(k.key) for k in path)] = leaf

mesh = make_mesh((2, 4), ("data", "model"))
W = jax.jit(lambda k: synth_spectrum_matrix(k, 256, 512, vgg_like_spectrum(256)))(jax.random.PRNGKey(0))
d = jax.jit(lambda w: distributed_rsi(w, 32, 3, jax.random.PRNGKey(1), mesh))(
    jax.device_put(W, NamedSharding(mesh, P("data", "model"))))
out.update(rsi_W=W, rsi_U=d.U, rsi_S=d.S, rsi_Vt=d.Vt, rsi_U_spec=spec(d.U), rsi_Vt_spec=spec(d.Vt),
           rsi_omega=jax.random.normal(jax.random.PRNGKey(1), (512, 32), dtype=jnp.float32).astype(W.dtype))
s = jnp.concatenate([jnp.full((8,), 100.0), jnp.full((248,), 0.01)])
out["tsqr_W"] = jax.jit(lambda k: spectral.synth_spectrum_matrix(k, 256, 512, s).T)(jax.random.PRNGKey(0))
out["tsqr_omega"] = jax.random.normal(jax.random.PRNGKey(2), (256, 170), dtype=jnp.float32)

cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b", reduced=True), n_experts=8, capacity_factor=8.0)
p = jax.jit(lambda k: moe.moe_init(k, cfg, jnp.float32))(jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model), jnp.float32)
local, aux_local = jax.jit(lambda p, x: moe._moe_local(p, x, cfg))(p, x)
wm = jax.random.normal(jax.random.PRNGKey(5), x.shape, jnp.float32)
def moe_loss(p, x):
    y, aux = moe.moe_forward(p, x, cfg)
    return jnp.mean(jnp.sum(y * wm, -1)) + aux
with use_rules(MeshRules(mesh)):
    ep, aux_ep = jax.jit(lambda p, x: moe.moe_forward(p, x, cfg))(p, x)
    gp, gx = jax.jit(jax.grad(moe_loss, argnums=(0, 1)))(p, x)
flat("moe_p/", p)
flat("moe_g/", gp)
out.update(moe_x=x, moe_local=local, moe_ep=ep, moe_aux_ep=aux_ep, moe_aux_local=aux_local, moe_w=wm, moe_gx=gx)

pod = make_mesh((4,), ("pod",))
ws = jax.random.normal(jax.random.PRNGKey(0), (8, 16, 16)) / 16**0.5
xp = jax.random.normal(jax.random.PRNGKey(1), (8, 16))
pipe = gpipe_apply(lambda lp, h: jnp.tanh(h @ lp["w"]), pod, n_microbatches=4)
got = jax.jit(pipe)({"w": ws}, xp)
wo = jax.random.normal(jax.random.PRNGKey(2), xp.shape)
gws, gxp = jax.jit(jax.grad(lambda p, x: jnp.sum(pipe(p, x) * wo), argnums=(0, 1)))({"w": ws}, xp)
out.update(pipe_ws=ws, pipe_x=xp, pipe_y=got, pipe_wo=wo, pipe_gws=gws["w"], pipe_gx=gxp)

dp = make_mesh((8,), ("data",))
cfg = PowerSGDConfig(rank=8, min_size=1024)
u = jax.random.normal(jax.random.PRNGKey(0), (64, 8))
v = jax.random.normal(jax.random.PRNGKey(2), (8, 96))
grads = (u @ v)[None] + 0.05 * jax.random.normal(jax.random.PRNGKey(3), (8, 64, 96))
state = init_powersgd({"w": grads[0]}, jax.random.PRNGKey(1), cfg)
f = shard_map(lambda g: compress_allreduce({"w": g[0]}, state, "data", cfg)[0]["w"][None], mesh=dp,
              in_specs=P("data"), out_specs=P("data"), check_vma=False)
out.update(psgd_grads=grads, psgd_q=state.qs["w"], psgd_y=f(grads), psgd_bytes=np.array(comm_bytes({"w": grads[0]}, cfg)))
cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b", reduced=True), dtype="float32", remat="none",
                          capacity_factor=8.0)
model, opt = build_model(cfg), jopt.sgdm(jopt.constant_schedule(%(lr)r))
p0 = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
state = jts.TrainState(params=p0, opt_state=opt.init(p0), step=jnp.zeros((), jnp.int32))
batch = SyntheticLM(cfg, batch=4, seq=16, seed=3).at_step(0)
state, m = jax.jit(jts.make_train_step(model, opt, rules=MeshRules(mesh)))(
    state, jax.tree_util.tree_map(jnp.asarray, batch))
flat("ts_p/", p0)
flat("ts_new/", state.params)
out.update(ts_tokens=batch["tokens"], ts_targets=batch["targets"], **{"ts_" + k: v for k, v in m.items()})
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    script = textwrap.dedent(_REFERENCE) % {"lr": torch_ranks.TRAIN_LR}
    r = subprocess.run([sys.executable, "-c", script, path], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    # as tensors: they cross to the ranks through shared memory (numpy arrays would be pickled
    # through each rank's start pipe in turn)
    inputs = {k: torch.from_numpy(v) for k, v in ref.items()
              if k.startswith(("rsi_W", "rsi_omega", "tsqr_", "moe_p/", "moe_x", "moe_w", "pipe_ws", "pipe_x",
                               "pipe_wo", "psgd_grads", "psgd_q", "ts_p/", "ts_tokens", "ts_targets"))}
    return distributed.spawn(torch_ranks.ranks, 8, (2, 4), ("data", "model"), "cpu", inputs, ckpt_dir)


def _whole(port, part: str, key: str, spec) -> torch.Tensor:
    return assemble([torch.from_numpy(r[part][key]) for r in port], spec, MESH)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _recon(U, S, Vt):
    return (np.asarray(U) * np.asarray(S)[None]) @ np.asarray(Vt)


def test_distributed_rsi_matches_reference(ref, port):
    U = _whole(port, "rsi", "U", ("data", None)).numpy()
    Vt = _whole(port, "rsi", "Vt", (None, "model")).numpy()
    assert _rel(_recon(U, port[0]["rsi"]["S"], Vt), _recon(ref["rsi_U"], ref["rsi_S"], ref["rsi_Vt"])) < 1e-4
    for r in port:
        assert np.array_equal(r["rsi"]["S"], port[0]["rsi"]["S"])


def test_distributed_rsi_factor_blocks_lie_on_the_reference_specs(ref, port):
    """U on ("data", None), Vt on (None, "model"): the reference's specs, and
    each rank's blocks are the ones those specs give it (replicated over the
    other axis bit for bit)."""
    assert tuple(json.loads(str(ref["rsi_U_spec"]))) == ("data", None)
    assert tuple(json.loads(str(ref["rsi_Vt_spec"]))) == (None, "model")
    for rank, r in enumerate(port):
        c = MESH.coords(rank)
        assert r["rsi"]["U"].shape == (256 // 2, 32) and r["rsi"]["Vt"].shape == (32, 512 // 4)
        assert np.array_equal(r["rsi"]["U"], port[c["data"] * 4]["rsi"]["U"])
        assert np.array_equal(r["rsi"]["Vt"], port[c["model"]]["rsi"]["Vt"])


def test_tsqr_redo_matches_single_device(ref, port):
    W = torch.from_numpy(ref["tsqr_W"])
    QR_FALLBACKS.reset()
    single = rsi(W, torch_ranks.TSQR_K, torch_ranks.TSQR_Q, omega=torch.from_numpy(ref["tsqr_omega"]))
    assert QR_FALLBACKS.count > 0  # the single device's Householder redo
    for r in port:
        assert r["tsqr"]["fallbacks"] > 0
    S = port[0]["tsqr"]["S"]
    np.testing.assert_allclose(S[:8], single.S[:8].numpy(), rtol=1e-5)
    U = _whole(port, "tsqr", "U", ("data", None)).numpy()
    Vt = _whole(port, "tsqr", "Vt", (None, "model")).numpy()
    for recon in (_recon(U, S, Vt), _recon(single.U, single.S, single.Vt)):
        assert np.isfinite(recon).all()
        assert np.linalg.norm(ref["tsqr_W"] - recon, ord=2) < 0.02


def test_moe_expert_parallel_matches_reference(ref, port):
    y = np.concatenate([port[0]["moe"]["y"], port[4]["moe"]["y"]])  # the two "data" rows of tokens
    for rank, r in enumerate(port):  # replicated over "model"
        assert np.array_equal(r["moe"]["y"], port[MESH.coords(rank)["data"] * 4]["moe"]["y"])
    np.testing.assert_allclose(y, ref["moe_ep"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y, ref["moe_local"], rtol=2e-4, atol=2e-4)
    for r in port:
        np.testing.assert_allclose(r["moe"]["aux"], float(ref["moe_aux_ep"]), rtol=1e-5)


def test_moe_expert_parallel_backward_matches_reference(ref, port):
    """Each rank's backward of its loss (the mean over its tokens of <y, w>
    plus the aux loss), averaged over the 8 ranks, is the gradient of the
    whole batch's loss: every expert and router leaf against jax.grad of the
    reference's EP layer, and each "data" row's tokens against its x grad
    (summed over the 4 "model" replicas, over 8)."""
    keys = sorted(port[0]["moe"]["grads"])
    assert keys == sorted(k[len("moe_g/"):] for k in ref if k.startswith("moe_g/"))
    for k in keys:
        g = sum(r["moe"]["grads"][k] for r in port) / len(port)
        want = ref["moe_g/" + k]
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=2e-4 * float(np.abs(want).max()), err_msg=k)
    rows = port[0]["moe"]["gx"].shape[0]
    for d in range(MESH.shape["data"]):
        gx = sum(port[d * 4 + j]["moe"]["gx"] for j in range(4)) / len(port)
        want = ref["moe_gx"][d * rows:(d + 1) * rows]
        np.testing.assert_allclose(gx, want, rtol=2e-4, atol=2e-4 * float(np.abs(ref["moe_gx"]).max()))


def test_gpipe_backward_matches_reference(ref, port):
    """Each stage's backward of <y, wo>, averaged over the 8 ranks (2 "data"
    rows of 4 stages): the stage slices against jax.grad of the reference's
    pipeline, and the input's gradient likewise."""
    S = 4
    gws = np.concatenate([sum(port[d * S + s]["pipe"]["gws"] for d in range(2)) / len(port) for s in range(S)])
    np.testing.assert_allclose(gws, ref["pipe_gws"], rtol=1e-5, atol=1e-5)
    gx = sum(r["pipe"]["gx"] for r in port) / len(port)
    np.testing.assert_allclose(gx, ref["pipe_gx"], rtol=1e-5, atol=1e-5)


def test_train_step_under_rules_matches_reference(ref, port):
    """One SGD-momentum step of make_train_step(rules=) on the (2, 4) mesh
    (reduced phi3.5-moe, its MoE layers expert-parallel, the batch's rows
    over "data"): the loss, the aux loss and the gradient norm within 1e-5
    of the reference's step under its rules, every leaf after the step
    within the single-device step test's tolerance, and every rank holding
    the same bits."""
    for r in port:
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(r["train"]["metrics"][k], float(ref["ts_" + k]), rtol=1e-5, err_msg=k)
    got = port[0]["train"]["params"]
    want = {k[len("ts_new/"):]: ref[k] for k in ref if k.startswith("ts_new/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-4, err_msg=k)
        for r in port[1:]:
            assert np.array_equal(r["train"]["params"][k], got[k]), k


def test_gpipe_matches_reference_and_sequential(ref, port):
    for r in port:
        np.testing.assert_allclose(r["pipe"]["y"], ref["pipe_y"], rtol=1e-5, atol=1e-5)
        assert np.array_equal(r["pipe"]["y"], r["pipe"]["seq"])


def _powersgd_f64(grads, q):
    """One step of the reference's algorithm in float64 (numpy)."""
    g, q = grads.astype(np.float64), q.astype(np.float64)
    p = (g @ q).mean(0)
    gram = p.T @ p
    gram = gram + 1e-12 * np.eye(gram.shape[0]) * np.trace(gram)
    p = p @ np.linalg.inv(np.linalg.cholesky(gram)).T
    return p @ (np.swapaxes(g, -1, -2) @ p).mean(0).T


def test_powersgd_matches_reference(ref, port):
    dense_mean = ref["psgd_grads"].mean(0)
    exact = _powersgd_f64(ref["psgd_grads"], ref["psgd_q"])
    ref_err = float(np.abs(ref["psgd_y"] - exact[None]).max())
    for rank, r in enumerate(port):
        assert float(np.abs(r["psgd"]["y"] - ref["psgd_y"][rank]).max()) <= 2 * ref_err
        assert tuple(r["psgd"]["bytes"]) == tuple(int(b) for b in ref["psgd_bytes"])
        y = r["psgd"]["y"]
        assert float(np.sum(y * dense_mean) / (np.linalg.norm(y) * np.linalg.norm(dense_mean))) > 0.7


def test_elastic_reshard_2x4_to_8x1_bitwise(port):
    W = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    for rank, r in enumerate(port):
        assert np.array_equal(r["reshard"]["w"], W[rank * 8:(rank + 1) * 8])
    assert "step_3" in port[0]["reshard"]["files"]


def test_backend_is_explicit():
    with pytest.raises(ValueError, match="backend"):
        distributed.check_backend("mpi", 2, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        distributed.spawn(torch_ranks.ranks, 2, (2,), ("data",), "cpu", backend="nccl")
    with pytest.raises(ValueError, match="does not hold"):
        distributed.spawn(torch_ranks.ranks, 2, (4,), ("data",), "cpu")
