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
  eighth are noise at 0.01 either way);
* the tensor-parallel program (``torch_ranks.TP_CASES``: reduced
  llama3.2-1b, minitron-4b, phi3.5-moe, h2o-danube-1.8b with its window
  cut below the prompt, and a llama whose linears and cache divide no split
  over 4, trained with the sequence whole, in fp32 under the production
  rules, the sequence over "model"), against the reference's steps jitted
  with the specs as in_shardings: each rank's blocks exactly the
  reference's shard shapes; one step's loss, aux loss and grad norm within
  1e-5, its params within 1e-3 (absolute; 1e-6 on average: AdamW and
  Adafactor step an element whose gradient is at fp32 noise by a noisy
  fraction of the learning rate); the prefill and decode logits within
  1e-4 and the split decode cache within 1e-5; each rank's live
  collectives equal to the dry mesh's count of the same step.
"""

import dataclasses
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
from repro_torch.runtime.distributed import MeshSpec, assemble, local_block  # noqa: E402
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
# the whole-param program's step: reduced deepseek-v2 (MLA, its MoE layers expert-parallel)
cfg = dataclasses.replace(get_arch("deepseek-v2-236b", reduced=True), dtype="float32", remat="none",
                          capacity_factor=8.0)
model = build_model(cfg)
p0 = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
state = jts.TrainState(params=p0, opt_state=opt.init(p0), step=jnp.zeros((), jnp.int32))
batch = SyntheticLM(cfg, batch=4, seq=16, seed=3).at_step(0)
state, m = jax.jit(jts.make_train_step(model, opt, rules=MeshRules(mesh)))(
    state, jax.tree_util.tree_map(jnp.asarray, batch))
flat("wp_p/", p0)
flat("wp_new/", state.params)
out.update(wp_tokens=batch["tokens"], wp_targets=batch["targets"], **{"wp_" + k: v for k, v in m.items()})

# the tensor-parallel cases: jitted with the specs as in_shardings, as repro/launch/dryrun.py jits them
from repro.launch.mesh import make_rules
from repro.sharding.rules import param_specs
from repro.train.serve_step import cache_specs, make_decode_step, make_prefill_step
def shardings(specs):
    return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, P))
def rows(rules, a):
    return NamedSharding(mesh, rules.spec(("batch",) + (None,) * (a.ndim - 1), a.shape))
for tag, (arch, opt_name) in %(tp)r.items():
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32", remat="none", capacity_factor=8.0,
                              **%(cfg)r.get(tag, {}))
    model = build_model(cfg)
    opt = (jopt.adafactor if opt_name == "adafactor" else jopt.adamw)(jopt.constant_schedule(%(lr)r))
    p0 = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
    rules = make_rules(mesh, sequence_parallel=True)
    p_specs = param_specs(p0, rules)
    if tag in %(rsi)r:
        from repro.core.compress import CompressionPolicy, compress_tree
        p0, p_specs, _ = compress_tree(p0, CompressionPolicy(**%(rsi)r[tag]), jax.random.PRNGKey(5), specs=p_specs)
    flat(tag + "_p/", p0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(p0)[0]:
        spec = p_specs
        for k in path:
            spec = spec[k.key]
        out[tag + "_shape/" + "/".join(str(k.key) for k in path)] = np.array(NamedSharding(mesh, P(*spec)).shard_shape(leaf.shape))
    state = jts.TrainState(params=p0, opt_state=opt.init(p0), step=jnp.zeros((), jnp.int32))
    st = jts.state_specs(state, rules)
    st_sh = jts.TrainState(params=shardings(st.params), opt_state=shardings(st.opt_state), step=NamedSharding(mesh, P()))
    batch = jax.tree_util.tree_map(jnp.asarray, SyntheticLM(cfg, batch=4, seq=16, seed=3).at_step(0))
    trules = make_rules(mesh, sequence_parallel=%(train_seq)r.get(tag, True))
    new, m = jax.jit(jts.make_train_step(model, opt, rules=trules),
                     in_shardings=(st_sh, {k: rows(rules, v) for k, v in batch.items()}))(state, batch)
    flat(tag + "_new/", new.params)
    out.update({tag + "_tokens": batch["tokens"], tag + "_targets": batch["targets"]},
               **{tag + "_" + k: v for k, v in m.items()})
    p_sh = shardings(p_specs)
    tok = batch["tokens"]
    logits, cache = jax.jit(make_prefill_step(model, rules=rules, max_len=%(max_lens)r.get(tag, %(max_len)r)),
                            in_shardings=(p_sh, {"tokens": rows(rules, tok)}))(p0, {"tokens": tok})
    drules = make_rules(mesh, sequence_parallel=False)
    c_sh = shardings(cache_specs(cache, drules))
    cache = jax.device_put(cache, c_sh)
    step_tok = tok[:, -1:]
    dlogits, cache2 = jax.jit(make_decode_step(model, rules=drules),
                              in_shardings=(p_sh, c_sh, rows(drules, step_tok), NamedSharding(mesh, P())))(
        p0, cache, step_tok, jnp.int32(tok.shape[1]))
    flat(tag + "_cache/", cache2)
    out.update({tag + "_prefill": logits, tag + "_decode": dlogits})
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    script = textwrap.dedent(_REFERENCE) % {"lr": torch_ranks.TRAIN_LR, "tp": torch_ranks.TP_CASES,
                                            "max_len": torch_ranks.TP_MAX_LEN, "rsi": torch_ranks.TP_RSI,
                                            "max_lens": torch_ranks.TP_MAX_LENS, "cfg": torch_ranks.TP_CFG,
                                            "train_seq": torch_ranks.TP_TRAIN_SEQ}
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
                               "pipe_wo", "psgd_grads", "psgd_q", "ts_p/", "ts_tokens", "ts_targets", "wp_p/",
                               "wp_tokens", "wp_targets"))
              or any(k.startswith((tag + "_p/", tag + "_tokens", tag + "_targets")) for tag in torch_ranks.TP_CASES)}
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
    (reduced phi3.5-moe in the tensor-parallel program: each rank's blocks,
    its MoE layers expert-parallel, the batch's rows over "data"): the
    loss, the aux loss and the gradient norm within 1e-5 of the reference's
    step under its rules, every leaf assembled from the ranks' blocks after
    the step within the single-device step test's tolerance, and every
    replica of a block holding the same bits."""
    for r in port:
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(r["train"]["metrics"][k], float(ref["ts_" + k]), rtol=1e-5, err_msg=k)
    specs = port[0]["train"]["specs"]
    want = {k[len("ts_new/"):]: ref[k] for k in ref if k.startswith("ts_new/")}
    assert sorted(port[0]["train"]["params"]) == sorted(want)
    for k in want:
        got = assemble([torch.from_numpy(r["train"]["params"][k]) for r in port], specs[k], MESH)
        np.testing.assert_allclose(got.numpy(), want[k], rtol=1e-5, atol=2e-4, err_msg=k)
        for rank, r in enumerate(port):
            assert np.array_equal(r["train"]["params"][k], local_block(got, specs[k], MESH, rank).numpy()), k


def test_whole_param_train_step_matches_reference(ref, port):
    """One SGD-momentum step of make_train_step(rules=) on the (2, 4) mesh
    in the whole-param program (reduced deepseek-v2: MLA, outside the
    tensor-parallel families; its MoE layers expert-parallel over the whole
    expert stacks, the batch's rows over "data", the gradients averaged
    over the world): the loss, the aux loss and the gradient norm within
    1e-5 of the reference's step under its rules, every leaf after the
    step within the single-device step test's tolerance, and every rank
    holding the same bits."""
    for r in port:
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(r["whole_train"]["metrics"][k], float(ref["wp_" + k]), rtol=1e-5, err_msg=k)
    got = port[0]["whole_train"]["params"]
    want = {k[len("wp_new/"):]: ref[k] for k in ref if k.startswith("wp_new/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-4, err_msg=k)
        for r in port[1:]:
            assert np.array_equal(r["whole_train"]["params"][k], got[k]), k


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


TP_TAGS = tuple(torch_ranks.TP_CASES)


def _tp_whole(port, tag: str, key: str, spec) -> np.ndarray:
    return assemble([torch.from_numpy(r[tag]["params"][key]) for r in port], spec, MESH).numpy()


@pytest.mark.parametrize("tag", TP_TAGS)
def test_tensor_parallel_blocks_are_the_reference_shard_shapes(ref, port, tag):
    """Every rank holds each leaf as exactly its block: the shape the
    reference's ``NamedSharding(mesh, param_specs(...)).shard_shape`` gives
    it under the production rules on the (2, 4) mesh (the divisibility
    fallbacks included: minitron-4b's 48-wide d over 2, its 16-wide wk over 4);
    a compressed tree's factors take the specs ``compress_tree`` transforms
    them to (A the input dim's entry, B the output dim's)."""
    want = {k[len(tag) + len("_shape/"):]: tuple(int(x) for x in ref[k]) for k in ref if k.startswith(tag + "_shape/")}
    assert want
    for r in port:
        assert r[tag]["shapes"] == want


@pytest.mark.parametrize("tag", TP_TAGS)
def test_tensor_parallel_train_step_matches_reference(ref, port, tag):
    """One step of the tensor-parallel program (its blocks, Megatron's
    conjugate pair, the sequence over "model", the vocab-parallel
    cross-entropy, the gradient mean over "data" only; AdamW, or Adafactor
    for minitron-4b) against the reference's step jitted with the same
    specs as in_shardings, fp32: the loss, the aux loss and the grad norm
    within 1e-5 (relative), every rank the same; every leaf assembled from
    the ranks' blocks within 1e-3 of the reference's, absolute, and on
    average within 1e-6.  AdamW and Adafactor move each element by about
    the learning rate (1e-2) times g / sqrt(v): where a gradient is at
    fp32 noise (|g| ~ 1e-8, the two frameworks summing in other orders),
    that ratio is noise too, so single elements differ by up to ~1e-3 while
    the rest agree to ~1e-7."""
    for r in port:
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(r[tag]["metrics"][k], float(ref[tag + "_" + k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    want = {k[len(tag) + len("_new/"):]: ref[k] for k in ref if k.startswith(tag + "_new/")}
    assert sorted(want) == sorted(port[0][tag]["params"])
    for k, w in want.items():
        got = _tp_whole(port, tag, k, port[0][tag]["specs"][k])
        diff = np.abs(got - w)
        assert float(diff.max()) <= 1e-3 and float(diff.mean()) <= 1e-6, (k, float(diff.max()), float(diff.mean()))


@pytest.mark.parametrize("tag", TP_TAGS)
def test_tensor_parallel_prefill_and_decode_match_reference(ref, port, tag):
    """The prefill (the sequence over "model", flash on this rank's heads)
    and one decode step on the blocks against the reference's steps jitted
    with the specs: the logits, this rank's vocab block of its rows,
    assembled, within 1e-4 (fp32); the decode cache in ``cache_specs``'
    layout (its rows over "data", its slots over "model": the decode wrote
    the new row on the rank holding its slot and combined the ranks'
    attentions by their lse; tp_danube's ring of the prompt's last 8
    positions, 2 slots a rank; tp_whole's 22 slots whole on every rank, as
    the reference keeps a cache whose slots do not divide), assembled,
    within 1e-5 of the reference's."""
    for part in ("prefill", "decode"):
        got = assemble([torch.from_numpy(r[tag][part]) for r in port], ("data", "model"), MESH).numpy()
        np.testing.assert_allclose(got, ref[tag + "_" + part], rtol=0, atol=1e-4, err_msg=part)
    cfg = torch_ranks.tp_cfg(tag)
    slots = torch_ranks.TP_MAX_LENS.get(tag, torch_ranks.TP_MAX_LEN)
    slots = min(slots, cfg.sliding_window) if cfg.sliding_window is not None else slots
    spec = (None, "data", "model") if slots % 4 == 0 else (None, "data")  # cache_specs' fallback: whole
    for name in ("layers/k", "layers/v"):
        assert port[0][tag]["cache"][name].shape[2] == (slots // 4 if slots % 4 == 0 else slots)
        got = assemble([torch.from_numpy(r[tag]["cache"][name]) for r in port], spec, MESH).numpy()
        np.testing.assert_allclose(got, ref[tag + "_cache/" + name], rtol=0, atol=1e-5, err_msg=name)


def _dry_train_count(cfg, opt_name, whole_shapes, rank, seq: bool = True):
    """The tensor-parallel train step of rank ``rank`` on fakes of params of
    ``whole_shapes`` (path -> shape), the sequence over "model" where
    ``seq``, counted (inside a dry world)."""
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models.model import build_model
    from repro_torch.roofline import op_stats
    from repro_torch.runtime.distributed import dry_mesh
    from repro_torch.sharding.rules import layout_specs, shard_params
    from repro_torch.train import optimizer as t_opt
    from repro_torch.train import train_step as t_ts

    whole = t_ts.tree_from_paths((p, torch.empty(s, dtype=torch.float32)) for p, s in whole_shapes.items())
    rules = make_rules(dry_mesh(MESH, rank), sequence_parallel=seq)
    specs = layout_specs(whole, rules)
    blocks = shard_params(whole, rules, specs=specs)
    opt = (t_opt.adafactor if opt_name == "adafactor" else t_opt.adamw)(t_opt.constant_schedule(1e-2))
    state = t_ts.TrainState(params=blocks, opt_state=opt.init(blocks), step=torch.zeros((), dtype=torch.int32))
    batch = {k: torch.zeros((2, 16), dtype=torch.int32) for k in ("tokens", "targets")}
    fn = t_ts.make_train_step(build_model(cfg), opt, rules=rules, specs=specs)
    return op_stats.measure(lambda: fn(state, batch), arguments=(state, batch))[1]


@pytest.mark.parametrize("tag", TP_TAGS)
def test_tensor_parallel_collectives_equal_the_dry_count(port, tag):
    """Each rank's live collectives in the train step (bytes by kind and by
    axis, and their count) equal the dry mesh's record of the same step on
    that rank: the dry-run prices what the ranks move."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.roofline import dry, op_stats

    opt_name = torch_ranks.TP_CASES[tag][1]
    cfg = dataclasses.replace(torch_ranks.tp_cfg(tag), optimizer=opt_name)
    for rank in (0, 5):
        with dry.dry_world():
            seq = torch_ranks.TP_TRAIN_SEQ.get(tag, True)
            if tag in torch_ranks.TP_RSI or not seq:  # the same step on fakes of these params, under its rules
                st = _dry_train_count(cfg, opt_name, port[rank][tag]["whole"], rank, seq)
            else:
                step, args, meta, _ = dryrun.build_step(cfg, ShapeCell("t", 16, 4, "train"), MESH, rank=rank)
                _, st = op_stats.measure(step, arguments=args)
                assert meta["tensor_parallel"] and meta["sharded_by_reference_bytes"] == 0
        live = port[rank][tag]["train_collectives"]
        assert st.coll_ops == live["ops"]
        assert {k: v for k, v in st.coll_bytes.items() if v} == pytest.approx(live["by_kind"], rel=1e-12)
        assert st.coll_by_axis == pytest.approx(live["by_axis"], rel=1e-12)
