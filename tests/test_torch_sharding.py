"""The port's sharding specs against the reference's, in process (no ranks).

``sharding/rules.py`` reads only ``mesh.shape``, so the reference's
``MeshRules`` takes a stand-in mesh with a ``shape`` mapping and needs no
devices; the port's takes a ``MeshSpec``.  On the production meshes (16,
16) and (2, 16, 16) and the test meshes (2, 4) and (8, 1), for every
reduced architecture: every param leaf's spec, equal to ``tuple(P)`` of the
reference's; the spec output of ``compress_tree`` (llama3.2-1b and
phi3.5-moe, alpha 0.3, q 1); a TrainState's specs under AdamW, Adafactor and
SGD-momentum; and every decode-cache leaf's spec (the vlm's self K/V is one
merged stack in the port: its spec is the reference's with one leading None
fewer, ``train/serve_step.py::cache_specs``).  Exact equality throughout.
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.core import CompressionPolicy as JPolicy  # noqa: E402
from repro.core import compress_tree as j_compress_tree  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import serve_step as j_serve  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.configs.registry import REFERENCE_ARCH_IDS, get_arch  # noqa: E402
from repro_torch.core import CompressionPolicy, compress_tree  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, batch_sharding, shard_batch  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_rules  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import distributed  # noqa: E402
from repro_torch.runtime.distributed import MeshSpec, local_block  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train.serve_step import cache_specs, make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.train.train_step import TrainState, make_train_step, state_specs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

MESHES = {
    "16x16": MeshSpec((16, 16), ("data", "model")),
    "2x16x16": MeshSpec((2, 16, 16), ("pod", "data", "model")),
    "2x4": MeshSpec((2, 4), ("data", "model")),
    "8x1": MeshSpec((8, 1), ("data", "model")),
}
CACHE_BATCH, CACHE_LEN = 32, 64  # divisible by every batch axis product and every model axis


class _ShapeMesh:
    """What the reference's MeshRules reads of a mesh: its shape."""

    def __init__(self, spec: MeshSpec):
        self.shape = spec.shape


def _j_rules(mesh: str):
    return jrules.MeshRules(_ShapeMesh(MESHES[mesh]))


def _j_flat(tree) -> dict:
    """path -> leaf of a JAX pytree (the reference's path strings)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jrules._path_str(p): leaf for p, leaf in flat}


def _t_flat(tree, prefix="") -> dict:
    """path -> leaf of a nested dict (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_t_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _spec(p) -> tuple:
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _j_shapes(arch: str):
    return jax.eval_shape(j_build_model(j_get_arch(arch, reduced=True)).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _t_params(arch: str):
    return build_model(get_arch(arch, reduced=True), device="cpu").init(torch.Generator().manual_seed(0))


def test_production_mesh_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_rules(make_production_mesh()).logical["seq"] == ("model",)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", REFERENCE_ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    want = {k: _spec(v) for k, v in _j_flat(jrules.param_specs(_j_shapes(arch), _j_rules(mesh))).items()}
    got = _t_flat(rules.param_specs(_t_params(arch), rules.MeshRules(MESHES[mesh])))
    assert set(got) == set(want)
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_local_params_cut_each_rank_its_block(mesh):
    """The blocks of every rank tile each leaf exactly: each element is held
    by (mesh size / the leaf's shard count) ranks."""
    ms = MESHES[mesh]
    params = _t_params("phi3.5-moe-42b-a6.6b")
    r = rules.MeshRules(ms)
    specs = _t_flat(rules.param_specs(params, r))
    zeros = lambda t: {k: zeros(v) for k, v in t.items()} if isinstance(t, dict) else torch.zeros(t.shape)
    counts = zeros(params)
    for rank in range(ms.size):
        for k, blk in _t_flat(rules.local_params(counts, r, rank=rank)).items():
            blk += 1
    for k, c in _t_flat(counts).items():
        n = int(np.prod([ms.index(e, ms.coords(0))[1] for e in specs[k]], dtype=np.int64))
        assert torch.all(c == ms.size // n), k


@functools.lru_cache(maxsize=None)
def _j_compressed_params(arch: str):
    return jax.jit(j_build_model(j_get_arch(arch, reduced=True)).init)(jax.random.PRNGKey(0))


COMPRESS = dict(alpha=0.3, q=1, min_dim=16)


def _k_over_model(parts: tuple) -> tuple:
    """A given spec_transform: A's k axis over "model", B's input (k) axis likewise."""
    return parts[:-1] + ("model",), parts[:-2] + ("model", None)


@pytest.mark.parametrize("transform", ["default", "k_over_model"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b"])
def test_compressed_specs_match_reference(arch, mesh, transform):
    """The spec output of compress_tree, by the reference's default rule or
    by a given transform, the same transform handed to both."""
    jtf = ttf = None
    if transform == "k_over_model":
        jtf = lambda sp: tuple(jax.sharding.PartitionSpec(*s) for s in _k_over_model(tuple(sp)))  # noqa: E731
        ttf = _k_over_model
    jp = _j_compressed_params(arch)
    _, jspecs, jrep = j_compress_tree(jp, JPolicy(**COMPRESS), jax.random.PRNGKey(1),
                                      specs=jrules.param_specs(jp, _j_rules(mesh)), spec_transform=jtf)
    tp = _t_params(arch)
    r = rules.MeshRules(MESHES[mesh])
    _, tspecs, trep = compress_tree(tp, CompressionPolicy(**COMPRESS), generator=torch.Generator().manual_seed(1),
                                    specs=rules.param_specs(tp, r), spec_transform=ttf)
    assert [l.compressed for l in trep.layers] == [l.compressed for l in jrep.layers]
    assert any(l.compressed for l in trep.layers)
    want = {k: _spec(v) for k, v in _j_flat(jspecs).items()}
    assert _t_flat(tspecs) == want
    a_specs = [v for k, v in want.items() if k.endswith("/a")]
    assert a_specs and all((v[-1] == "model") == (transform == "k_over_model") for v in a_specs)
    # without specs the return stays (params, report)
    assert len(compress_tree(tp, CompressionPolicy(**COMPRESS), generator=torch.Generator().manual_seed(1))) == 2


OPTS = {
    "adamw": (lambda: j_opt.adamw(j_opt.constant_schedule(1e-3)), lambda: t_opt.adamw(t_opt.constant_schedule(1e-3))),
    "adafactor": (lambda: j_opt.adafactor(j_opt.constant_schedule(1e-3)),
                  lambda: t_opt.adafactor(t_opt.constant_schedule(1e-3))),
    "sgdm": (lambda: j_opt.sgdm(j_opt.constant_schedule(1e-3)), lambda: t_opt.sgdm(t_opt.constant_schedule(1e-3))),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b", "mamba2-130m"])
def test_state_specs_match_reference(arch, opt, mesh):
    j_make, t_make = OPTS[opt]
    jp = _j_shapes(arch)
    jstate = j_ts.TrainState(params=jp, opt_state=jax.eval_shape(j_make().init, jp),
                             step=jax.ShapeDtypeStruct((), np.int32))
    jspecs = j_ts.state_specs(jstate, _j_rules(mesh))
    tp = _t_params(arch)
    tstate = TrainState(params=tp, opt_state=t_make().init(tp), step=torch.zeros((), dtype=torch.int32))
    tspecs = state_specs(tstate, rules.MeshRules(MESHES[mesh]))
    assert _t_flat(tspecs.params) == {k: _spec(v) for k, v in _j_flat(jspecs.params).items()}
    assert _t_flat(tspecs.opt_state) == {k: _spec(v) for k, v in _j_flat(jspecs.opt_state).items()}
    assert tspecs.step == _spec(jspecs.step)


def _cache_pairs(arch: str, got: dict, want: dict) -> list:
    """(port path, port spec, reference spec) per corresponding leaf."""
    pairs = []
    for path, spec in got.items():
        if get_arch(arch, reduced=True).family == "vlm":
            if path.startswith("cross_kv/"):
                pairs.append((path, spec, want["layers/" + path]))
            else:  # layers/k: the reference's layers/self/k with its (G, n_self) dims merged
                ref = want[path.replace("layers/", "layers/self/")]
                assert ref[:2] == (None, None), ref
                pairs.append((path, spec, ref[1:]))
        else:
            pairs.append((path, spec, want[path]))
    return pairs


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", REFERENCE_ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    jm = j_build_model(j_get_arch(arch, reduced=True))
    jcache = jax.eval_shape(lambda: jm.init_cache(CACHE_BATCH, CACHE_LEN))
    want = {k: _spec(v) for k, v in _j_flat(j_serve.cache_specs(jcache, _j_rules(mesh))).items()}
    tm = build_model(get_arch(arch, reduced=True), device="cpu")
    got = _t_flat(cache_specs(tm.init_cache(CACHE_BATCH, CACHE_LEN), rules.MeshRules(MESHES[mesh])))
    pairs = _cache_pairs(arch, got, want)
    assert len(pairs) == len(want)
    for path, g, w in pairs:
        assert g == w, (path, g, w)


def test_local_block_follows_the_reference_layout():
    """A dim over ("pod", "data") splits with "pod" major, as a
    PartitionSpec's tuple entry does; assemble is local_block's inverse."""
    ms = MESHES["2x16x16"]
    x = torch.arange(64 * 32).reshape(64, 32)
    rank = 16 * 16 + 3 * 16 + 1  # pod 1, data 3, model 1
    assert ms.coords(rank) == {"pod": 1, "data": 3, "model": 1}
    spec = (("pod", "data"), "model")
    i = 1 * 16 + 3  # 64 rows over 32 ranks: two rows a block; 32 columns over 16: two a block
    assert torch.equal(local_block(x, spec, ms, rank), x[2 * i:2 * i + 2, 2:4])
    blocks = [local_block(x, spec, ms, r) for r in range(ms.size)]
    assert torch.equal(distributed.assemble(blocks, spec, ms), x)
    with pytest.raises(ValueError, match="does not divide"):
        local_block(torch.zeros(64, 8), spec, ms, rank)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("B", [32, 3])
def test_shard_batch_takes_the_reference_rows(mesh, B):
    """Each rank's rows under the reference's batch spec, replicated where
    the batch does not divide."""
    ms = MESHES[mesh]
    batch = {"tokens": np.arange(B * 4).reshape(B, 4), "frames": np.ones((B, 2, 3), np.float32)}
    want = {k: _spec(_j_rules(mesh).spec(("batch",) + (None,) * (v.ndim - 1), v.shape)) for k, v in batch.items()}
    r = rules.MeshRules(ms)
    for rank in (0, ms.size - 1):
        got = shard_batch(batch, r, rank=rank, device="cpu")
        for k, v in batch.items():
            assert torch.equal(got[k], torch.as_tensor(local_block(v, want[k], ms, rank)))
    if B % math.prod(ms.shape.get(a, 1) for a in ("pod", "data")):
        assert all(got[k].shape == batch[k].shape for k in batch)
    assert batch_sharding(r, {"tokens": 2, "frames": 3}) == {"tokens": ("batch", None),
                                                            "frames": ("batch", None, None)}


def test_prefetcher_yields_in_order_and_surfaces_errors():
    r = rules.MeshRules(MESHES["2x4"])
    batches = [{"tokens": np.full((4, 2), i)} for i in range(3)]
    got = list(Prefetcher(iter(batches), r, device="cpu", rank=5))  # rank 5: data row 1 of 2
    assert [int(b["tokens"][0, 0]) for b in got] == [0, 1, 2] and all(b["tokens"].shape == (2, 2) for b in got)

    def broken():
        yield batches[0]
        raise ValueError("bad batch")

    pf = Prefetcher(broken(), device="cpu")
    assert int(next(pf)["tokens"][0, 0]) == 0
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)


def test_serve_steps_run_under_their_rules():
    seen = []

    class Model:
        def prefill(self, params, batch, max_len):
            seen.append((rules.active_rules(), max_len))
            return "prefill"

        def decode_step(self, params, cache, tokens, pos):
            seen.append((rules.active_rules(), pos))
            return "decode"

    r = rules.MeshRules(MESHES["2x4"])
    assert make_prefill_step(Model(), rules=r, max_len=7)({}, {}) == "prefill"
    assert make_decode_step(Model(), rules=r)({}, {}, None, 3) == "decode"
    assert seen == [(r, 7), (r, 3)] and rules.active_rules() is None


def test_train_step_under_rules_is_the_same_step():
    """A dense model's step under rules is the step without them (the
    constraints are the identity); a MoE layer under rules on a mesh
    description (no process group) raises rather than run single-device."""
    cfg = get_arch("llama3.2-1b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = t_opt.adamw(t_opt.constant_schedule(1e-3))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))}
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    state = TrainState(params=params, opt_state=opt.init(params), step=torch.zeros((), dtype=torch.int32))
    a, ma = make_train_step(model, opt)(state, batch)
    b, mb = make_train_step(model, opt, rules=rules.MeshRules(MESHES["2x4"]))(state, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    for (ka, va), (kb, vb) in zip(sorted(_t_flat(a.params).items()), sorted(_t_flat(b.params).items())):
        assert ka == kb and torch.equal(va, vb), ka
    mcfg = get_arch("phi3.5-moe-42b-a6.6b", reduced=True)
    p = _t_params("phi3.5-moe-42b-a6.6b")["layers"]["moe"]
    lp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = torch.zeros((2, 4, mcfg.d_model))
    with rules.use_rules(rules.MeshRules(MESHES["2x4"])), pytest.raises(RuntimeError, match="no live mesh"):
        moe.moe_forward(lp, x, mcfg)


def test_checkpointed_blocks_keep_the_forwards_rules_on_another_thread():
    """A checkpointed forward re-runs inside the backward on autograd's own
    thread on the card; the rules bound at the forward are active there."""
    import threading

    r = rules.MeshRules(MESHES["2x4"])
    seen = []
    with rules.use_rules(r):
        bound = rules.bound_to_rules(lambda: seen.append(rules.active_rules()))
    t = threading.Thread(target=bound)
    t.start()
    t.join()
    assert seen == [r]
