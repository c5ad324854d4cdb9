"""The dry-run's counts against the reference and against real runs, on the CPU.

* FLOPs: reduced llama3.2-1b and phi3.5-moe at (2, 64), through the forward,
  the prefill, one decode step and one AdamW train step, counted by the
  port's dry world at world 1 and by the reference's ``analyze_hlo`` on
  ``jax.jit(...).lower(...).compile().as_text()``.  The reference's XLA
  attention computes every (query, key) product of the square and masks it,
  where the port's flash kernel computes the causal half; the port's count
  prices each flash call at the square (``kernel_cost.flash_attention(...,
  causal=False)``) for the comparison.  Tolerance 3%: measured 0.977-1.003
  (the elementwise ops of the two programs differ: XLA's fused softmax and
  norms against torch's composite ops).
* Kernel calls: the dry-run's ``kernels`` of a reduced cell equal the
  dispatch's counters of the same step really run on the CPU, op by op.
* Collectives: on a dry (2, 4) mesh, reduced phi3.5-moe's expert-parallel
  psum and the train step's gradient mean give the bytes of the
  reference's ring formula, exactly.
* The launchers: ``launch.dryrun --reduced`` writes a record with every key
  of the reference's; ``launch.train --fake-devices 8`` gives the losses of
  the same run without it.
"""

import json
import os

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.roofline.hlo_stats import analyze_hlo  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import make_rules  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.roofline import dry, kernel_cost, op_stats  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch  # noqa: E402
from repro_torch.runtime.distributed import MeshSpec, dry_mesh  # noqa: E402
from repro_torch.sharding.rules import layout_specs, use_rules  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train.train_step import TrainState, make_train_step  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

B, S = 2, 64
FLOP_REL = 0.03
ARCHS = ("llama3.2-1b", "phi3.5-moe-42b-a6.6b")
STEPS = ("forward", "prefill", "decode", "train")
# every key of the reference's cell record (repro/launch/dryrun.py::run_cell)
REFERENCE_KEYS = (
    "arch", "shape", "kind", "tokens", "n_params", "n_params_active", "model_flops_global", "mesh", "chips",
    "lower_s", "compile_s", "flops_per_chip", "xla_cost_analysis_flops_raw", "hbm_bytes_per_chip",
    "collective_bytes_per_chip", "collectives_by_kind", "collective_op_count", "memory", "t_compute",
    "t_memory", "t_collective", "bottleneck", "useful_flops_ratio", "roofline_fraction", "hlo_bytes",
)


def _schedule(opt_mod):
    return opt_mod.cosine_schedule(3e-4, 2000, 100_000)


@pytest.fixture(scope="module")
def reference_flops():
    """{(arch, step): FLOPs} of the reference at world 1 (one compile each)."""
    out = {}
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    for arch in ARCHS:
        cfg = j_get_arch(arch, reduced=True)
        m = j_build_model(cfg)
        p = jax.eval_shape(m.init, jax.random.PRNGKey(0))

        def count(fn, *args):
            return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text(), world=1).flops

        out[arch, "forward"] = count(lambda p, t: m.forward(p, {"tokens": t})[0], p, tok)
        out[arch, "prefill"] = count(lambda p, t: m.prefill(p, {"tokens": t}, S + 8), p, tok)
        cache = jax.eval_shape(lambda: m.init_cache(B, S + 8))
        out[arch, "decode"] = count(lambda p, c, t: m.decode_step(p, c, t, jnp.int32(S)), p, cache,
                                    jax.ShapeDtypeStruct((B, 1), jnp.int32))
        opt = j_opt.adamw(_schedule(j_opt))
        state = jax.eval_shape(lambda p: j_ts.TrainState(params=p, opt_state=opt.init(p),
                                                         step=jnp.zeros((), jnp.int32)), p)
        out[arch, "train"] = count(j_ts.make_train_step(m, opt, accum_steps=cfg.accum_steps), state,
                                   {"tokens": tok, "targets": tok})
    return out


@pytest.fixture(scope="module")
def port_stats():
    """{(arch, step): OpStats} of the port's dry world at world 1."""
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch, reduced=True)
        with dry.dry_world(), use_dispatch(DispatchConfig.from_arch(cfg)):
            m = build_model(cfg)
            p = m.init(torch.Generator().manual_seed(0))
            t = torch.zeros((B, S), dtype=torch.int32)
            with torch.no_grad():
                out[arch, "forward"] = op_stats.measure(lambda: m.forward(p, {"tokens": t}), arguments=p)[1]
                out[arch, "prefill"] = op_stats.measure(lambda: m.prefill(p, {"tokens": t}, S + 8), arguments=p)[1]
                c = m.init_cache(B, S + 8)
                one = torch.zeros((B, 1), dtype=torch.int32)
                out[arch, "decode"] = op_stats.measure(lambda: m.decode_step(p, c, one, S), arguments=(p, c))[1]
            opt = t_opt.adamw(_schedule(t_opt))
            state = TrainState(params=p, opt_state=opt.init(p), step=torch.zeros((), dtype=torch.int32))
            step = make_train_step(m, opt, accum_steps=cfg.accum_steps)
            out[arch, "train"] = op_stats.measure(lambda: step(state, {"tokens": t, "targets": t}),
                                                  arguments=state)[1]
    return out


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_match_reference_hlo(reference_flops, port_stats, arch, step):
    st, cfg = port_stats[arch, step], get_arch(arch, reduced=True)
    flops = st.flops
    flash = st.kernels.get("flash_attention")
    if flash:  # each flash call priced at the square the reference's XLA attention computes
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        assert flash["flops"] == flash["calls"] * kernel_cost.flash_attention(B, S, S, H, KV, hd, 2)[0]
        flops += flash["calls"] * (kernel_cost.flash_attention(B, S, S, H, KV, hd, 2, causal=False)[0]
                                   - kernel_cost.flash_attention(B, S, S, H, KV, hd, 2)[0])
    assert flops == pytest.approx(reference_flops[arch, step], rel=FLOP_REL)


def _kernel_ops(counts: dict) -> dict:
    """{op: calls} of the ops that run a kernel on the card, whatever path
    they took (on the CPU: the plain versions), the stacked low-rank apply
    under its own kernel's name."""
    ops = ("lowrank_matmul", "sketch_matmul", "logits", "flash_attention", "decode_attention",
           "paged_decode_attention", "ssd_scan")
    out = {}
    for (op, path, sig), n in counts.items():
        if op in ops:
            name = "lowrank_matmul_batched" if op == "lowrank_matmul" and sig[0] > 1 else op
            out[name] = out.get(name, 0) + n
    return dict(sorted(out.items()))


@pytest.mark.parametrize("arch, cell", [
    ("llama3.2-1b", ShapeCell("train", 32, 2, "train")),
    ("llama3.2-1b", ShapeCell("prefill", 32, 2, "prefill")),
    ("llama3.2-1b", ShapeCell("decode", 40, 2, "decode")),
    ("mamba2-130m", ShapeCell("prefill", 32, 2, "prefill")),
])
def test_dry_kernel_calls_equal_a_real_run(arch, cell):
    st = dryrun.count_cell(arch, cell, None, reduced=True)[0]
    step, args, _, _ = dryrun.build_step(arch, cell, None, reduced=True, device="cpu")
    dispatch.reset_counters()
    step()
    real = _kernel_ops(dispatch.counters())
    assert real and {k: v["calls"] for k, v in st.kernels.items()} == real


def test_a_dry_step_makes_only_fakes():
    """Every tensor a dry train step returns is a fake, and a real tensor
    reaching an op inside the dry world raises."""
    from torch._subclasses.fake_tensor import FakeTensor

    with dry.dry_world():
        step, args, _, _ = dryrun.build_step("llama3.2-1b", ShapeCell("t", 16, 2, "train"), None, reduced=True)
        state, metrics = step()
        leaves = [t for _, t in tree_paths(state.params)] + [t for _, t in tree_paths(state.opt_state)]
        assert leaves and all(isinstance(t, FakeTensor) for t in leaves + list(metrics.values()))
    real = torch.ones(2)
    with dry.dry_world(), pytest.raises(Exception, match="convert all Tensors to FakeTensors"):
        torch.zeros(2) + real


def _allreduce(n: int, nbytes: float) -> float:
    return 2.0 * (n - 1) / n * nbytes


def test_ep_psum_bytes_on_a_dry_mesh():
    """One MoE layer's forward on rank 5 of (2, 4): its psum over "model" of
    the fp32 (tokens, d) combine, and the aux loss's mean over "data"."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b", reduced=True)
    spec = MeshSpec((2, 4), ("data", "model"))
    with dry.dry_world(), torch.no_grad():
        rules = make_rules(dry_mesh(spec, 5))
        p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, dry.stand_in_device())
        x = torch.zeros((2, 16, cfg.d_model), dtype=torch.bfloat16)
        with use_rules(rules):
            (out, aux), st = op_stats.measure(lambda: moe.moe_forward(p, x, cfg), arguments=(p, x))
    assert tuple(out.shape) == tuple(x.shape)
    assert st.coll_ops == 2
    assert st.coll_by_axis == {"model": _allreduce(4, 2 * 16 * cfg.d_model * 4), "data": _allreduce(2, 4)}


class _Expected:
    """Collectives by kind and axis, at the reference's ring formulas."""

    def __init__(self):
        self.by_kind, self.by_axis, self.ops = {}, {}, 0

    def add(self, kind, axis, moved):
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + moved
        self.by_axis[axis] = self.by_axis.get(axis, 0.0) + moved
        self.ops += 1

    def ag(self, axis, n, result):  # an all-gather's gathered result, bytes
        self.add("all-gather", axis, (n - 1) / n * result)

    def rs(self, axis, n, block):  # a reduce-scatter's scattered block, bytes
        self.add("reduce-scatter", axis, (n - 1.0) * block)

    def ar(self, axis, n, nbytes):
        self.add("all-reduce", axis, 2.0 * (n - 1) / n * nbytes)


def _tp_train_collectives(cfg, rows: int, seq: int, D: int, M: int, specs) -> _Expected:
    """The tensor-parallel train step's collectives on one rank of (D, M)
    ("data", "model"), derived from the params' specs (every linear of
    these reduced configs splits over both axes; the sequence over "model"):

    * each FSDP block gathered over "data" just before its product (the
      gather's backward a reduce-scatter), each column-parallel region
      entered by the sequence's gather over "model" and each row-parallel
      one left by its reduce-scatter (the backwards swap them), the norm
      scales' copies psummed over "model" in the backward, the KV heads that
      do not divide "model" gathered from their column blocks;
    * the embedding: its ``d`` gathered, its rows reduce-scattered onto the
      sequence; the head: gathered once, the final rows gathered over the
      sequence; the cross-entropy's max, sum of exponentials and gold logit
      all-reduced over "model" a chunk, again in the chunk's recomputation;
    * each block recomputed in the backward up to its last saved tensor:
      everything but its final reduce-scatter;
    * a MoE layer: the rows gathered whole (a sliced backward), the router's
      ``d`` gathered, the aux loss's mean over "data" (forward and
      backward), the experts' ``d`` gathered, the rows' and gates' copies
      psummed in the backward, the fp32 combine reduce-scattered;
    * then the gradient mean over "data" of every leaf "data" does not
      split (fp32), the loss and aux means, the global norm's psum."""
    e = 2  # bf16
    B, S, d, V = rows, seq, cfg.d_model, cfg.vocab_padded
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = _Expected()
    row, row_s = B * S * d * e, B * (S // M) * d * e  # whole rows, this rank's sequence block

    def linear_fwd(d_in, d_out):
        x.ag("data", D, d_in * d_out // M * e)

    def linear_bwd(d_in, d_out):
        x.rs("data", D, d_in * d_out // (M * D) * e)

    def attn(fwd):
        if fwd:
            x.ag("model", M, row)
            for n in (H * hd, KV * hd, KV * hd):
                linear_fwd(d, n)
            for _ in range(2 if KV % M else 0):
                x.ag("model", M, B * S * KV * hd * e)
            linear_fwd(H * hd, d)
            x.rs("model", M, row_s)
        else:
            x.rs("model", M, row_s)
            for n in (H * hd, KV * hd, KV * hd):
                linear_bwd(d, n)
            for _ in range(2 if KV % M else 0):
                x.rs("model", M, B * S * KV * hd // M * e)
            linear_bwd(H * hd, d)
            x.ag("model", M, row)

    def mlp(fwd, last=True):
        if cfg.family == "moe":
            E, f, K, T = cfg.n_experts, cfg.moe_d_ff, cfg.top_k, B * S
            if fwd:
                x.ag("model", M, row)
                x.ag("data", D, d * E * e)
                x.ar("data", D, 4)
                for shape in ((d, f), (d, f), (f, d)):
                    x.ag("data", D, E // M * shape[0] * shape[1] * e)
                if last:
                    x.rs("model", M, B * (S // M) * d * 4)
            else:
                x.rs("data", D, d // D * E * e)
                x.ar("data", D, 4)
                for shape in ((d, f), (d, f), (f, d)):
                    x.rs("data", D, E // M * shape[0] * shape[1] // D * e)
                x.ar("model", M, T * d * e)
                x.ar("model", M, T * K * 4)
                x.ag("model", M, B * S * d * 4)
            return
        f = cfg.d_ff
        if fwd:
            x.ag("model", M, row)
            linear_fwd(d, f)
            linear_fwd(d, f)
            linear_fwd(f, d)
            if last:
                x.rs("model", M, row_s)
        else:
            x.rs("model", M, row_s)
            for shape in ((d, f), (d, f), (f, d)):
                linear_bwd(*shape)
            x.ag("model", M, row)

    n_chunks = 16
    while S % n_chunks:
        n_chunks //= 2
    # forward: the embedding, every block, the final rows, the head, the chunks
    x.ag("data", D, V // M * d * e)
    x.rs("model", M, row_s)
    for _ in range(cfg.n_layers):
        attn(True)
        mlp(True)
    x.ag("model", M, row)
    x.ag("data", D, V // M * d * e)
    for _ in range(3 * n_chunks):
        x.ar("model", M, B * (S // n_chunks) * 4)
    # backward: the chunks' recomputation, the head and final rows, each block's recomputation and
    # backward (its two norm scales' copies), the final norm's copy, the embedding
    for _ in range(3 * n_chunks):
        x.ar("model", M, B * (S // n_chunks) * 4)
    x.rs("data", D, V // M * d // D * e)
    x.rs("model", M, row_s)
    x.ar("model", M, d * e)
    for _ in range(cfg.n_layers):
        attn(True)
        mlp(True, last=False)
        mlp(False)
        x.ar("model", M, d * e)
        attn(False)
        x.ar("model", M, d * e)
    x.ag("model", M, row)
    x.rs("data", D, V // M * d // D * e)
    # the gradient mean over "data", the loss and aux means, the global norm
    for _, spec, leaf in specs:
        if "data" not in spec:
            x.ar("data", D, leaf.numel() * 4)
    x.ar("data", D, 4)
    x.ar("data", D, 4)
    x.ar("data", D, 4)
    x.ar("model", M, 4)
    return x


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_collective_bytes_on_a_dry_mesh(arch):
    """The tensor-parallel train step on rank 5 of (2, 4): its collectives
    by kind and by axis, and their count, equal those derived from the
    params' specs (:func:`_tp_train_collectives`), exactly; the rank holds
    only its blocks (``sharded_by_reference_bytes`` 0)."""
    cfg = get_arch(arch, reduced=True)
    rows, seq = 2, 32
    with dry.dry_world():
        step, args, meta, rules = dryrun.build_step(cfg, ShapeCell("t", seq, 2 * rows, "train"),
                                                    MeshSpec((2, 4), ("data", "model")), rank=5)
        _, st = op_stats.measure(step, arguments=args)
        whole = build_model(cfg).init(torch.Generator().manual_seed(0))
        specs = dict(tree_paths(layout_specs(whole, rules)))
        leaves = [(p, tuple(specs[p] or ()), t) for p, t in tree_paths(args[0].params)]
    assert meta["rows_per_rank"] == rows and meta["tensor_parallel"] and meta["sharded_by_reference_bytes"] == 0
    want = _tp_train_collectives(cfg, rows, seq, 2, 4, leaves)
    assert st.coll_ops == want.ops
    assert {k: v for k, v in st.coll_bytes.items() if v} == pytest.approx(want.by_kind, rel=1e-12)
    assert st.coll_by_axis == pytest.approx(want.by_axis, rel=1e-12)


def test_dryrun_writes_every_reference_key(tmp_path):
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "single", "--reduced",
                 "--out", str(tmp_path)])
    with open(os.path.join(tmp_path, "single_pod_16x16", "llama3.2-1b__decode_32k.json")) as f:
        r = json.load(f)
    assert set(REFERENCE_KEYS) <= set(r)
    assert r["chips"] == 256 and r["rows_per_rank"] == 128 // 16 and r["fits"] is True
    cfg = get_arch("llama3.2-1b", reduced=True)
    assert r["kernels"]["decode_attention"]["calls"] == cfg.n_layers
    assert r["peak_bytes"] >= r["argument_bytes"] > 0 and r["sharded_by_reference_bytes"] == 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    # the arguments are the rank's blocks under the specs: each param leaf's block (its dims over
    # "data" and "model" where they divide 16), the cache's 8 rows of 32768 / 16 slots, the tokens
    mesh = MeshSpec((16, 16), ("data", "model"))
    with dry.dry_world():
        whole = build_model(cfg).init(torch.Generator().manual_seed(0))
        specs = dict(tree_paths(layout_specs(whole, make_rules(mesh))))
        blocks = 0
        for path, leaf in tree_paths(whole):
            split = 1
            for dim, entry in enumerate(specs[path] or ()):
                split *= mesh.shape[entry] if entry else 1
            blocks += leaf.numel() * leaf.element_size() // split
    cache = 2 * cfg.n_layers * 8 * (32768 // 16) * cfg.n_kv_heads * cfg.head_dim * 2
    assert r["argument_bytes"] == blocks + cache + 8 * 4


def test_train_fake_devices_gives_the_same_losses(capsys):
    argv = ["--arch", "llama3.2-1b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"]
    _, plain = train_launcher.main(argv)
    _, fake = train_launcher.main(argv + ["--fake-devices", "8"])
    assert "[fake-devices] 8 devices requested" in capsys.readouterr().out
    assert float(fake["loss"]) == float(plain["loss"]) and float(fake["grad_norm"]) == float(plain["grad_norm"])
    with pytest.raises(SystemExit):
        train_launcher.main(argv + ["--fake-devices", "-1"])
