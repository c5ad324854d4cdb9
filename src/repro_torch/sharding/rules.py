"""Logical-axis sharding rules (MaxText-style, path-regex keyed).

The port's counterpart of ``repro/sharding/rules.py``, rule for rule.
Params are annotated by path pattern, not in the model code: one table
covers all ten architectures, which share their names (wq/wk/wv/wo,
w_gate/w_up/w_down, experts/..., w_x/w_B/...).

Logical axis names:
  fsdp      -> "data"   (ZeRO-3-style parameter sharding)
  tp        -> "model"  (tensor parallel: heads / d_ff / d_inner)
  ep        -> "model"  (expert parallel: the MoE expert axis)
  tp_vocab  -> "model"  (vocab-sharded embedding / lm head)
  batch     -> ("pod", "data")
  layer     -> None     (the stacked layer axis, never sharded)

Every assignment is guarded by divisibility: a dim that the product of its
mesh axes does not divide drops to replicated (what lets mamba2-130m's 24
heads sit on a 16-way model axis).

:class:`MeshRules` reads only the mesh's ``shape`` (axis name -> size), so a
:class:`~repro_torch.runtime.distributed.MeshSpec` serves as well as a live
:class:`~repro_torch.runtime.distributed.Mesh`: specs need no process group.
A spec is a tuple with one entry per dim, as ``tuple(PartitionSpec(...))``.

The layout of one rank's program.  Under rules on a live (or dry) mesh,
the dense family and the moe family without MLA (:func:`tensor_parallel`)
run the tensor-parallel program:

* Params, optimizer state and caches: each rank holds exactly its blocks
  under ``param_specs``, ``train_step.state_specs`` and
  ``serve_step.cache_specs`` (:func:`shard_params`), with the reference's
  divisibility fallback to replicated: a linear whose split dim does not
  divide over "model" is held whole there and computed whole on every rank
  (``models/modules.py::tp_linear``), and a decode cache whose slots do not
  divide over "model" is held whole and attended unsplit
  (``models/attention.py::cache_block``).  Two leaves have no fallback in
  the program: the vocab (``embed``, ``lm_head``; ``vocab_padded`` is a
  multiple of 256, so it divides any "model" axis of a power of two up to
  256) and the expert stacks, whose indivisible case the reference runs
  as the single-device layer over the global batch.  A factored leaf takes its
  dense leaf's spec through ``core/compress.py::_default_spec_transform``
  (:func:`layout_specs`): A the input dim's entry, B the output dim's.
* Activations: the layout the reference's ``maybe_constrain`` call at that
  point resolves to under the same rules: the heads over "model" where
  the head count divides; the sequence over "model" between blocks where
  "seq" is mapped; whole otherwise.
* Moving between the two is an explicit collective in the model code
  (``runtime/distributed.py``: the all-gather of an FSDP block just
  before its product, the conjugate pair and the sequence's gather and
  reduce-scatter around the tensor-parallel regions).

:func:`leaf_spec` tells the model code which dim of a leaf is split over
which axis.  The other archs (MLA, the SSM leaves, the cross-attention
and the encoder) keep the whole-param program: every rank holds every
param whole, and the rules split only the batch and the MoE experts'
compute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional, Sequence

import torch

from repro_torch.runtime.distributed import Mesh, NamedSharding
from repro_torch.tree import tree_from_paths, tree_map, tree_paths

__all__ = [
    "MeshRules",
    "active_rules",
    "use_rules",
    "bound_to_rules",
    "maybe_constrain",
    "spec_for",
    "param_specs",
    "param_shardings",
    "local_params",
    "layout_specs",
    "shard_params",
    "tensor_parallel",
    "tp_rules",
    "leaf_spec",
    "PARAM_RULES",
]

_state = threading.local()


@dataclasses.dataclass
class MeshRules:
    mesh: Any  # anything with ``shape``: axis name -> size
    logical: dict = dataclasses.field(
        default_factory=lambda: {
            "fsdp": ("data",),
            "tp": ("model",),
            "ep": ("model",),
            "tp_vocab": ("model",),
            "batch": ("pod", "data"),
            "seq": (),  # ("model",) for sequence parallelism
            "layer": (),
        }
    )

    def axis_size(self, names: Sequence[str]) -> int:
        n = 1
        for a in names:
            if a in self.mesh.shape:
                n *= self.mesh.shape[a]
        return n

    def resolve(self, logical_name: Optional[str], dim: int):
        """Mesh axes for one dim, or None if unmapped or not divisible."""
        if logical_name is None:
            return None
        axes = tuple(a for a in self.logical.get(logical_name, ()) if a in self.mesh.shape)
        if not axes:
            return None
        if dim % self.axis_size(axes) != 0:
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, logical_axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        if len(logical_axes) != len(shape):
            raise ValueError(f"logical axes {tuple(logical_axes)} for shape {tuple(shape)}")
        return tuple(self.resolve(n, d) for n, d in zip(logical_axes, shape))


def active_rules() -> Optional[MeshRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def bound_to_rules(fn):
    """``fn`` run under the rules active now, whichever thread calls it
    later: a checkpointed forward re-runs inside the backward on autograd's
    own thread for CUDA tensors, and an expert-parallel layer must take the
    same path there (``runtime/dispatch.py::bound_to_dispatch`` carries the
    kernel policy alike)."""
    rules = active_rules()

    def run(*args, **kw):
        with use_rules(rules):
            return fn(*args, **kw)

    return run


def maybe_constrain(x, logical_axes: Sequence[Optional[str]]):
    """The identity.  The reference constrains an activation's layout here
    (``with_sharding_constraint``) for XLA to honour; the port's per-rank
    code holds each activation in the layout that constraint resolves to
    and moves it by explicit collectives (the module docstring), so there
    is nothing left to constrain."""
    return x


def tensor_parallel(cfg) -> bool:
    """Whether ``cfg``'s family runs the tensor-parallel program: the dense
    family and the moe family without MLA (its leaves are plain linears,
    embeddings and expert stacks).  The MLA latents, the SSM leaves, the
    cross-attention and the encoder keep the whole-param program."""
    return cfg.family == "dense" or (cfg.family == "moe" and not cfg.kv_lora_rank and not cfg.first_dense_layers)


def tp_rules():
    """The active rules where their mesh is live (or dry), else None: the
    rules a tensor-parallel forward of a :func:`tensor_parallel` family runs
    under (a mesh description has no ranks to split anything over)."""
    rules = active_rules()
    return rules if rules is not None and isinstance(rules.mesh, Mesh) else None


def leaf_spec(name: str, shape: Sequence[int]) -> tuple:
    """The per-leaf query: the spec of the leaf ``name`` (its path under a
    layer, e.g. ``"attn/wq"``) of GLOBAL ``shape`` under the active
    tensor-parallel rules, one entry per dim (the mesh axis it is split
    over, or None); all None outside them."""
    rules = tp_rules()
    if rules is None:
        return (None,) * len(shape)
    return spec_for("layers/" + name, tuple(shape), rules) or (None,) * len(shape)


# --------------------------------------------------------------------------- #
# Parameter rules: (path regex, logical axes for the *trailing* dims).
# Leading unmatched dims (the stacked layer / group axes) default to None.
# First match wins.
# --------------------------------------------------------------------------- #
PARAM_RULES: list = [
    # embeddings / heads
    (r"(?:^|/)embed(?:/tok)?$", ("tp_vocab", "fsdp")),
    (r"(?:^|/)pos_embed$", (None, None)),
    (r"(?:^|/)lm_head$", ("fsdp", "tp_vocab")),
    # MLA
    (r"/wq_a$", ("fsdp", None)),
    (r"/wq_b$", (None, "tp")),
    (r"/wkv_a$", ("fsdp", None)),
    (r"/wkv_b$", (None, "tp")),
    # attention (dense + cross)
    (r"/w[qkv]$", ("fsdp", "tp")),
    (r"/wo$", ("tp", "fsdp")),
    (r"/b[qkv]$", ("tp",)),
    # MoE
    (r"/experts/w_(gate|up)$", ("ep", "fsdp", None)),
    (r"/experts/w_down$", ("ep", None, "fsdp")),
    (r"/router/gate_w$", ("fsdp", None)),
    # dense / shared-expert FFN
    (r"/w_(gate|up)$", ("fsdp", "tp")),
    (r"/w_down$", ("tp", "fsdp")),
    # SSM (mamba2)
    (r"/w_(z|x)$", ("fsdp", "tp")),
    (r"/w_(B|C)$", ("fsdp", None)),
    (r"/w_dt$", ("fsdp", None)),
    (r"/out_proj$", ("tp", "fsdp")),
    (r"/conv_w$", (None, "tp")),
    (r"/(A_log|dt_bias|D_param)$", ("tp",)),
    (r"/ssm_norm/scale$", ("tp",)),
    # low-rank factors (post-compression trees): A keeps the input-dim rule,
    # B the output-dim rule, the k axis unsharded.  compress_tree's
    # spec_transform replaces these where specs are threaded through it;
    # they are the fallback for freshly built low-rank params.
    (r"/a$", ("fsdp", None)),
    (r"/b$", (None, "tp")),
    # norms, biases, scalars
    (r".*", None),  # replicated
]


def spec_for(path_str: str, shape: Sequence[int], rules: MeshRules) -> tuple:
    for pat, logical in PARAM_RULES:
        if re.search(pat, path_str):
            if logical is None:
                return ()
            n_lead = len(shape) - len(logical)
            if n_lead < 0:  # rule longer than the shape (a 1-D bias under a 2-D rule)
                logical = logical[-len(shape):] if len(shape) else ()
                n_lead = 0
            return rules.spec((None,) * n_lead + tuple(logical), shape)
    return ()


def param_specs(params: Any, rules: MeshRules) -> Any:
    """The spec tree parallel to a params tree (nested dicts of tensors)."""
    return tree_from_paths((path, spec_for(path, tuple(leaf.shape), rules)) for path, leaf in tree_paths(params))


def param_shardings(params: Any, rules: MeshRules, *, rank: Optional[int] = None) -> Any:
    """A :class:`NamedSharding` a leaf: its spec on ``rules.mesh``, from ``rank``."""
    return tree_map(lambda s: NamedSharding(rules.mesh, s, rank), param_specs(params, rules))


def local_params(params: Any, rules: MeshRules, *, rank: Optional[int] = None) -> Any:
    """Each leaf's block that ``rank`` (default: this process's) holds, as views."""
    return tree_map(lambda leaf, sh: sh.local(leaf), params, param_shardings(params, rules, rank=rank))


def _is_factor(path: str) -> bool:
    return path.endswith("/a") or path.endswith("/b")


def layout_specs(params: Any, rules: MeshRules) -> Any:
    """The spec tree of the tensor-parallel layout: ``param_specs``, but a
    factored leaf ``{"a", "b"}`` takes its dense leaf's spec (its path and
    the shape ``a.shape[:-1] + b.shape[-1:]``) through
    ``core/compress.py::_default_spec_transform``, as ``compress_tree``
    gives it: A the leading and input-dim entries, B the leading and
    output-dim ones, the rank axis whole."""
    leaves = dict(tree_paths(params))
    out = []
    for path, leaf in leaves.items():
        if _is_factor(path):
            base = path[:-2]
            a, b = leaves.get(base + "/a"), leaves.get(base + "/b")
            if a is not None and b is not None:
                dense = tuple(a.shape[:-1]) + (b.shape[-1],)
                sp = spec_for(base, dense, rules)
                sp = tuple(sp) + (None,) * (len(dense) - len(sp))
                lead, in_sp, out_sp = sp[:-2], sp[-2], sp[-1]
                out.append((path, lead + ((in_sp, None) if path.endswith("/a") else (None, out_sp))))
                continue
        out.append((path, spec_for(path, tuple(leaf.shape), rules)))
    return tree_from_paths(out)


def _own_block(block, factor: bool):
    """``block`` copied into storage of its own (a factor's rows padded to
    8 elements, ``core/lowrank.py::lowrank_params``'s layout)."""
    if factor and block.dim() >= 2:
        cols = block.shape[-1]
        out = torch.empty(tuple(block.shape[:-1]) + (-(-cols // 8) * 8,), dtype=block.dtype,
                          device=block.device)[..., :cols]
    else:
        out = torch.empty(tuple(block.shape), dtype=block.dtype, device=block.device)
    return out.copy_(block)


def shard_params(params: Any, rules: MeshRules, *, rank: Optional[int] = None, specs: Any = None) -> Any:
    """Each leaf's block under :func:`layout_specs` (or ``specs``) that
    ``rank`` (default: the mesh's own, else this process's) holds, each in
    storage of its own, not a view of the whole (:func:`local_params` gives
    views).  Factors keep their padded-row storage."""
    specs = layout_specs(params, rules) if specs is None else specs
    if rank is None:
        rank = getattr(rules.mesh, "rank", None)
    mesh = rules.mesh
    sp = dict(tree_paths(specs))
    out = []
    for path, leaf in tree_paths(params):
        sh = NamedSharding(mesh, tuple(sp[path]), rank)
        out.append((path, _own_block(sh.local(leaf), _is_factor(path))))
    return tree_from_paths(out)
