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
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional, Sequence

from repro_torch.runtime.distributed import NamedSharding
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
    (``with_sharding_constraint``) for XLA to honour; per-rank code holds its
    local blocks and its explicit collectives fix every layout, so there is
    nothing left to constrain."""
    return x


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
