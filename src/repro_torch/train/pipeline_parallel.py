"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

The port's counterpart of ``repro/train/pipeline_parallel.py``.  The layer
stack is cut into contiguous stages, one a rank along ``axis`` (the stacked
leaves' block on spec ``(axis,)``); microbatches stream through the stages
on the reference's tick schedule: T = M + S - 1 ticks, stage s working on
microbatch t - s at tick t.  Each tick's activation goes to the next stage
by send / recv (through the host under gloo); the last stage collects the
outputs, and a masked psum hands them to every stage, as the reference's
(what the loss needs).  Per-rank code differs from the reference's traced
loop in two places that change no output: an idle stage computes nothing
(the reference computes and masks to zeros), and nothing travels from the
last stage back to the first (the reference's ring sends it zeros the
first stage never reads).

The backward is autograd through the schedule, as the reference's is
autodiff through its loop: each shift's backward is the reverse shift, the
final psum's is a psum, and a token threaded through the shifts (joined
into the output) runs every stage's backward in reverse tick order.  A
stage's backward of its loss L_s gives d(sum_s L_s)/d(its slice); with
every stage computing the same loss that is S times the gradient of L (see
``runtime/distributed.py`` on gradients).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.runtime.distributed import Mesh, axis_index, axis_size, join, psum, shift, shift_token
from repro_torch.tree import tree_map, tree_paths

__all__ = ["gpipe_apply", "pipeline_forward"]


def _n_layers(stack: Any) -> int:
    return next(tree_paths(stack))[1].shape[0]


def _stage_body(block_fn: Callable, stage_params: Any, x: torch.Tensor) -> torch.Tensor:
    """This stage's slice of layers, in order."""
    for i in range(_n_layers(stage_params)):
        x = block_fn(tree_map(lambda t: t[i], stage_params), x)
    return x


def pipeline_forward(block_fn: Callable, params_stack: Any, x_mb: torch.Tensor, *, axis: str = "pod",
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One rank's part of the pipeline: ``params_stack`` its (L/S, ...)
    slice, ``x_mb`` (M, b, ...) the microbatches (the same on every stage).
    Returns (M, b, ...) outputs, the same on every stage."""
    S = axis_size(axis, mesh)
    stage = axis_index(axis, mesh)
    M = x_mb.shape[0]
    outs = torch.zeros_like(x_mb)
    buf = None  # the activation that arrived from the previous stage
    token = shift_token(x_mb.device, x_mb.requires_grad or any(t.requires_grad for _, t in tree_paths(params_stack)))
    for t in range(M + S - 1):
        mb_in = t - stage  # the microbatch entering this stage at tick t
        active = 0 <= mb_in < M
        y = None
        if active:
            y = _stage_body(block_fn, params_stack, x_mb[mb_in] if stage == 0 else buf)
            if stage == S - 1:
                outs[mb_in] = y
        # the previous stage's microbatch t - stage + 1 enters here at tick t + 1
        prev_active = stage > 0 and 0 <= t - (stage - 1) < M
        buf, token = shift(y, axis, send=active and stage < S - 1, recv_like=x_mb[0] if prev_active else None,
                           token=token, mesh=mesh)
    # the last stage's outputs to every stage: a masked psum, in fp32 (x + 0 is exact, so the
    # bits of any dtype come through)
    mask = 1.0 if stage == S - 1 else 0.0
    return psum(join(outs.float() * mask, token), axis, mesh).to(x_mb.dtype)


def gpipe_apply(block_fn: Callable, *, n_microbatches: int, axis: str = "pod", mesh: Optional[Mesh] = None):
    """``fn(params_stack, x)``: the stacked blocks as a pipeline on this rank.

    params_stack: this stage's (L / n_stages, ...) slice of a stack whose L
    the stages divide.  x: (B, ...), the same on every stage, with
    B % n_microbatches == 0.  Returns (B, ...), the same on every stage.
    """

    def fn(params_stack, x):
        B = x.shape[0]
        mb = x.reshape((n_microbatches, B // n_microbatches) + tuple(x.shape[1:]))
        out = pipeline_forward(block_fn, params_stack, mb, axis=axis, mesh=mesh)
        return out.reshape((B,) + tuple(x.shape[1:]))

    return fn
