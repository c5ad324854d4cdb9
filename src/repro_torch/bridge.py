"""Weight bridge: the reference's params, as numpy arrays, to the port's tensors.

Takes a nested dict of numpy arrays (``jax.device_get`` of a JAX params
pytree, for instance) and returns the same tree of torch tensors on
``device``, keeping the factored ``{"a","b"}`` leaves and the stacked
``(L, ...)`` layer axes as they are.  bfloat16 arrays (numpy's ``ml_dtypes``
bfloat16, which ``torch.from_numpy`` rejects) cross bit-exactly through a
``uint16`` view.  The bridge imports neither jax nor the reference.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device

__all__ = ["tensor_from_numpy", "params_from_numpy", "tensor_to_numpy"]


def tensor_from_numpy(arr: Any, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """One array -> tensor; bf16 bit-exact via a uint16 view."""
    dev = resolve_device(device)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev)


def params_from_numpy(tree: Any, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Nested dict of arrays -> the same nested dict of tensors on ``device``."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> float32 (or integer) numpy array for comparisons."""
    t = t.detach().cpu()
    if t.is_floating_point():
        t = t.float()
    return t.numpy()
