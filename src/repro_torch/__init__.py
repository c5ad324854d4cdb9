"""PyTorch/CUDA port of the RSI low-rank compression system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``configs``, ``kernels``, ``runtime``, ``core``,
``models``, ``train``, ``checkpoint``, ``data``, ``launch``) so each module's counterpart is
found under the same name.  It imports torch and numpy only — never jax and
nothing of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card and no explicit CPU device they raise.
"""

from repro_torch.runtime.device import resolve_device  # noqa: F401
