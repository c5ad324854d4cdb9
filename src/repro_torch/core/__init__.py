"""Paper core: randomized subspace iteration compression (Alg 3.1 + Thm 3.2)."""

from repro_torch.core.bounds import (  # noqa: F401
    CompressionCertificate,
    certify_head,
    certify_tier,
    softmax_jacobian,
    softmax_perturbation_bound,
)
from repro_torch.core.compress import CompressionPolicy, CompressionReport, compress_tree  # noqa: F401
from repro_torch.core.lowrank import (  # noqa: F401
    apply_linear,
    break_even_rank,
    is_lowrank,
    lowrank_params,
    materialize,
    min_rank,
    param_count,
    slice_rank,
)
from repro_torch.core.rsi import (  # noqa: F401
    RSIResult,
    cholesky_qr,
    cholesky_qr2,
    matmul_count,
    rsi,
    rsi_factors,
    rsi_flops,
    rsvd,
)
from repro_torch.core.spectral import (  # noqa: F401
    effective_rank,
    normalized_error,
    normalized_error_factored,
    spectral_norm,
    spectralize_params,
    synth_spectrum_matrix,
    vgg_like_spectrum,
)
