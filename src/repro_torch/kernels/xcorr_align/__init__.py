"""Fleet-wide normalized cross-correlation against a lag bank."""
from repro_torch.kernels.xcorr_align.kernel import (  # noqa: F401
    xcorr_align_kernel)
from repro_torch.kernels.xcorr_align.ops import (LAG_ALIGN,  # noqa: F401
                                                 ROW_ALIGN, make_refbank,
                                                 xcorr_scores)
from repro_torch.kernels.xcorr_align.ref import xcorr_scores_ref  # noqa
