"""Delay estimation of the port (``align.delay``)."""
from repro_torch.align.delay import (DelayEstimate,  # noqa: F401
                                     delay_scores, estimate_delays,
                                     peak_to_delay, stream_reference)
