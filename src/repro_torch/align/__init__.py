"""Cross-sensor time alignment and fusion of the port (``align``): delay
estimation, regridding onto one timeline, inverse-variance fusion and the
§V-B validation report, batched on the device."""
from repro_torch.align.delay import (DelayEstimate,  # noqa: F401
                                     delay_scores, estimate_delays,
                                     estimate_delays_host,
                                     make_refbank_host, peak_to_delay,
                                     schedule_reference, stream_reference)
from repro_torch.align.regrid import (SeriesRows, make_grid,  # noqa: F401
                                      regrid_rows, regrid_rows_host,
                                      series_rows_from_traces)
from repro_torch.align.fusion import (DeviceValidation,  # noqa: F401
                                      FusedStream, StreamValidation,
                                      ValidationReport, align_and_fuse,
                                      align_fuse_host,
                                      attribute_energy_fused, default_grid,
                                      fuse_gridded, fuse_gridded_host,
                                      group_traces_by_device,
                                      validate_streams)
