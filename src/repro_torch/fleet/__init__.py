"""Fleet-scale attribution on the device (port of ``repro.fleet``: typed
config, packing, whole-fleet reconstruction, the two-stage fleet streams,
the windowed pipeline, the fused-scan engine and the trace-level API)."""
from repro_torch.fleet.config import (CheckpointConfig,  # noqa: F401
                                      PipelineConfig, StreamConfig,
                                      TrackConfig, resolve_config)
from repro_torch.fleet.packing import (ROW_ALIGN, PackedFleet,  # noqa: F401
                                       pack_traces, unpack_series)
from repro_torch.fleet.reconstruct import (fleet_reconstruct,  # noqa: F401
                                           fleet_reconstruct_host)
from repro_torch.fleet.streaming import (FleetStream,  # noqa: F401
                                         StreamingPhaseAccumulator)
from repro_torch.fleet.pipeline import (AlignTrackStage,  # noqa: F401
                                        CounterAttributeStage,
                                        DataQualityError,
                                        DataQualityPolicy,
                                        FusedPhaseAttributeStage,
                                        IngestStage, MeteringStage,
                                        PhaseIntegrateStage,
                                        ReconstructStage,
                                        RegridFuseStage, SlotSegment,
                                        StreamPipeline,
                                        StreamingFusedPipeline,
                                        attribute_energy_fused_streaming,
                                        pack_stream_rows,
                                        stream_row_windows)
from repro_torch.fleet.scan import (ScanResult,  # noqa: F401
                                    attribute_totals_fused_scan)
from repro_torch.fleet.api import (attribute_energy_fleet,  # noqa: F401
                                   attribute_energy_fused,
                                   fleet_power_series)
