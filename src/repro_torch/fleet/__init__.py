"""Fleet-scale streaming attribution on the device (port of
``repro.fleet``: typed config, packing and the windowed pipeline)."""
from repro_torch.fleet.config import (CheckpointConfig,  # noqa: F401
                                      PipelineConfig, StreamConfig,
                                      TrackConfig, resolve_config)
from repro_torch.fleet.packing import (ROW_ALIGN, PackedFleet,  # noqa: F401
                                       pack_traces)
from repro_torch.fleet.pipeline import (AlignTrackStage,  # noqa: F401
                                        FusedPhaseAttributeStage,
                                        IngestStage, ReconstructStage,
                                        RegridFuseStage, StreamPipeline,
                                        StreamingFusedPipeline,
                                        attribute_energy_fused_streaming,
                                        pack_stream_rows,
                                        stream_row_windows)
