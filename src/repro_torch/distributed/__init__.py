"""The reference's distributed pieces: decode attention in its
single-card form, and the multi-host layer (``multihost``: host
collectives, the spawn harness and the multi-host fused-attribution
entry) with its reduce frame (``compression``)."""
