"""Host-side utilities of the port: image and style-matrix IO, checkpoints,
the iteration counter, the source snapshot, parameter counts, profiling."""
