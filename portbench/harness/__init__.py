"""The benchmark's own code: discovery of cells by file name, the seeded
inputs and weights, the timed window, the trace reader, the work counts
(operations and bytes) and the comparison that decides ``correct``."""
