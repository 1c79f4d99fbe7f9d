"""Device ms a step of the float32 GEMMs on the CUDA cores (the NeRF's f32
island), by kernel name."""
from harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, *readers.F32_GEMM)
