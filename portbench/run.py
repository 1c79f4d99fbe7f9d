#!/usr/bin/env python3
"""Run one cell of the benchmark of custom_diffusion360_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (weights from the seed, inputs, the warm-up of every shape)
is timed as ``setup_s``; then a closed loop of one client runs requests or
steps for ``--seconds``; with ``--trace 1`` a synchronised unit gives the
spans and a profiled one the device trace. Then the program's state is
freed and the plain reference checks what the timed path produced. The
last line on standard output is the result (JSON); the last lines on
standard error are the numbers compared, each beside its limit.

Exits 2 without enough CUDA cards, and 3 if JAX or the JAX package was
loaded into this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "custom_diffusion360_tpu")


def environment():
    """The program at its defaults, with its caches inside the checkout."""
    for var in ("CD360_VAE_CONV", "CD360_ATTN_BNHD", "CD360_CFG3_DEDUPE", "CD360_PREFIX_DEDUPE"):
        os.environ.pop(var, None)
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / ".cache" / "torch_extensions")
    for p in (str(CHECKOUT), str(BENCH_DIR)):  # the benchmark's own modules first
        while p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import torch

    from harness import cell, spec

    chips = int(spec.workload(args.workload, BENCH_DIR)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                        BENCH_DIR, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    cell.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
