"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress and the numbers it compared on standard error, and as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with --trace 1
its per-layer ones), ``device``, with --trace 1 ``breakdown``, and last the
``check`` numbers beside their limits. Exits non-zero, printing no result,
without a CUDA device (or with fewer than the cell asks for), when the port
is missing, or when the serving process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches inside the checkout, at fixed paths; transformers (if
    # anything loads it) without its JAX backend
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)

    import torch
    from bench_port import serve, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    try:
        result = serve.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), device="cuda",
                                t_start=T_START, cell_spec=cell)
    except ImportError as e:
        print(f"forbidden or missing module: {e}", file=sys.stderr)
        return 3
    line = json.dumps(result)
    bad = serve.forbidden_modules()           # once more, just before printing
    if bad:
        print(f"forbidden module loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
