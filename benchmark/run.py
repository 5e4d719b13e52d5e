"""Run one benchmark cell of genome_assembler_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``, each number compared beside
its limit, which also end standard error. Exits non-zero without a
result where CUDA or the cards are missing, and where a module of JAX or
of the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")  # fixed, inside the checkout


def _pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a checkout's first run builds."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

    from harness import cells, guard

    cell = cells.find_cell(cells.load_benchmark(ROOT), args.workload)
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    steps = {"python_and_harness": t - T0,
             "torch_import": time.perf_counter() - t}
    from harness import runner

    result, lines = runner.run(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T0, steps)
    loaded = guard.forbidden_modules(list(sys.modules))
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
