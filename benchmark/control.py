"""The control of a cell's check, at the cell's own size, on a card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's reads, the reference's answer, and the
control's (the reference with the nearest lower precision of its keys,
``control`` in the configuration's reference module) held to it by the
same ``compare`` that judges the program. Prints one JSON line a seed
with each number compared, its limit, and whether the control failed
it; a control that passes every limit exits non-zero. The benchmark's
own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE]
    from harness import cells, generate

    cell = cells.find_cell(cells.load_benchmark(ROOT), args.workload)
    ref = cells.load_module("references", cell.config["reference"])
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        reads = generate.make_reads(cell.config, cell.traffic, seed,
                                    args.device)
        want = ref.answer(reads, cell.config, args.device)
        t_ref = time.perf_counter() - t
        lossy = ref.control(reads, cell.config, args.device)
        got = ref.compare(lossy.contigs,
                          [(s, e, c) for s, (e, c) in lossy.unitigs.items()],
                          want)
        failed = any(got[n] > lim for n, lim in ref.LIMITS.items())
        failed_all = failed_all and failed
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "reads": int(reads.shape[0]),
            "contigs": len(want.contigs),
            "readings": {n: {"value": got[n], "limit": lim}
                         for n, lim in ref.LIMITS.items()},
            "control_failed": failed,
            "reference_s": t_ref,
            "total_s": time.perf_counter() - t,
        }), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
