"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the NVIDIA cards the cell asks for.
It prints the card, its power limit and the decoder on earlier lines, and as its
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared with its limit, which also close standard error. It exits
with another code than 0, and prints no result, without the cards, where the
program is not beside it, or where JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT_NS = time.time_ns()
BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(BENCH, ".cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path[:0] = [BENCH, REPO]

    from harness.cells import load_cell
    from harness import runner

    t_start = runner.process_start_ns() or T_IMPORT_NS
    cell = load_cell(os.path.join(REPO, "BENCHMARK.json"), args.workload, BENCH)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"card: {runner.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    line = runner.run_cell(cell, REPO, args.seed, args.seconds, bool(args.trace), "cuda",
                           t_start, log=lambda s: print(s, flush=True))
    found = runner.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
