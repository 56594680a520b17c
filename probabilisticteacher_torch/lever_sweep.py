"""A/B of the opt-in levers through the bench worker (the port of ``scripts/lever_sweep.py``).

    python -m probabilisticteacher_torch.lever_sweep [COMBO ...] [--out PATH]

Runs ``python -m probabilisticteacher_torch.bench --worker --iters 8 --windows 3`` once
per lever combination of :data:`COMBOS` (the JAX script's combinations, names and
worker arguments), one after another on one card, each in its own process under a
time limit, and writes every record to ``--out`` (``docs/lever_sweep_torch.json`` by
default; never ``docs/lever_sweep_r3.json``, the JAX package's record) as it comes.
Every run measures each combination it is asked for and starts its file afresh, so
the file holds the records of one run only. A combination whose worker crashes,
times out or prints no record is recorded with its error and no value, and the
sweep then exits non-zero. The last line of standard output is one JSON
object of each combination's img/s (null where it failed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

from . import bench

OUT = os.path.join(bench.REPO, "docs", "lever_sweep_torch.json")
JAX_RECORD = os.path.join(bench.REPO, "docs", "lever_sweep_r3.json")
WORKER_ARGS = ("--iters", "8", "--windows", "3")
TIMEOUT_S = 2400.0

COMBOS = [
    # (name, extra worker args)
    ("baseline_exact", []),
    ("hybrid", ["--nms-impl", "hybrid"]),
    ("teacher1000", ["--teacher-pre", "6000", "--teacher-post", "1000"]),
    ("hybrid_teacher1000", ["--nms-impl", "hybrid",
                            "--teacher-pre", "6000", "--teacher-post", "1000"]),
    ("hybrid_teacher500", ["--nms-impl", "hybrid",
                           "--teacher-pre", "3000", "--teacher-post", "500"]),
    ("hybrid_teacher1000_cand2048", ["--nms-impl", "hybrid",
                                     "--teacher-pre", "6000",
                                     "--teacher-post", "1000",
                                     "--teacher-cand", "2048"]),
    # teacher-side levers only: the student's training path is unchanged
    ("teacher1000_cand2048", ["--teacher-pre", "6000", "--teacher-post", "1000",
                              "--teacher-cand", "2048"]),
    # a pre-NMS budget cut (score ranking alone, no geometry approximation)
    ("combo_safe", ["--pre-topk", "4000",
                    "--teacher-pre", "4000", "--teacher-post", "1000",
                    "--teacher-cand", "2048"]),
    # the hybrid prefilter with the same budgets
    ("combo_hybrid_safe", ["--nms-impl", "hybrid", "--pre-topk", "4000",
                           "--teacher-pre", "4000", "--teacher-post", "1000",
                           "--teacher-cand", "2048"]),
]


def sweep(only: Optional[Sequence[str]] = None, out_path: str = OUT,
          worker_args: Sequence[str] = WORKER_ARGS, timeout_s: float = TIMEOUT_S) -> dict:
    """Run each combination of :data:`COMBOS` (those in ``only`` if given) and return
    the records by name, written afresh to ``out_path`` after each one."""
    if os.path.abspath(out_path) == os.path.abspath(JAX_RECORD):
        raise ValueError(f"{out_path} is the JAX package's record; the port writes its own")
    results = {}
    for name, extra in COMBOS:
        if only and name not in only:
            continue
        args = list(worker_args) + extra
        print(f"[sweep] {name}: bench --worker {' '.join(args)}", flush=True)
        t0 = time.time()
        try:
            rec = bench.spawn_worker(args, timeout_s)
        except bench.ChildFailed as e:
            rec = {"error": str(e)}
        rec["wall_s"] = round(time.time() - t0, 1)
        results[name] = rec
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[sweep] {name}: {rec.get('value')} img/s (windows {rec.get('windows')}, "
              f"wall {rec['wall_s']} s){'; FAILED: ' + rec['error'] if 'error' in rec else ''}",
              flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m probabilisticteacher_torch.lever_sweep",
                                description="A/B of the opt-in levers on one card")
    p.add_argument("combos", nargs="*", help="names of COMBOS to run (default: all)")
    p.add_argument("--out", default=OUT, help="the record (JSON, one entry a combination)")
    args = p.parse_args(argv)
    unknown = set(args.combos) - {name for name, _ in COMBOS}
    if unknown:
        p.error(f"unknown combinations {sorted(unknown)}")
    results = sweep(args.combos or None, args.out)
    print(json.dumps({k: v.get("value") for k, v in results.items()}))
    ran = args.combos or [name for name, _ in COMBOS]
    return 1 if any("error" in results[name] for name in ran) else 0


if __name__ == "__main__":
    sys.exit(main())
