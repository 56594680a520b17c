#!/usr/bin/env python3
"""Time the ROIAlign-backward kernel (K2) on one card, at the train step's shapes.

    python3 k2_bench.py [--tree DIR ...] [--ablate]

The shapes and inputs are those of ``chip_smoke.py`` phase 5 (``BWD_CASES``: the
student pass's 48 x 512 and burn-in's 32 x 512 ROIs on 38 x 84 x 512 maps, bf16,
40 zero gradient rows per image). Each time is the mean of 10 launches after 2
(CUDA events).

- ``--tree DIR``: also time the K2 of the checkout at DIR, through its own
  ``roi_align_cuda.roi_align_backward``. Each turn is a process of its own that
  builds that checkout's kernel; the turns go DIR ..., this checkout twice, then
  DIR ... backwards, so that a drift of the card falls on both sides.
- ``--ablate``: time this checkout's kernel built with ``-DK2_ABLATE=1`` (no
  loads of g) and ``-DK2_ABLATE=2`` (no accumulator adds) beside the full
  kernel, in one process: where the time goes. Those results are wrong.

Prints one JSON line per time, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _smoke():
    """This checkout's ``chip_smoke``, for its shapes, inputs and timer; its imports
    of the package resolve to whichever checkout is first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("k2_bench_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(smoke, dev, n: int, r: int):
    import torch
    h, w, c = smoke.FEAT
    gen = torch.Generator(device=dev).manual_seed(7)
    boxes = smoke.roi_boxes(torch.Generator().manual_seed(7), n, r, h, w).to(dev)
    g = torch.randn(n, r, 7, 7, c, generator=gen, device=dev).to(torch.bfloat16)
    g[:, r - 40:] = 0
    return g, boxes, (n, h, w, c)


def time_tree(tree: Path) -> None:
    """In this process: build the K2 of the checkout at ``tree`` and time it."""
    sys.path.insert(0, str(tree))
    import torch
    from probabilisticteacher_torch.ops import _build, roi_align_cuda
    smoke = _smoke()
    _build.build([roi_align_cuda.BWD_KERNEL])
    dev = torch.device("cuda")
    for label, n, r in smoke.BWD_CASES:
        g, boxes, shape = _inputs(smoke, dev, n, r)
        ms = smoke.cuda_ms(lambda: roi_align_cuda.roi_align_backward(
            g, boxes, shape, torch.bfloat16, 1.0 / 16, 7, 2), reps=10)
        print("K2BENCH " + json.dumps({"case": label, "rois": [n, r], "ms": ms}), flush=True)


def run_turn(label: str, tree: Path, script: str = "k2_bench.py", tag: str = "K2BENCH") -> list:
    """Run ``script --time tree`` in a process of its own, from ``tree``; print and
    return the rows it printed after ``tag``, each labelled with the turn."""
    proc = subprocess.run([sys.executable, str(ROOT / script), "--time", str(tree)],
                          cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{script}: the turn of {tree} failed (exit {proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rows = [json.loads(line[len(tag) + 1:]) for line in proc.stdout.splitlines()
            if line.startswith(tag + " ")]
    for row in rows:
        row["tree"] = label
        print(json.dumps(row), flush=True)
    return rows


def run_turns(trees, script: str = "k2_bench.py", tag: str = "K2BENCH") -> None:
    """The other checkouts, this one twice, the others backwards; then each tree's
    times per case."""
    others = [(str(t), Path(t).resolve()) for t in trees]
    turns = others + [("this", ROOT), ("this", ROOT)] + others[::-1]
    rows = []
    for label, tree in turns:
        rows += run_turn(label, tree, script, tag)
    for label in dict(turns):
        for case in {row["case"]: None for row in rows}:
            ms = [row["ms"] for row in rows if row["tree"] == label and row["case"] == case]
            print(json.dumps({"summary": label, "case": case, "ms": ms}), flush=True)


def print_card() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)


def ablate() -> None:
    """This checkout's K2 in full and with parts of its work taken out."""
    sys.path.insert(0, str(ROOT))
    import torch
    from probabilisticteacher_torch.ops import _build, roi_align_cuda
    from probabilisticteacher_torch.ops._build import CudaKernel
    smoke = _smoke()
    full = roi_align_cuda.BWD_KERNEL
    variants = {"full": full}
    for k, what in ((1, "no_g_loads"), (2, "no_adds")):
        variants[what] = CudaKernel(full.source, full.symbol, full.argtypes,
                                    (f"-DK2_ABLATE={k}",))
    _build.build(list(variants.values()))
    dev = torch.device("cuda")
    for label, n, r in smoke.BWD_CASES:
        g, boxes, shape = _inputs(smoke, dev, n, r)
        for what in ("full", "no_g_loads", "no_adds", "full"):
            roi_align_cuda.BWD_KERNEL = variants[what]
            ms = smoke.cuda_ms(lambda: roi_align_cuda.roi_align_backward(
                g, boxes, shape, torch.bfloat16, 1.0 / 16, 7, 2), reps=10)
            print(json.dumps({"ablate": what, "case": label, "rois": [n, r], "ms": ms}),
                  flush=True)
        roi_align_cuda.BWD_KERNEL = full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="root of another checkout")
    ap.add_argument("--ablate", action="store_true", help="time the kernel with parts taken out")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time:
        time_tree(Path(args.time))
        return 0
    run_turns(args.tree)
    if args.ablate:
        ablate()
    print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
