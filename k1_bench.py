#!/usr/bin/env python3
"""Time the ROIAlign-forward kernel (K1) on one card, at the inference and train step's shapes.

    python3 k1_bench.py [--tree DIR ...] [--ablate]
    python3 k1_bench.py --profile detect,pseudo_labels,burnin_step,mutual_step [--tree DIR ...]

The shapes and inputs are those of ``chip_smoke.py`` phase 2: (8, 2000) ROIs at
batch 8 (``pseudo_labels``), then ``FWD_STEP_CASES`` (the student pass's
48 x 512 and the teacher pass's 16 x 2000 ROIs), on 38 x 84 x 512 bf16 maps,
boxes from ``roi_boxes``. Each time is the mean of 20 launches after 2 (CUDA
events).

- ``--tree DIR``: also time the K1 of the checkout at DIR, through its own
  ``roi_align_cuda.roi_align_forward``, in turns with this checkout's (DIR ...,
  this twice, DIR ... backwards; ``k2_bench.run_turns``).
- ``--ablate``: time this checkout's kernel built with ``-DK1_ABLATE=1`` (no
  loads of the map), ``-DK1_ABLATE=2`` (no output stores) and ``-DK1_ABLATE=3``
  (no contraction: the tables, then zeros stored) beside the full kernel, in one
  process, and count the ``LDG``/``STG`` instructions of each
  build's kernels in ``cuobjdump -sass``, to show that the compiler kept what
  each build should keep. Those results are wrong.
- ``--profile PATHS``: run this checkout's ``profile_slice`` (comma-separated
  paths of ``detect``, ``pseudo_labels``, ``burnin_step``, ``mutual_step``)
  over this checkout's package, then over each ``--tree``'s, a process each, so
  that K1's time inside the steps (``roi_align_fwd_ms``) is read the same way
  for both.

Prints one JSON line per time, per SASS count and per profiled path (labelled by
its tree), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

from k2_bench import ROOT, _smoke, print_card, run_turns

REPS = 20


def _cases(smoke):
    return (("inference", smoke.N, 2000), *smoke.FWD_STEP_CASES)


def _inputs(smoke, dev, n: int, r: int):
    import torch
    h, w, c = smoke.FEAT
    gen = torch.Generator().manual_seed(1)
    boxes = smoke.roi_boxes(gen, n, r, h, w).to(dev)
    feat = torch.randn(n, h, w, c, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev).to(torch.bfloat16)
    return feat, boxes


def time_tree(tree: Path) -> None:
    """In this process: build the K1 of the checkout at ``tree`` and time it."""
    sys.path.insert(0, str(tree))
    import torch
    from probabilisticteacher_torch.ops import _build, roi_align_cuda
    smoke = _smoke()
    _build.build([roi_align_cuda.KERNEL])
    dev = torch.device("cuda")
    for label, n, r in _cases(smoke):
        feat, boxes = _inputs(smoke, dev, n, r)
        ms = smoke.cuda_ms(lambda: roi_align_cuda.roi_align_forward(feat, boxes, 1.0 / 16, 7, 2),
                           reps=REPS)
        print("K1BENCH " + json.dumps({"case": label, "rois": [n, r], "ms": ms}), flush=True)
        del feat, boxes


def sass_counts(library: Path, nvcc: str) -> dict:
    """``LDG``/``STG`` instructions of each ``roi_align_fwd_kernel`` in ``library``."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "roi_align_fwd_kernel" in m.group(1) else None
            if name:
                out[name] = {"LDG": 0, "STG": 0}
        elif name:
            for op in ("LDG", "STG"):
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
    return out


def ablate() -> None:
    """This checkout's K1 in full and with parts of its work taken out."""
    sys.path.insert(0, str(ROOT))
    import torch
    from probabilisticteacher_torch.ops import _build, roi_align_cuda
    from probabilisticteacher_torch.ops._build import CudaKernel
    smoke = _smoke()
    full = roi_align_cuda.KERNEL
    variants = {"full": full}
    for k, what in ((1, "no_map_loads"), (2, "no_stores"), (3, "no_contraction")):
        variants[what] = CudaKernel(full.source, full.symbol, full.argtypes,
                                    (f"-DK1_ABLATE={k}",))
    _build.build(list(variants.values()))
    nvcc = _build.nvcc_path()
    for what, kernel in variants.items():
        for fn, counts in sass_counts(kernel.library_path(), nvcc).items():
            print(json.dumps({"sass": what, "function": fn, **counts}), flush=True)
    dev = torch.device("cuda")
    for label, n, r in _cases(smoke):
        feat, boxes = _inputs(smoke, dev, n, r)
        for what in ("full", "no_map_loads", "no_stores", "no_contraction", "full"):
            roi_align_cuda.KERNEL = variants[what]
            ms = smoke.cuda_ms(lambda: roi_align_cuda.roi_align_forward(
                feat, boxes, 1.0 / 16, 7, 2), reps=REPS)
            print(json.dumps({"ablate": what, "case": label, "rois": [n, r], "ms": ms}),
                  flush=True)
        roi_align_cuda.KERNEL = full
        del feat, boxes


def profile_tree(tree: Path, paths: str) -> None:
    """In this process: this checkout's ``profile_slice`` over the package of the
    checkout at ``tree`` (loaded as a module of that package)."""
    sys.path.insert(0, str(tree))
    import probabilisticteacher_torch as pkg
    spec = importlib.util.spec_from_file_location(
        f"{pkg.__name__}._k1_bench_profile", ROOT / pkg.__name__ / "profile_slice.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.main(["--paths", paths]) != 0:
        raise SystemExit("k1_bench: profile_slice failed")


def run_profiles(trees, paths: str) -> None:
    for label, tree in [("this", ROOT)] + [(str(t), Path(t).resolve()) for t in trees]:
        proc = subprocess.run([sys.executable, str(ROOT / "k1_bench.py"), "--profile-tree",
                               str(tree), "--profile", paths], cwd=tree, capture_output=True,
                              text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"k1_bench: the profile of {tree} failed (exit {proc.returncode}):"
                             f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            print(json.dumps({"profile_tree": label, **json.loads(line)}) if line.startswith("{")
                  else line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="root of another checkout")
    ap.add_argument("--ablate", action="store_true", help="time the kernel with parts taken out")
    ap.add_argument("--profile", metavar="PATHS",
                    help="profile_slice paths, over this tree and each --tree")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--profile-tree", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time:
        time_tree(Path(args.time))
        return 0
    if args.profile_tree:
        profile_tree(Path(args.profile_tree), args.profile)
        return 0
    if args.profile:
        run_profiles(args.tree, args.profile)
        print_card()
        return 0
    run_turns(args.tree, "k1_bench.py", "K1BENCH")
    if args.ablate:
        ablate()
    print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
