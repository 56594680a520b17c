"""The readings that the limits of ``correct`` are set from, on the card at a cell's
own size (the benchmark's own runs never run this):

- the program against the reference on each of ``--seeds`` (sound runs: the lower
  readings);
- the control, the reference computed with its convolution and matmul operands in
  fp8 e4m3, against the reference in f32, on each of ``--control`` (the upper
  readings);
- the program with a fault planted underneath its step (``FAULTS``) against the
  reference, on each seed given to ``--faults FAULT:SEED,...``.

    python3 benchmark/calibrate.py --workload c2f_mutual --seeds 1,2,3 --control 1,2,3 \\
        --faults wrong_lr:1,2,3 [--out readings.jsonl]

Each reading is one JSON line on standard output (and in ``--out``): every number of
``harness/check.py`` that the cell's phase has.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)

FAULTS = ("frozen_state", "frozen_ema", "half_batch", "altered_batch", "wrong_lr")
WRONG_LR = 1.25     # the learning rate off by a quarter


def plant_fault(trainer, fault: str) -> None:
    """Break the timed path underneath a built trainer:

    - ``frozen_state``: a step that returns the student and its momentum unchanged;
    - ``frozen_ema``: the EMA teacher left unchanged after the copy at BURN_UP_STEP;
    - ``half_batch``: half of the batch left out, the mean taken over the rest;
    - ``altered_batch``: a band of each labeled canvas overwritten after the loader
      made it;
    - ``wrong_lr``: the learning rate ``WRONG_LR`` times the schedule's.
    """
    import torch

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "wrong_lr":
        opt = trainer.state.optimizer
        sched = opt.lr_schedule
        opt.lr_schedule = lambda count: WRONG_LR * sched(count)
        return
    burn_up = int(trainer.cfg.UNSUPNET.BURN_UP_STEP)

    def halve(x):
        return type(x)(*(t[: t.shape[0] // 2] for t in x))

    def wrap(step):
        def run(state, limg, lgt, *rest):
            if fault == "frozen_state":
                params = [p for g in state.optimizer.param_groups for p in g["params"]]
                saved = [p.detach().clone() for p in params]
                out = step(state, limg, lgt, *rest)
                with torch.no_grad():
                    for p, s in zip(params, saved):
                        p.copy_(s)
                    for p in params:
                        state.optimizer.state[p]["trace"].zero_()
                return out
            if fault == "frozen_ema":
                keep = None if state.step == burn_up else [
                    t.detach().clone() for t in state.teacher.parameters()]
                out = step(state, limg, lgt, *rest)
                if keep is not None:
                    with torch.no_grad():
                        for t, s in zip(state.teacher.parameters(), keep):
                            t.copy_(s)
                return out
            if fault == "half_batch":
                if len(rest) == 2:
                    return step(state, halve(limg), halve(lgt), halve(rest[0]), rest[1])
                return step(state, halve(limg), halve(lgt), *rest)
            limg.image[:, :8] = 255          # altered_batch
            return step(state, limg, lgt, *rest)
        return run

    trainer.burnin_step, trainer.mutual_step = wrap(trainer.burnin_step), wrap(trainer.mutual_step)


@contextlib.contextmanager
def planted(fault: str):
    """Every trainer that the harness builds inside the block has ``fault`` planted."""
    from probabilisticteacher_torch.engine import trainer as trainer_mod

    real = trainer_mod.PTrainer

    class Faulty(real):
        def __init__(self, cfg):
            super().__init__(cfg)
            plant_fault(self, fault)

    trainer_mod.PTrainer = Faulty
    try:
        yield
    finally:
        trainer_mod.PTrainer = real


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", action="append", default=[],
                   help="FAULT:SEED,SEED,... (repeatable)")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [BENCH, REPO]
    from harness import check, runner
    from harness.cells import load_cell

    cell = load_cell(os.path.join(REPO, "BENCHMARK.json"), args.workload, BENCH)
    names = [n for n in check.NUMBERS
             if cell.traffic["phase"] == "mutual" or n not in check.MUTUAL_ONLY]
    out = open(args.out, "a") if args.out else None
    faults = {}
    for f in args.faults:
        name, seeds = f.split(":")
        for s in _ints(seeds):
            faults.setdefault(s, []).append(name)
    seeds = sorted(set(_ints(args.seeds)) | set(_ints(args.control)) | set(faults))

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        res = runner.run_program(cell, REPO, seed, args.seconds, False, args.device,
                                 time.time_ns())
        t_ref = time.perf_counter()
        ref = runner.run_reference(cell, res["p0"], res["trees"], seed, args.device,
                                   res["start_iter"])
        ref_s = time.perf_counter() - t_ref
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              "numbers": check.compare(res["capture"], ref, names), "reference_s": ref_s,
              "setup_s": res["setup_s"]})
        if seed in _ints(args.control):
            ctl = runner.run_reference(cell, res["p0"], res["trees"], seed, args.device,
                                       res["start_iter"], control=True)
            emit({"workload": args.workload, "seed": seed, "kind": "control",
                  "numbers": check.compare(ctl, ref, names)})
        for fault in faults.get(seed, []):
            with planted(fault):
                bad = runner.run_program(cell, REPO, seed, args.seconds, False, args.device,
                                         time.time_ns())
            emit({"workload": args.workload, "seed": seed, "kind": "fault:" + fault,
                  "numbers": check.compare(bad["capture"], ref, names)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
