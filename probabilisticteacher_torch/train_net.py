"""Training entry point of the PyTorch port, CLI-compatible with the root ``train_net.py``.

    python -m probabilisticteacher_torch.train_net --config-file configs/pt/final_c2f.yaml \
        [--resume] [--eval-only] [--num-gpus 1] [--supervise] KEY VALUE [KEY VALUE ...]

It reads the repo's ``configs/pt/*.yaml`` unchanged and runs on one card
(``MODEL.DEVICE cpu`` runs on the CPU). Data parallel over several cards is not
ported yet: ``--num-gpus`` other than 1, ``--num-machines`` above 1 and a
``COORDINATOR_ADDRESS`` raise ``NotImplementedError`` (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

DATA_PARALLEL_ITEM = "ROADMAP A12"


def setup(args):
    from probabilisticteacher_torch.config import add_config, get_cfg

    cfg = get_cfg()
    add_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()

    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(name)s %(levelname)s: %(message)s",
        handlers=[
            logging.StreamHandler(sys.stdout),
            logging.FileHandler(os.path.join(cfg.OUTPUT_DIR, "log.txt")),
        ],
        force=True,
    )
    return cfg


def supervise(argv):
    """Relaunch-on-tempfail supervisor (``--supervise``).

    Runs the training CLI as a child process and restarts it with ``--resume``
    whenever it exits with code 75, the checkpoint-and-exit code of
    ``MemoryGuardHook`` when host RSS crosses ``SOLVER.HOST_RSS_LIMIT_GB``. Any
    other exit code is final.
    """
    import subprocess

    child = [sys.executable, "-m", "probabilisticteacher_torch.train_net"] + [
        a for a in argv if a != "--supervise"]
    attempt = 0
    while True:
        cmd = list(child)
        if attempt > 0 and "--resume" not in cmd:
            # insert BEFORE the positional KEY VALUE opts: ``opts`` is
            # nargs=REMAINDER, so an appended flag would be swallowed into the
            # override list
            cmd.insert(3, "--resume")
        rc = subprocess.call(cmd)
        if rc != 75:
            return rc
        attempt += 1
        print(f"[supervise] child hit the memory guard (exit 75); "
              f"restart #{attempt} with --resume", flush=True)


def check_single_device(args) -> None:
    """One process on one card; the data-parallel launch is not ported yet."""
    if args.num_machines > 1 or os.environ.get("COORDINATOR_ADDRESS"):
        raise NotImplementedError(
            f"multi-machine training is not ported yet ({DATA_PARALLEL_ITEM}); "
            f"run one process with --num-machines 1 and no COORDINATOR_ADDRESS")
    if args.num_gpus is not None and args.num_gpus != 1:
        raise NotImplementedError(
            f"--num-gpus {args.num_gpus}: data parallel over several cards is not ported "
            f"yet ({DATA_PARALLEL_ITEM}); the port trains on one card")


def main(args):
    check_single_device(args)
    cfg = setup(args)

    from probabilisticteacher_torch.engine.trainer import PTrainer

    if cfg.UNSUPNET.Trainer != "pt":
        raise ValueError(f"Unknown trainer: {cfg.UNSUPNET.Trainer}")
    trainer = PTrainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        res = trainer.test(trainer.state.student)
        print(res)
        return res
    return trainer.train()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Probabilistic Teacher (PyTorch port)")
    parser.add_argument("--config-file", "--config", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=None,
                        help="accepted for CLI parity; only 1 is supported")
    parser.add_argument("--supervise", action="store_true",
                        help="restart-on-memory-guard supervisor (exit 75 -> "
                             "relaunch with --resume); see SOLVER.HOST_RSS_LIMIT_GB")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument("opts", default=[], nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


if __name__ == "__main__":
    if "--supervise" in sys.argv[1:]:
        sys.exit(supervise(sys.argv[1:]))
    main(parse_args())
