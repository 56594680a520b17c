"""Training entry point of the PyTorch port, CLI-compatible with the root ``train_net.py``.

    python -m probabilisticteacher_torch.train_net --config-file configs/pt/final_c2f.yaml \
        [--resume] [--eval-only] [--num-gpus N] [--num-machines M --machine-rank R \
        --dist-url tcp://HOST:PORT] [--supervise] KEY VALUE [KEY VALUE ...]

It reads the repo's ``configs/pt/*.yaml`` unchanged and runs on the card
(``MODEL.DEVICE cpu`` runs on the CPU). Data parallel is launched as detectron2's
``launch`` does it for the reference (``train_net.py:90-97``): ``--num-gpus N``
starts N ranks on this machine, one per card (N gloo ranks with ``MODEL.DEVICE
cpu``), and ``--num-machines``, ``--machine-rank`` and ``--dist-url`` join
several machines (``--dist-url auto`` is a free local port, one machine only).
``COORDINATOR_ADDRESS`` (``HOST:PORT``) keeps its JAX meaning, the coordinator of
a multi-machine run: it stands in for an ``auto`` URL. A ``torchrun`` environment
(``WORLD_SIZE`` set) is taken as it is: this process is one rank. ``--num-gpus N``
with fewer than N cards, and batch sizes the ranks do not divide, raise before
anything is written.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import sys


def load_config(args):
    """The frozen config of ``args``, with no side effect."""
    from probabilisticteacher_torch.config import add_config, get_cfg

    cfg = get_cfg()
    add_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def setup(args, rank: int = 0):
    """The config, OUTPUT_DIR and logging: rank 0 logs to stdout and ``log.txt``,
    another rank to ``log.txt.rank<r>`` only."""
    cfg = load_config(args)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    handlers = [logging.FileHandler(os.path.join(
        cfg.OUTPUT_DIR, "log.txt" if rank == 0 else f"log.txt.rank{rank}"))]
    if rank == 0:
        handlers.append(logging.StreamHandler(sys.stdout))
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(name)s %(levelname)s: %(message)s",
                        handlers=handlers, force=True)
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


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _master(args):
    """(address, port) of rank 0's rendezvous."""
    url = args.dist_url
    if url == "auto" and os.environ.get("COORDINATOR_ADDRESS"):
        url = "tcp://" + os.environ["COORDINATOR_ADDRESS"]
    if url == "auto":
        if args.num_machines != 1:
            raise ValueError("--dist-url auto works on one machine only; give "
                             "tcp://HOST:PORT of machine 0")
        return "127.0.0.1", _free_port()
    host, port = url.split("://", 1)[-1].rsplit(":", 1)
    return host, int(port)


def _rank_entry(local_rank, args, ranks_per_machine, world, master, results):
    """One spawned rank: its place in the group goes into the environment that
    ``parallel.mesh.make_mesh`` reads, then it runs :func:`main` as a rank."""
    os.environ.update(RANK=str(args.machine_rank * ranks_per_machine + local_rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      MASTER_ADDR=master[0], MASTER_PORT=str(master[1]))
    res = main(args)
    if int(os.environ["RANK"]) == 0:
        results.put(res)


def launch(args, ranks_per_machine: int, world: int):
    """Start this machine's ranks (``spawn``: a rank initializes CUDA itself) and
    wait for them. A rank that fails ends the others and the launch; a rank's exit
    code (75 from the memory guard) becomes the launch's. Returns rank 0's result."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(_rank_entry, nprocs=ranks_per_machine, join=False,
                               start_method="spawn",
                               args=(args, ranks_per_machine, world, _master(args), results))
    out = None
    try:
        while not procs.join(timeout=1):
            while not results.empty():
                out = results.get()
    except mp.ProcessExitedException as e:
        raise SystemExit(e.exit_code) from e
    while not results.empty():
        out = results.get()
    return out


def main(args):
    cfg = load_config(args)
    ranks_per_machine = 1 if args.num_gpus is None else args.num_gpus
    world = ranks_per_machine * args.num_machines
    if "WORLD_SIZE" not in os.environ:
        if ranks_per_machine < 1 or args.num_machines < 1:
            raise SystemExit("--num-gpus and --num-machines must be at least 1")
        if args.num_gpus is not None and str(cfg.MODEL.DEVICE).lower() != "cpu":
            import torch

            n = torch.cuda.device_count()
            if ranks_per_machine > n:
                # a user asking for N cards must not silently get another machine
                # shape: raise before OUTPUT_DIR or any weight is touched
                raise SystemExit(f"--num-gpus {ranks_per_machine} requested but {n} CUDA "
                                 f"device(s) are visible")
    from probabilisticteacher_torch.engine.trainer import PTrainer, data_parallel_size

    env_world = int(os.environ.get("WORLD_SIZE", world))
    n_use = data_parallel_size(cfg, env_world)
    if "WORLD_SIZE" not in os.environ and world > 1:
        return launch(args, ranks_per_machine, world)

    rank = int(os.environ.get("RANK", 0))
    if rank >= n_use:   # PARALLEL.ALLOW_DEVICE_SUBSET: this rank sits the run out
        return {}
    cfg = setup(args, rank)
    if cfg.UNSUPNET.Trainer != "pt":
        raise ValueError(f"Unknown trainer: {cfg.UNSUPNET.Trainer}")
    trainer = PTrainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        res = trainer.test(trainer.state.student) if trainer.mesh.rank == 0 else {}
        print(res)
        return res
    return trainer.train()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Probabilistic Teacher (PyTorch port)")
    parser.add_argument("--config-file", "--config", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=None,
                        help="ranks on this machine, one per card (default 1)")
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
