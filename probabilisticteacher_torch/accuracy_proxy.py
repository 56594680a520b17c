"""Accuracy proxy of the PyTorch port: the recipe's curves on the clean -> foggy proxy.

The counterpart of the JAX package's ``scripts/run_accuracy_proxy.py``. It builds
the synthetic proxy with ``scripts/make_daod_proxy.py`` (numpy and PIL only: the
same images the JAX runs trained on) and drives the port's CLI,
``python -m probabilisticteacher_torch.train_net``, with the reference's headline
c2f recipe scaled 1/10 in iterations (30k -> 3000, eval 400 -> 250) on 480 px
inputs, plus the ``train.sh`` overrides (TAU 0.5 0.5, learnable anchors)::

    python -m probabilisticteacher_torch.accuracy_proxy [--iters 3000] [--out DIR]
        [--source-only] [--weights CKPT] [--ema-keep K] [--seed S] ... [KEY VALUE ...]
    python -m probabilisticteacher_torch.accuracy_proxy campaign [--seed S] [KEY VALUE ...]
    python -m probabilisticteacher_torch.accuracy_proxy summarize RUN_DIR
    python -m probabilisticteacher_torch.accuracy_proxy compare TORCH_RUN JAX_RUN

A run mirrors its ``metrics.json`` and ``config.yaml`` every 60 s into
``docs/proxy_runs_torch/<run>/`` (``--archive``), never into ``docs/proxy_runs/``,
the JAX package's record. ``campaign`` runs stage 1 (source only, 3000 burn-in
iterations, both val splits) and then stage 2 (PT from stage 1's final
checkpoint: EMA 0.999, burn-in 200), prints each stage's eval curve beside the
JAX runs it is held to, its speed and memory, the card, and last one JSON line
with the verdict of each accuracy band. ``KEY VALUE`` pairs after the flags are
appended to every stage's overrides (``MODEL.DEVICE cpu`` runs on the CPU; the
default is the card).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .structures import card_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "pt", "final_c2f.yaml")
MAKE_PROXY = os.path.join(REPO, "scripts", "make_daod_proxy.py")
ARCHIVE_ROOT = os.path.join(REPO, "docs", "proxy_runs_torch")
JAX_RECORD = os.path.join(REPO, "docs", "proxy_runs")
WORK = os.path.join(REPO, ".proxy_runs_torch")
PROXY_SPLITS = ("VOC2007_citytrain", "VOC2007_foggytrain", "VOC2007_foggyval",
                "VOC2007_cityval")
SOURCE_ONLY_TEST = "('VOC2007_foggyval','VOC2007_cityval')"
FOGGY_STUDENT = "VOC2007_foggyval/mAP50_student"
CITY_STUDENT = "VOC2007_cityval/mAP50_student"
# stage 2's keep rate: on the 1/10 schedule the recipe's 0.9996 leaves the teacher
# lagging (the JAX runs' finding); 0.999 is what they ran
STAGE2_EMA_KEEP = 0.999
# the JAX runs each stage is held to (docs/proxy_runs/)
JAX_COUNTERPARTS = {1: ("source_only", "source_only_s101"),
                    2: ("pt_from_source", "pt_parity_head", "run_r")}


# --------------------------------------------------------------------------- #
# one run
# --------------------------------------------------------------------------- #
def build_parser(campaign: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m probabilisticteacher_torch.accuracy_proxy" + (" campaign" if campaign
                                                                      else ""),
        description="the campaign: stage 1 source only, then stage 2 PT from its final "
                    "checkpoint" if campaign else "one accuracy-proxy run of the port's CLI")
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--burn", type=int, default=200 if campaign else 400,
                   help="UNSUPNET.BURN_UP_STEP" + (" of stage 2" if campaign else ""))
    p.add_argument("--eval-period", type=int, default=250)
    p.add_argument("--data", default=os.path.join(WORK, "data"),
                   help="the proxy's root ($DETECTRON2_DATASETS); made if absent")
    p.add_argument("--n-train", type=int, default=400, help="make_daod_proxy.py --n-train")
    p.add_argument("--n-val", type=int, default=100, help="make_daod_proxy.py --n-val")
    p.add_argument("--hw", type=int, nargs=2, default=[480, 960], help="make_daod_proxy.py --hw")
    p.add_argument("--archive", default=ARCHIVE_ROOT,
                   help="where metrics.json and config.yaml are mirrored, one folder a run")
    p.add_argument("--seed", type=int, default=-1,
                   help="cfg.SEED (loader sampling, init and augmentation streams)"
                        + ("; of stage 1" if campaign else ""))
    p.add_argument("--nms", default="greedy", choices=["greedy", "maxpool", "hybrid"])
    p.add_argument("--unsup-warmup", type=int, default=0,
                   help="UNSUPNET.UNSUP_LOSS_WARMUP_ITERS (boundary ramp)")
    p.add_argument("--batch", type=int, default=16,
                   help="SOLVER.IMG_PER_BATCH_LABEL = IMG_PER_BATCH_UNLABEL")
    p.add_argument("--supervise", type=float, default=0.0, metavar="RSS_GB",
                   help="run under train_net --supervise with SOLVER.HOST_RSS_LIMIT_GB set "
                        "to this (a restart with --resume past the host-memory guard); "
                        "0 runs without the guard")
    if campaign:
        p.add_argument("--out-root", default=WORK,
                       help="holds the stages' output folders")
    else:
        p.add_argument("--out", default=os.path.join(WORK, "run"))
        p.add_argument("--ema-keep", type=float, default=0.0,
                       help="UNSUPNET.EMA_KEEP_RATE (0 keeps the recipe's)")
        p.add_argument("--weights", default="",
                       help="MODEL.WEIGHTS: a checkpoint of an earlier run (model_NNNNNNN)")
        p.add_argument("--source-only", action="store_true",
                       help="burn-in for the whole schedule (the reference's source-only "
                            "row), evaluated on the foggy and the clean val split")
        p.add_argument("--resume", action="store_true",
                       help="continue from the last checkpoint in --out")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE overrides appended last, e.g. MODEL.DEVICE cpu")
    return p


def train_argv(args) -> List[str]:
    """The ``train_net`` arguments of one run: the JAX runner's override list
    (``scripts/run_accuracy_proxy.py:86-150``) with the card as the device."""
    argv = [
        "--config-file", RECIPE,
        "MODEL.DEVICE", "cuda",
        # train.sh headline overrides (learnable anchors + tau .5)
        "UNSUPNET.TAU", "[0.5,0.5]",
        "MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
        # 1/10-scale schedule, 480px proxy inputs
        "SOLVER.MAX_ITER", str(args.iters),
        "SOLVER.STEPS", f"({args.iters},)",
        "UNSUPNET.BURN_UP_STEP", str(args.burn),
        "SOLVER.IMG_PER_BATCH_LABEL", str(args.batch),
        "SOLVER.IMG_PER_BATCH_UNLABEL", str(args.batch),
        "SOLVER.CHECKPOINT_PERIOD", "500",
        "SOLVER.WARMUP_ITERS", "100",
        "TEST.EVAL_PERIOD", str(args.eval_period),
        "INPUT.MIN_SIZE_TRAIN", "(480,)",
        "INPUT.MIN_SIZE_TEST", "480",
        "INPUT.CANVAS.WIDE", "(480, 992)",
        "INPUT.CANVAS.TALL", "(992, 480)",
        "MODEL.VGG.PRETRAIN", "",
        "SOLVER.AMP.ENABLED", "True",
        "MODEL.RPN.NMS_IMPL", args.nms,
        "OUTPUT_DIR", os.path.abspath(args.out),
    ]
    if args.unsup_warmup > 0:
        argv += ["UNSUPNET.UNSUP_LOSS_WARMUP_ITERS", str(args.unsup_warmup)]
    if args.source_only:
        argv += ["UNSUPNET.BURN_UP_STEP", str(args.iters), "DATASETS.TEST", SOURCE_ONLY_TEST]
    if args.ema_keep:
        argv += ["UNSUPNET.EMA_KEEP_RATE", str(args.ema_keep)]
    if args.seed >= 0:
        argv += ["SEED", str(args.seed)]
    if args.weights:
        argv += ["MODEL.WEIGHTS", os.path.abspath(args.weights)]
    if args.supervise:
        argv += ["SOLVER.HOST_RSS_LIMIT_GB", str(args.supervise)]
    argv += list(args.opts)
    flags = (["--supervise"] if args.supervise else []) + (["--resume"] if args.resume else [])
    return flags + argv


def ensure_data(args) -> None:
    """Write the proxy with ``scripts/make_daod_proxy.py`` unless its last split exists."""
    if os.path.exists(os.path.join(args.data, "data", PROXY_SPLITS[-1], "ImageSets")):
        return
    subprocess.check_call([sys.executable, MAKE_PROXY, "--root", args.data,
                           "--n-train", str(args.n_train), "--n-val", str(args.n_val),
                           "--hw", *map(str, args.hw)])


def launch_child(argv: List[str], env: Dict[str, str], log_path: str, append: bool) -> int:
    """``python -m probabilisticteacher_torch.train_net argv`` in its own process group,
    its output in ``log_path``. SIGTERM and SIGINT are forwarded to the whole group, so
    that ``timeout N`` on this process does not leave the trainer (or, under
    ``--supervise``, the supervisor and its child) running on the card."""
    cmd = [sys.executable, "-m", "probabilisticteacher_torch.train_net"] + argv
    with open(log_path, "a" if append else "w") as logf:
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)

        def forward(signum, _frame):
            try:
                os.killpg(proc.pid, signum)
            except ProcessLookupError:
                pass

        prev = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            return proc.wait()
        finally:
            for s, h in prev.items():
                signal.signal(s, h)


Launcher = Callable[[List[str], Dict[str, str], str, bool], int]


def run(args, launch: Optional[Launcher] = None, show: bool = True) -> int:
    """One run of the port's CLI: the proxy, the child, the live archive.
    ``launch`` (default :func:`launch_child`) runs ``train_net`` with the arguments,
    the environment, the log path and whether to append; it returns the exit code."""
    _refuse_jax_record(args.archive)
    ensure_data(args)
    env = dict(os.environ, DETECTRON2_DATASETS=os.path.abspath(args.data))
    os.makedirs(args.out, exist_ok=True)
    stop = threading.Event()
    archiver = threading.Thread(target=_archive_loop, args=(args.out, stop, args.archive),
                                daemon=True)
    archiver.start()
    try:
        rc = (launch or launch_child)(train_argv(args), env,
                                      os.path.join(args.out, "train_net.log"), args.resume)
    finally:
        stop.set()
        archiver.join(timeout=30)
    print(f"train_net exited {rc}", flush=True)
    if show:
        summarize(args.out)
    return rc


# --------------------------------------------------------------------------- #
# the archive
# --------------------------------------------------------------------------- #
def _refuse_jax_record(archive_root: str) -> None:
    root, record = os.path.realpath(archive_root), os.path.realpath(JAX_RECORD)
    if root == record or root.startswith(record + os.sep):
        raise ValueError(f"{archive_root} is the JAX package's record; the port archives "
                         f"into {ARCHIVE_ROOT}")


def archive_run(out_dir: str, archive_root: str = ARCHIVE_ROOT) -> Optional[str]:
    """Mirror a run's ``metrics.json`` and ``config.yaml`` into
    ``archive_root/<run name>/``; returns that folder, or None while the run has
    written nothing. Only complete JSON lines are mirrored. A fresh run that reuses a
    name never shrinks a longer curve: the old file moves to ``metrics.json.<i>``.
    The JAX package's record, ``docs/proxy_runs/``, is refused."""
    _refuse_jax_record(archive_root)
    dst = os.path.join(archive_root, os.path.basename(os.path.normpath(out_dir)))
    copied = None
    for fname in ("metrics.json", "config.yaml"):
        src = os.path.join(out_dir, fname)
        if not os.path.exists(src):
            continue
        with open(src, "rb") as f:
            data = f.read()
        if fname == "metrics.json":
            data = data[:data.rfind(b"\n") + 1]
            if not data:
                continue
        os.makedirs(dst, exist_ok=True)
        out = os.path.join(dst, fname)
        if os.path.exists(out):
            with open(out, "rb") as f:
                old = f.read()
            if old == data:
                copied = dst
                continue
            if fname == "metrics.json" and len(old) > len(data):
                i = 1
                while os.path.exists(f"{out}.{i}"):
                    i += 1
                os.replace(out, f"{out}.{i}")
        tmp = out + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, out)
        copied = dst
    return copied


def _archive_loop(out_dir: str, stop: threading.Event, archive_root: str = ARCHIVE_ROOT,
                  period_s: float = 60.0) -> None:
    """Mirror the live run every ``period_s`` and once more after it ends."""
    while not stop.wait(period_s):
        try:
            archive_run(out_dir, archive_root)
        except OSError:
            pass   # a passing file-system error: the next tick tries again
    archive_run(out_dir, archive_root)


# --------------------------------------------------------------------------- #
# reading a run (the port's and the JAX package's metrics.json alike)
# --------------------------------------------------------------------------- #
def _metrics_path(run: str) -> str:
    return run if run.endswith(".json") else os.path.join(run, "metrics.json")


def read_records(run: str) -> List[dict]:
    records = []
    with open(_metrics_path(run)) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def eval_period(run: str, default: int = 250) -> int:
    path = os.path.join(os.path.dirname(_metrics_path(run)), "config.yaml")
    if not os.path.exists(path):
        return default
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return int(cfg.get("TEST", {}).get("EVAL_PERIOD", default) or default)


def _is_eval_key(k: str) -> bool:
    return k.endswith(("mAP50", "mAP50_student")) and "AP50-" not in k


def evals(run: str) -> List[Tuple[int, dict]]:
    """(iteration E, record) for each eval of a run. The eval at E runs after step
    E - 1, past that step's write, so the first record written at an iteration in
    [E, E + period) is the first to hold it (the records keep the latest values)."""
    period = eval_period(run)
    out: Dict[int, dict] = {}
    for r in read_records(run):
        e = int(r.get("iteration", -1)) // period * period
        if e > 0 and e not in out and any(_is_eval_key(k) for k in r):
            out[e] = r
    return sorted(out.items())


def summarize(run: str) -> None:
    """Print the teacher/student mAP50 curve of ``metrics.json``, one row a record."""
    if not os.path.exists(_metrics_path(run)):
        print("no metrics.json")
        return

    def pick(d, suffix):
        vals = [v for k, v in d.items() if k == suffix or k.endswith("/" + suffix)]
        return vals[0] if vals else None

    seen = {}
    for d in read_records(run):
        if pick(d, "mAP50") is not None or pick(d, "mAP50_student") is not None:
            seen[d.get("iteration")] = (pick(d, "mAP50"), pick(d, "mAP50_student"),
                                        d.get("num_pseudo_boxes"), d.get("total_loss"))
    nan = float("nan")
    print(f"{'iter':>6} {'teacher mAP50':>14} {'student mAP50':>14} {'pseudo/img':>10} "
          f"{'loss':>8}")
    for it in sorted(k for k in seen if k is not None):
        t, s, npb, tl = (nan if v is None else v for v in seen[it])
        print(f"{it:>6} {t:>14.2f} {s:>14.2f} {npb:>10.1f} {tl:>8.3f}")


CURVE_KEYS = (("mAP50", "teacher mAP50"), ("mAP50_student", "student mAP50"),
              (FOGGY_STUDENT, "student mAP50, foggy val"),
              (CITY_STUDENT, "student mAP50, clean val"),
              ("num_pseudo_boxes", "pseudo boxes per image"))


def compare(torch_run: str, *jax_runs: str) -> str:
    """The eval curves of a port run and of JAX runs side by side: for each headline
    key either side has, one row per eval iteration, one column per run. Prints
    and returns the table."""
    runs = [("torch:" + os.path.basename(os.path.normpath(torch_run)), torch_run)]
    runs += [("jax:" + os.path.basename(os.path.normpath(j)), j) for j in jax_runs]
    curves = [(name, dict(evals(path))) for name, path in runs]
    width = max(10, *(len(name) for name, _ in curves))
    lines = []
    for key, title in CURVE_KEYS:
        if not any(key in r for _, c in curves for r in c.values()):
            continue
        lines.append(f"{title} ({key})")
        lines.append(f"{'iter':>5} " + " ".join(f"{name:>{width}}" for name, _ in curves))
        for e in sorted({e for _, c in curves for e in c}):
            vals = [c.get(e, {}).get(key) for _, c in curves]
            lines.append(f"{e:>5} " + " ".join(
                f"{'-' if v is None else format(v, '.2f'):>{width}}" for v in vals))
    table = "\n".join(lines)
    print(table, flush=True)
    return table


# --------------------------------------------------------------------------- #
# speed and memory of a run, from its metrics.json and log.txt
# --------------------------------------------------------------------------- #
_MEM = re.compile(r"max_mem: (\d+)M")
_EVAL = re.compile(r"eval on (\S+): (\d+) images in ([0-9.]+) s")


def run_stats(run: str, burn_up: int, period: int) -> dict:
    """Iterations per second, the share of an iteration waiting on data, eval images
    per second and the peak device memory of a run.

    ``it/s`` in a record is the trainer's running rate since its first step, so two
    records give the time of the steps between them; windows that hold an eval
    (step E - 1 of an eval at E) are left out. Each phase (burn-in, mutual) gets the
    median seconds per iteration of its windows and the mean ``data_time`` of the
    records closing them over that mean window time. The peak is the largest
    ``max_mem`` of the console lines in ``log.txt``, and the eval rate is the
    images over the seconds of every ``eval on`` line there."""
    recs = [r for r in read_records(run) if "it/s" in r]
    windows: Dict[str, List[Tuple[float, float]]] = {"burnin": [], "mutual": []}
    for a, b in zip(recs, recs[1:]):
        ia, ib = int(a["iteration"]), int(b["iteration"])
        if ib <= ia:
            continue
        ea, eb = ia / a["it/s"], ib / b["it/s"]       # seconds since the timer started
        if period and any(ia + 2 <= e <= ib + 1 for e in range(period, ib + 2, period)):
            continue
        phase = "burnin" if ib < burn_up else ("mutual" if ia >= burn_up else None)
        if phase:
            windows[phase].append(((eb - ea) / (ib - ia), b.get("data_time", 0.0)))
    out: dict = {}
    for phase, w in windows.items():
        if not w:
            continue
        s_per_it = statistics.median(s for s, _ in w)
        out[phase] = {"it_per_s": 1.0 / s_per_it, "s_per_it": s_per_it,
                      "data_time_share": statistics.fmean(d for _, d in w)
                      / statistics.fmean(s for s, _ in w),
                      "windows": len(w)}
    log = os.path.join(os.path.dirname(_metrics_path(run)), "log.txt")
    if os.path.exists(log):
        with open(log) as f:
            text = f.read()
        mem = [int(m) for m in _MEM.findall(text)]
        out["peak_gib"] = max(mem) / 1024 if mem else None
        ev = [(int(n), float(s)) for _, n, s in _EVAL.findall(text)]
        out["eval_images"] = sum(n for n, _ in ev)
        out["eval_img_per_s"] = (sum(n for n, _ in ev) / sum(s for _, s in ev)
                                 if ev and sum(s for _, s in ev) > 0 else None)
    return out


# --------------------------------------------------------------------------- #
# the bands (fixed before any port run; the JAX numbers from docs/proxy_runs/)
# --------------------------------------------------------------------------- #
def bands(stage1: str, stage2: str) -> dict:
    """S1a, S1b, S2a and S2b of the campaign, each with its reading and verdict, and
    whether stage 2 collapsed (teacher peak under 60)."""
    e1, e2 = evals(stage1), evals(stage2)
    city = [r[CITY_STUDENT] for e, r in e1 if e >= 1250 and CITY_STUDENT in r]
    foggy = [r[FOGGY_STUDENT] for e, r in e1 if e >= 1000 and FOGGY_STUDENT in r]
    teacher = [r["mAP50"] for _, r in e2 if "mAP50" in r]
    pseudo = [r.get("num_pseudo_boxes", 0.0) for e, r in e2 if e > 200]
    s1b_mean = statistics.fmean(foggy) if foggy else math.nan
    peak = max(teacher) if teacher else math.nan
    final = teacher[-1] if teacher else math.nan
    out = {
        "S1a": {"cityval_student_min_from_1250": min(city) if city else math.nan,
                "evals": len(city), "limit": ">= 90",
                "pass": bool(city) and min(city) >= 90.0},
        "S1b": {"foggyval_student_mean_from_1000": s1b_mean, "evals": len(foggy),
                "limit": "in [38, 58]", "pass": bool(foggy) and 38.0 <= s1b_mean <= 58.0},
        "S2a": {"teacher_peak": peak, "teacher_final": final,
                "min_pseudo_boxes_after_200": min(pseudo) if pseudo else math.nan,
                "limit": "peak >= 70, final >= 65, pseudo boxes > 0",
                "pass": bool(teacher) and bool(pseudo) and peak >= 70.0 and final >= 65.0
                and min(pseudo) > 0.0},
        "S2b": {"teacher_peak_minus_s1b_mean": peak - s1b_mean, "limit": ">= 15",
                "pass": bool(teacher) and bool(foggy) and peak - s1b_mean >= 15.0},
    }
    out["collapsed"] = bool(teacher) and peak < 60.0
    return out


def _seed_suffix(args) -> str:
    return f"_s{args.seed}" if args.seed >= 0 else ""


def stage_args(args, stage: int, stage1_out: str = ""):
    """The run arguments of a campaign stage."""
    suffix = _seed_suffix(args)
    ns = argparse.Namespace(**vars(args))
    ns.resume = False
    if stage == 1:
        ns.out = os.path.join(args.out_root, "source_only" + suffix)
        ns.source_only, ns.ema_keep, ns.weights = True, 0.0, ""
    else:
        ns.out = os.path.join(args.out_root, "pt_from_source" + suffix)
        ns.source_only, ns.ema_keep, ns.seed = False, STAGE2_EMA_KEEP, -1
        ns.weights = os.path.join(stage1_out, f"model_{args.iters:07d}")
    return ns


def _no_nan(x):
    """``x`` with each NaN as None, so that its JSON is strict."""
    if isinstance(x, dict):
        return {k: _no_nan(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_no_nan(v) for v in x]
    return None if isinstance(x, float) and math.isnan(x) else x


def campaign(args, launch: Optional[Launcher] = None) -> dict:
    """Stage 1, then stage 2 from stage 1's final checkpoint, in one process tree.
    Prints each stage's eval curve beside its JAX counterparts, its speed, data wait,
    eval rate and peak memory, the card, and last the bands' JSON line; writes the
    same into ``campaign.json`` beside the stages' archives. A stage that fails
    raises SystemExit with its exit code."""
    ensure_data(args)
    stages, card = {}, card_line()
    s1 = stage_args(args, 1)
    s2 = stage_args(args, 2, s1.out)
    for stage, ns in ((1, s1), (2, s2)):
        t0 = time.perf_counter()
        rc = run(ns, launch, show=False)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"stage {stage} ({ns.out}) failed: train_net exited {rc}")
        jax = [os.path.join(JAX_RECORD, name) for name in JAX_COUNTERPARTS[stage]]
        print(f"\n== stage {stage}: {os.path.basename(ns.out)}, eval curve beside the JAX "
              f"runs it is held to", flush=True)
        compare(ns.out, *[j for j in jax if os.path.exists(_metrics_path(j))])
        burn = args.iters if stage == 1 else args.burn
        stats = dict(run_stats(ns.out, burn, args.eval_period), wall_s=wall)
        print(f"stage {stage} stats: {json.dumps(stats)}; {card}", flush=True)
        stages[stage] = {"run": os.path.basename(ns.out), "argv": train_argv(ns),
                         "stats": stats}
    verdict = bands(s1.out, s2.out)
    result = _no_nan({"card": card, "stages": stages, "bands": verdict})
    os.makedirs(args.archive, exist_ok=True)
    with open(os.path.join(args.archive, f"campaign{_seed_suffix(args)}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"card: {card}")
    print(json.dumps({"bands": result["bands"]}), flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["summarize"] and len(argv) == 2:
        summarize(argv[1])
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 3:
        compare(argv[1], *argv[2:])
        return 0
    if argv[:1] == ["campaign"]:
        campaign(build_parser(campaign=True).parse_args(argv[1:]))
        return 0
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
