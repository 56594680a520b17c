"""The port's learning diagnostics (``probabilisticteacher_torch/diagnostics/``) against
the JAX package's ``scripts/_proxy_common.py``, ``diagnose_levers.py``,
``diagnose_student_path.py`` and ``overfit_check.py``.

- a proxy tree of 8 + 8 training images of 128 x 256 from
  ``scripts/make_daod_proxy.py`` (a subprocess, as ``accuracy_proxy`` runs it), read
  at ``--short 96 --n 2``: the port's ``load_proxy_setup`` and the JAX script's pick
  the same records, give the same batch bytes and the same config;
- one JAX init, carried over by ``weights.params_from_jax``, written as a port
  checkpoint and as an Orbax one. In the student slot the background's class-score bias
  is raised by 6 and class 4's score row scaled by 10, so that the 0.05 score filter
  and ``TAU`` keep only part of the candidates (at a plain random init every image
  keeps all 100 boxes and nothing is tested), and the learnable anchors are set so
  that proposals reach the ground truth and the hybrid prefilter has safe channels. The teacher slot holds the unshifted init, so the student slot
  is seen to be the one read. ``diagnose_levers`` gives the JAX script's dets/img,
  conf >= tau/img, recall and per-image valid counts, and ``diagnose_student_path``
  its gt-recall, fg-pool and agreement: all exact. Every one is a ratio of integer
  counts, so no tolerance is needed; the f32 convolutions of XLA and oneDNN differ by
  ~1e-6 relative, far from any threshold these weights put a score or an IoU near.
  JAX compiles each variant again, so the JAX side runs the exact path, one teacher
  budget and one candidate variant (the student path: exact and ``pre2000``); the
  card runs every variant (``chip_smoke.py`` phase 13). At this size the teacher
  budgets and the candidate prefilter cut nothing that reaches the output, so their
  lines equal the exact one on both sides; the hybrid student variant does move. The JAX setup's template
  init, whose values the restore overwrites, is served from this file's jitted init;
- the port's ``overfit_check`` config equals the one ``scripts/overfit_check.py``
  hands its trainer, key by key, with and without its flags; 6 iterations on the CPU
  end with finite metrics; the bar passes and misses as the JAX script's does;
- with no card and no ``--device cpu`` each entry raises before it reads or writes.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from probabilisticteacher_torch.diagnostics import diagnose_levers as dl
from probabilisticteacher_torch.diagnostics import diagnose_student_path as dsp
from probabilisticteacher_torch.diagnostics import overfit_check as oc
from probabilisticteacher_torch.diagnostics import proxy_setup as ps
from probabilisticteacher_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
N, SHORT = 2, 96
CANVAS = (SHORT, SHORT * 992 // 480)
BG_SHIFT, CLS, CLS_SCALE = 6.0, 4, 10.0   # background bias + 6, class 4's row x 10
# learnable anchors: five of 24-64 px for the 24-64 px objects of a 128 x 256 proxy
# read at 96 px (proposals that reach the ground truth) and four of 180-360 px, the
# channels the hybrid prefilter treats as safe
ANCHOR_WH = ((32.0, 32.0), (64.0, 64.0), (24.0, 48.0), (48.0, 24.0), (48.0, 48.0),
             (200.0, 200.0), (256.0, 256.0), (180.0, 360.0), (360.0, 180.0))
LEVER_VARIANTS = ("exact", "teacher1000", "cand2048")
STUDENT_VARIANTS = ("exact (pre 6000)", "hybrid")


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


def _plain(cfg):
    return _flat(yaml.safe_load(cfg.dump()))


@pytest.fixture(scope="module")
def proxy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("proxy"))
    subprocess.run([sys.executable, os.path.join(SCRIPTS, "make_daod_proxy.py"), "--root", root,
                    "--n-train", "8", "--n-val", "2", "--hw", "128", "256"],
                   check=True, capture_output=True, timeout=120)
    return root


@pytest.fixture(scope="module")
def jax_side(proxy, tmp_path_factory):
    """The JAX script's setup on shared weights: (setup, setup with require_gt, the
    port checkpoint, the student and teacher state dicts)."""
    sys.path.insert(0, SCRIPTS)
    import _proxy_common

    from probabilisticteacher_tpu.checkpoint import save_checkpoint
    from probabilisticteacher_tpu.engine.steps import TrainState
    from probabilisticteacher_tpu.modeling import detector as jdet

    arch = jdet.Arch(**dataclasses.asdict(ps.Arch.from_cfg(ps.proxy_cfg(SHORT))))
    det = jdet.PTDetector(arch)
    init = jax.jit(lambda k: det.init(k, CANVAS))(jax.random.key(0))
    init = jax.tree.map(np.asarray, init)
    init["anchor_wh"] = np.asarray(ANCHOR_WH, np.float32).reshape(init["anchor_wh"].shape)
    student = jax.tree.map(np.copy, init)
    student["predictor"]["cls_score"]["bias"][-1] += BG_SHIFT
    student["predictor"]["cls_score"]["kernel"][:, CLS] *= CLS_SCALE
    work = tmp_path_factory.mktemp("ckpt")
    orbax = save_checkpoint(str(work / "jax"), TrainState(
        student=student, teacher=init, opt_state={}, step=jnp.asarray(0, jnp.int32)))
    sd_student, sd_teacher = params_from_jax(student, arch), params_from_jax(init, arch)
    port_ckpt = str(work / "model_0000000")
    torch.save({"step": 0, "student": sd_student, "teacher": sd_teacher, "optimizer": {}},
               port_ckpt)

    mp = pytest.MonkeyPatch()
    # the setup's template init is overwritten by the restore: serve it from ``init``
    mp.setattr(jdet.PTDetector, "init", lambda self, key, canvas: jax.tree.map(jnp.asarray, init))
    try:
        setup = _proxy_common.load_proxy_setup(N, SHORT, proxy, orbax)
        setup_gt = _proxy_common.load_proxy_setup(N, SHORT, proxy, orbax, require_gt=True)
    finally:
        mp.undo()
    return types.SimpleNamespace(setup=setup, setup_gt=setup_gt, ckpt=port_ckpt,
                                 student=sd_student, teacher=sd_teacher)


def _args(proxy, ckpt, *extra):
    return ps.build_parser("test").parse_args(
        ["--n", str(N), "--short", str(SHORT), "--data", proxy, "--weights", ckpt,
         "--device", "cpu", *extra])


@pytest.mark.parametrize("require_gt", [False, True])
def test_setup_matches_the_jax_script(proxy, jax_side, require_gt):
    jcfg, jarch, jstudent, jbatch, jimgs = jax_side.setup_gt if require_gt else jax_side.setup
    cfg, arch, det, batch, imgs = ps.load_proxy_setup(N, SHORT, proxy, jax_side.ckpt,
                                                      require_gt=require_gt, device="cpu")
    mine, theirs = _plain(cfg), _plain(jcfg)
    shared = set(mine) & set(theirs)
    assert len(shared) >= 140
    assert {k: (mine[k], theirs[k]) for k in shared if mine[k] != theirs[k]} == {}
    assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
    assert [o["image_id"] for o in imgs] == [o["image_id"] for o in jimgs]
    assert np.array_equal(batch.image.numpy(), np.asarray(jbatch.image))
    assert np.array_equal(batch.image_hw.numpy(), np.asarray(jbatch.image_hw))
    # the student slot, exactly, and it is the slot the JAX setup returns
    sd = det.state_dict()
    assert sd.keys() == jax_side.student.keys()
    for k, v in jax_side.student.items():
        assert torch.equal(sd[k], v), k
    assert not torch.equal(sd["predictor.cls_score.bias"], jax_side.teacher["predictor.cls_score.bias"])
    assert torch.equal(params_from_jax(jax.tree.map(np.asarray, jstudent), arch)[
        "predictor.cls_score.bias"], jax_side.student["predictor.cls_score.bias"])


def test_slot_teacher_reads_the_teacher(jax_side):
    arch = ps.Arch.from_cfg(ps.proxy_cfg(SHORT))
    sd = ps.load_slot(jax_side.ckpt, arch, torch.device("cpu"), "teacher").state_dict()
    for k, v in jax_side.teacher.items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="neither student nor teacher"):
        ps.load_slot(jax_side.ckpt, arch, torch.device("cpu"), "ema")


def _jax_levers(setup, names):
    """The JAX script's loop (``diagnose_levers.py:71-101``) over ``names``."""
    from probabilisticteacher_tpu.modeling.detector import PTDetector
    from probabilisticteacher_tpu.ops import boxes as box_ops

    cfg, base_arch, params, batch, _ = setup
    taus = tuple(cfg.UNSUPNET.TAU)
    variants = dl.variants(base_arch)
    out, ref_boxes = {}, None
    for name in names:
        arch = base_arch.__class__(**{**base_arch.__dict__, **variants[name]})
        pl = jax.jit(PTDetector(arch).pseudo_labels)(params, batch)
        probs = np.asarray(jax.nn.softmax(pl.logits, axis=-1)[..., :-1])
        keep = (probs.max(-1) >= taus[0]) & np.asarray(pl.valid)
        n_all = float(jnp.sum(pl.valid)) / N
        n_tau = float(keep.sum()) / N
        boxes = [np.asarray(pl.boxes[i])[keep[i]] for i in range(N)]
        if ref_boxes is None:
            ref_boxes, recall = boxes, 1.0
        else:
            hit = tot = 0
            for i in range(N):
                if not len(ref_boxes[i]):
                    continue
                tot += len(ref_boxes[i])
                if len(boxes[i]):
                    iou = np.asarray(box_ops.pairwise_iou(jnp.asarray(ref_boxes[i]),
                                                          jnp.asarray(boxes[i])))
                    hit += int((iou.max(axis=1) >= 0.5).sum())
            recall = hit / max(tot, 1)
        jboxes, jvalid = np.asarray(pl.boxes), np.asarray(pl.valid)
        flat = ((jboxes[..., 2] - jboxes[..., 0]) * (jboxes[..., 3] - jboxes[..., 1]) <= 0) & jvalid
        out[name] = {"dets_per_img": n_all, "conf_tau_per_img": n_tau, "recall": recall,
                     "valid_per_image": jvalid.sum(1).tolist(),
                     "zero_area_per_image": flat.sum(1).tolist()}
    return out


def test_diagnose_levers_matches_the_jax_script(proxy, jax_side, capsys):
    want = _jax_levers(jax_side.setup, LEVER_VARIANTS)
    got = dl.run(_args(proxy, jax_side.ckpt), names=LEVER_VARIANTS)
    assert got == want
    # the filters cut: some detections, not all 100, and some of them confident
    ex = want["exact"]
    assert all(0 < v < 100 for v in ex["valid_per_image"])
    assert 0 < ex["conf_tau_per_img"] < ex["dets_per_img"]
    lines = capsys.readouterr().out.splitlines()
    for name, r in want.items():
        assert (f"{name:>22}: dets/img {r['dets_per_img']:5.1f}  conf>=tau/img "
                f"{r['conf_tau_per_img']:5.1f}  recall-vs-exact@0.5 {r['recall']:5.1%}") in lines


def _jax_student_path(setup, imgs, names):
    """The JAX script's loop (``diagnose_student_path.py:65-105``) over ``names``."""
    from probabilisticteacher_tpu.modeling.detector import PTDetector
    from probabilisticteacher_tpu.ops import boxes as box_ops

    _, base_arch, student, batch, _ = setup
    gts = [np.asarray(o["gt_boxes"])[np.asarray(o["gt_valid"]).astype(bool)] for o in imgs]
    variants = dsp.variants(base_arch)
    out, ref = {}, None
    for name in names:
        det = PTDetector(base_arch.__class__(**{**base_arch.__dict__, **variants[name]}))

        def fwd(params, images, det=det):
            feat = det.features(params, images)
            obj, deltas = det.rpn_predict(params, feat)
            anchors = det.anchors(params, feat.shape[1], feat.shape[2])
            return det.predict_proposals(anchors, obj, deltas, images.image_hw,
                                         training=True, grid_hw=feat.shape[1:3])

        pr = jax.jit(fwd)(student, batch)
        props = [np.asarray(pr.boxes[i])[np.asarray(pr.valid[i]).astype(bool)]
                 for i in range(N)]
        gt_hit = gt_tot = agree_hit = agree_tot = 0
        fg_pool = 0.0
        for i in range(N):
            if len(gts[i]):
                iou = np.asarray(box_ops.pairwise_iou(jnp.asarray(gts[i]), jnp.asarray(props[i])))
                gt_tot += len(gts[i])
                gt_hit += int((iou.max(axis=1) >= 0.5).sum())
                fg_pool += int((iou.max(axis=0) >= 0.5).sum())
            if ref is not None and len(ref[i]) and len(props[i]):
                aiou = np.asarray(box_ops.pairwise_iou(jnp.asarray(ref[i]),
                                                       jnp.asarray(props[i])))
                agree_tot += len(ref[i])
                agree_hit += int((aiou.max(axis=1) >= 0.9).sum())
        if ref is None:
            ref, agree = props, 1.0
        else:
            agree = agree_hit / max(agree_tot, 1)
        out[name] = {"gt_recall": gt_hit / max(gt_tot, 1), "fg_pool_per_img": fg_pool / N,
                     "agreement": agree, "proposals_per_image": [len(p) for p in props]}
    return out


def test_diagnose_student_path_matches_the_jax_script(proxy, jax_side, capsys):
    want = _jax_student_path(jax_side.setup_gt, jax_side.setup_gt[4], STUDENT_VARIANTS)
    got = dsp.run(_args(proxy, jax_side.ckpt), names=STUDENT_VARIANTS)
    assert got == want
    ex = want["exact (pre 6000)"]
    assert 0 < ex["gt_recall"] < 1 and ex["fg_pool_per_img"] > 0
    assert want["hybrid"]["agreement"] < 1.0
    lines = capsys.readouterr().out.splitlines()
    for name, r in want.items():
        assert (f"{name:>18}: gt-recall@0.5 {r['gt_recall']:6.1%}  fg-pool/img "
                f"{r['fg_pool_per_img']:7.1f}  agreement-vs-exact@0.9 "
                f"{r['agreement']:6.1%}") in lines


def test_no_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "absent")
    for entry in (dl.main, dsp.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(["--data", missing, "--weights", missing])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oc.main([])
    assert not os.path.exists(missing)
