"""Port parity for the host data pipeline: catalog, VOC/COCO readers, loaders, native decode.

The port keeps its own copies of the JAX package's ``data/datasets.py``,
``data/loader.py`` and ``data/native.py`` (with its own copy of the C++ loader,
built into ``probabilisticteacher_torch/_build/``). On the same synthetic VOC trees:

- the catalog, the VOC reader and the COCO-json reader give equal dicts;
- ``SemiSupLoader`` and ``EvalLoader`` give byte-identical batches to JAX's over 3
  batches for the same seed, with ``DATALOADER.NATIVE`` on and off;
- the port's loader library builds, and its decode + resize matches the PIL path
  within 2 intensity levels (the C++ triangle filter is in float, PIL's in 8-bit
  fixed point).
"""

import itertools
import json
import os

import numpy as np
import pytest

from probabilisticteacher_tpu.config import get_cfg as jget_cfg
from probabilisticteacher_tpu.data import datasets as jds
from probabilisticteacher_tpu.data import loader as jloader
from probabilisticteacher_tpu.data import native as jnative
from probabilisticteacher_torch.config import get_cfg
from probabilisticteacher_torch.data import datasets as tds
from probabilisticteacher_torch.data import loader as tloader
from probabilisticteacher_torch.data import native
from synthetic_data import CLASSES
from torch_micro import micro_opts, voc_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return voc_tree(str(tmp_path_factory.mktemp("voc")))


def _cfgs(tmp, nat: bool):
    opts = micro_opts(tmp, "l", "u", "v") + ["DATALOADER.NATIVE", str(nat)]
    out = []
    for make in (jget_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_list(opts)
        out.append(cfg)
    return out


def _dicts(tree, split_dir, split):
    return (jds.load_voc_instances(os.path.join(tree, split_dir), split, CLASSES),
            tds.load_voc_instances(os.path.join(tree, split_dir), split, CLASSES))


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split_dir,split", [("src", "train"), ("val", "val")])
def test_voc_reader_matches(tree, split_dir, split):
    want, got = _dicts(tree, split_dir, split)
    assert got == want and len(got) > 0


def test_coco_reader_matches(tmp_path):
    coco = {"images": [{"id": 2, "file_name": "b.jpg", "height": 10, "width": 20},
                       {"id": 1, "file_name": "a.jpg", "height": 30, "width": 40}],
            "categories": [{"id": 7, "name": "car"}, {"id": 3, "name": "person"}],
            "annotations": [{"image_id": 1, "category_id": 7, "bbox": [1, 2, 3, 4]},
                            {"image_id": 1, "category_id": 3, "bbox": [5, 6, 7, 8],
                             "iscrowd": 1},
                            {"image_id": 2, "category_id": 3, "bbox": [0, 0, 5, 5]}]}
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    for unlabeled in (False, True):
        got = tds.load_coco_json(path, "/img", unlabeled)
        assert got == jds.load_coco_json(path, "/img", unlabeled)
    assert got[0]["image_id"] == 1 and got[0]["annotations"] == []


def test_builtin_catalog_matches(tmp_path):
    root = str(tmp_path)
    jds.register_builtin(root)
    tds.register_builtin(root)
    names = sorted(jds.DatasetCatalog._fns)
    assert set(names) <= set(tds.DatasetCatalog._fns)
    for name in ("VOC2007_citytrain", "VOC2007_foggytrain", "VOC2007_foggyval",
                 "coco_2017_unlabel"):
        assert tds.DatasetCatalog.metadata[name] == jds.DatasetCatalog.metadata[name]
    assert tds.DatasetCatalog.class_names("VOC2007_foggyval") == tds.CLASS_NAMES_8
    with pytest.raises(KeyError, match="not registered"):
        tds.DatasetCatalog.get("no_such_split")


@pytest.mark.parametrize("nat", [True, False])
def test_semisup_loader_batches_identical(tree, tmp_path, nat):
    jcfg, tcfg = _cfgs(tmp_path, nat)
    jnative.available()   # JAX's first use is not locked: load before the threads start
    jl, tl = _dicts(tree, "src", "train")
    ju, tu = _dicts(tree, "tgt", "train")
    jit = iter(jloader.SemiSupLoader(jcfg, jl, ju, seed=5))
    tit = iter(tloader.SemiSupLoader(tcfg, tl, tu, seed=5))
    for jb, tb in itertools.islice(zip(jit, tit), 3):
        assert jb.keys() == tb.keys() == {"label", "unlabel"}
        for k in jb:
            _equal_batches(jb[k], tb[k])
    assert tb["label"]["image"].shape == (2, 48, 96, 3)


@pytest.mark.parametrize("nat", [True, False])
def test_eval_loader_batches_identical(tree, tmp_path, nat):
    jcfg, tcfg = _cfgs(tmp_path, nat)
    for cfg in (jcfg, tcfg):
        cfg.TEST.IMS_PER_BATCH = 2
    jv, tv = _dicts(tree, "val", "val")
    jb = list(jloader.EvalLoader(jcfg, jv))
    tb = list(tloader.EvalLoader(tcfg, tv))
    assert len(jb) == len(tb) == 2   # 3 images at batch 2: the last one padded
    for a, b in zip(jb, tb):
        _equal_batches(a, b)
    assert [i for b in tb for i in b["image_id"]].count(None) == 1


def test_native_library_builds_into_build_dir():
    assert native.available()
    path = native._LIBRARY.path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "probabilisticteacher_torch"


@pytest.mark.parametrize("flip", [False, True])
def test_native_decode_matches_pil(tree, tmp_path, flip):
    _, tcfg = _cfgs(tmp_path, True)
    d = tds.load_voc_instances(os.path.join(tree, "src"), "train", CLASSES)[0]
    canvas, hw, scale = native.load_image(d["file_name"], 48, 96, flip, (48, 96))
    img = tloader.read_image(d["file_name"], "BGR")
    img, _, pscale = tloader.resize_shortest_edge(img, np.zeros((0, 4), np.float32), 48, 96)
    if flip:
        img = img[:, ::-1]
    h, w = img.shape[:2]
    assert tuple(hw) == (h, w) and scale == pytest.approx(pscale)
    diff = np.abs(canvas[:h, :w].astype(int) - img.astype(int))
    assert diff.max() <= 2, diff.max()
    assert not canvas[h:].any() and not canvas[:, w:].any()
