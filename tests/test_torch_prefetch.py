"""The port's DevicePrefetcher on the CPU: the contract of ``tests/test_prefetch.py``.

On the CPU the prefetcher runs ``shard_fn`` on its background thread with no stream
(the card's stream and event path is driven by ``chip_smoke.py`` phase 8): order
and iteration numbers, the exact burn-in/mutual decision from ``start_iter``,
worker and shard errors re-raised, ``close()`` unblocking a full queue and closing
the host iterator, copies running ahead, and the trainer's
``DATALOADER.DEVICE_PREFETCH`` switch.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from probabilisticteacher_torch.config import get_cfg
from probabilisticteacher_torch.data.datasets import register_pascal_voc
from probabilisticteacher_torch.engine.trainer import PTrainer
from probabilisticteacher_torch.parallel import DevicePrefetcher, host_to_device
from synthetic_data import CLASSES
from torch_micro import micro_opts, voc_tree


def test_yields_in_order_with_iteration_numbers():
    seen = []

    def shard(batch, it):
        seen.append((batch, it))
        return {"batch": batch, "it": it}

    p = DevicePrefetcher(iter(range(100, 110)), shard, start_iter=5, depth=2)
    got = [next(p) for _ in range(10)]
    assert [g["batch"] for g in got] == list(range(100, 110))
    assert [g["it"] for g in got] == list(range(5, 15))
    p.close()


@pytest.mark.parametrize("start", [0, 3])
def test_phase_decision_is_exact_at_boundary(start):
    burn_up = 4

    def shard(batch, it):
        out = {"limg": batch}
        if it >= burn_up:
            out["uimg"] = batch
        return out

    p = DevicePrefetcher(iter(range(8)), shard, start_iter=start, depth=3)
    got = [next(p) for _ in range(8)]
    n_burn = max(burn_up - start, 0)
    assert all("uimg" not in g for g in got[:n_burn])
    assert all("uimg" in g for g in got[n_burn:])
    p.close()


def test_worker_error_propagates():
    def bad_host():
        yield 1
        raise ValueError("decode failed")

    p = DevicePrefetcher(bad_host(), lambda b, i: b, depth=2)
    assert next(p) == 1
    with pytest.raises(RuntimeError, match="prefetch worker failed") as e:
        next(p)
    assert isinstance(e.value.__cause__, ValueError)
    p.close()


def test_shard_error_propagates():
    def shard(batch, it):
        if it == 1:
            raise RuntimeError("device OOM")
        return batch

    p = DevicePrefetcher(itertools.count(), shard, depth=2)
    assert next(p) == 0
    with pytest.raises(RuntimeError):
        next(p)
    p.close()


def test_close_unblocks_full_queue_and_closes_the_host_iterator():
    closed = threading.Event()

    def host():
        try:
            yield from itertools.count()
        finally:
            closed.set()

    p = DevicePrefetcher(host(), lambda b, i: b, depth=1)
    next(p)
    time.sleep(0.2)  # let the worker fill the queue and block
    p.close()
    p._thread.join(timeout=5)
    assert not p._thread.is_alive()
    assert closed.wait(timeout=5)
    with pytest.raises(StopIteration):
        next(p)


def test_copies_run_ahead_of_consumption():
    uploaded = []
    lock = threading.Lock()

    def shard(batch, it):
        with lock:
            uploaded.append(it)
        return batch

    p = DevicePrefetcher(itertools.count(), shard, depth=2)
    next(p)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with lock:
            if len(uploaded) >= 3:  # 0 consumed + 2 queued ahead
                break
        time.sleep(0.01)
    with lock:
        assert len(uploaded) >= 3
    p.close()


def test_host_to_device_on_the_cpu():
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)[:, ::2]     # not contiguous
    t = host_to_device(x, torch.device("cpu"))
    assert t.device.type == "cpu" and t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), x)


def test_trainer_make_batch_iterator_respects_depth(tmp_path):
    root = voc_tree(str(tmp_path / "voc"))
    names = []
    for tag, sub, split in (("l", "src", "train"), ("u", "tgt", "train"), ("v", "val", "val")):
        register_pascal_voc(f"tpf_{tag}", f"{root}/{sub}", split, CLASSES)
        names.append(f"tpf_{tag}")
    cfg = get_cfg()
    cfg.merge_from_list(micro_opts(tmp_path / "out", *names) + ["DATALOADER.DEVICE_PREFETCH", "0"])
    tr = PTrainer(cfg)
    raw = iter([])
    assert tr.make_batch_iterator(raw) is raw

    cfg2 = get_cfg()
    cfg2.merge_from_list(micro_opts(tmp_path / "out2", *names))
    tr2 = PTrainer(cfg2)
    tr2.start_iter = 1
    it2 = tr2.make_batch_iterator(iter(tr2.build_train_loader()))
    assert isinstance(it2, DevicePrefetcher)
    b1, b2 = next(it2), next(it2)           # iteration 1 is burn-in, 2 is mutual
    assert "uimg" not in b1 and "uimg" in b2
    assert b1["limg"].image.dtype == torch.uint8 and b1["lgt"].classes.dtype == torch.int32
    it2.close()
