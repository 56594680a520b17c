"""CPU tests of the benchmark: they put ``benchmark/`` and the repository root on the
path, and keep TensorBoard (whose import pulls in TensorFlow on some hosts) out of
the trainer."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]
sys.modules.setdefault("torch.utils.tensorboard", None)
