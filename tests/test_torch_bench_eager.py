"""The bench's smoke mutual step against JAX's op-by-op run of the same step.

At the smoke shapes the RPN's anchor matching ties in real numbers, and XLA's fused
step breaks the ties differently from op-by-op arithmetic (``test_torch_bench.py``),
so the jitted comparison there leaves the RPN's losses out. The port computes op by
op, and so does JAX under ``jax.disable_jit``: that run is the witness for the
supervised RPN's losses and anchor counts, and for the total loss less the
unsupervised RPN's losses, within rtol 1e-4 (``test_torch_train_step.py``'s
tolerance). The unsupervised RPN stays out: it matches anchors to the teacher's
pseudo boxes, which come out of the teacher's network with the two packages' rounding
in them, so its ties fall differently again (JAX's own jitted and op-by-op runs of
this step differ there by 10-13%).

Op by op, JAX compiles each primitive at each shape once: the step takes about three
and a half minutes on a CPU, so it has a file of its own, beside the quicker checks.
"""

import jax
import numpy as np

from test_torch_bench import RPN_MATCHED, jax_build, port_smoke_step  # noqa: F401

RPN_UNSUP = ("loss_rpn_cls_unsup", "loss_rpn_loc_unsup")
RPN_SUP = tuple(k for k in RPN_MATCHED if k not in RPN_UNSUP)


def test_smoke_step_rpn_matches_jax_op_by_op(jax_build):  # noqa: F811
    key = jax.random.key(0)
    jl, jgt, ju = jax_build["batches"]
    with jax.disable_jit():
        _, jm = jax_build["mutual"](jax_build["state"], jl, jgt, ju, key)
    jm = {k: float(v) for k, v in jm.items()}
    _, tm = port_smoke_step(jax_build, key)
    assert set(tm) == set(jm)
    for k in set(jm) - set(RPN_UNSUP) - {"total_loss"}:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in RPN_SUP:
        assert k in jm and np.isfinite(tm[k]) and tm[k] > 0, k

    def sup_total(m):
        return m["total_loss"] - sum(m[k] for k in RPN_UNSUP)

    np.testing.assert_allclose(sup_total(tm), sup_total(jm), rtol=1e-4, atol=1e-6)
