"""The learning diagnostics of the port: the counterparts of the JAX package's
``scripts/_proxy_common.py``, ``scripts/diagnose_levers.py``,
``scripts/diagnose_student_path.py`` and ``scripts/overfit_check.py``.

Each entry runs as ``python -m probabilisticteacher_torch.diagnostics.<name>`` on
the card, or on the CPU's plain path with ``--device cpu``.
"""
