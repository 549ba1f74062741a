"""The LM stack (a port of ``repro.models``): ``config``, ``layers``,
``ssm``, ``model`` and ``lm_engine``.  Quarantined from the simulator's
live tree (``analysis_torch.cfg``) as ``repro.models`` is from ``repro``'s.
"""
