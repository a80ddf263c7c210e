"""Multi-device execution: the (scenario × proc) mesh of ``parallel.mesh``
and the hand-written all-gather of ``parallel.ici`` (the port of
round_tpu/parallel)."""
