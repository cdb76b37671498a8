"""The pipeline doctor — counterpart of ``denormalized_tpu/obs/doctor/``.
Only the closed control loop of the join (:mod:`.actions`) is ported."""
