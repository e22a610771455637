"""Multi-device support of the port — the counterpart of
``planer_tpu/parallel``: DP x TP sharding over a device mesh
(``sharding``), H-axis spatial sharding (``spatial``), multi-host bring-up
and device health (``multihost``) and the request-plane dispatcher that
serves one model from several worker processes or hosts (``dispatcher``).
"""
from .sharding import (make_mesh, param_shardings, input_sharding,
                       shard_program)

__all__ = ["make_mesh", "param_shardings", "input_sharding", "shard_program"]
