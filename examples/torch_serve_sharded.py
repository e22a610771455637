"""Demo: sharded serving with the PyTorch port — the pieces compose as:

  multihost.initialize()    -> torch.distributed bring-up (timeout-guarded)
  make_mesh + shard_program -> weights TP-sharded, batch DP over the mesh
  ServingEngine             -> continuous batching into the sharded program
  health_check              -> per-device liveness

    python examples/torch_serve_sharded.py [--device cpu]

The mesh is 8 repeated devices: ``cuda:0`` by default, the CPU with
``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import planer_tpu_torch as pt
from planer_tpu_torch import models
from planer_tpu_torch.parallel import make_mesh, shard_program
from planer_tpu_torch.parallel.multihost import health_check

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# on several hosts: pt.parallel.multihost.initialize(timeout_s=120)
net = models.resnet50(num_classes=128, device=dev)
net.quantize("int8")
mesh = make_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
shard_program(net, mesh)

print("health:", health_check(deadline_s=30)["healthy"])
with pt.ServingEngine(net, buckets=(4, 8, 16), max_delay_ms=10) as eng:
    futs = [eng.submit(np.random.randn(3, 64, 64).astype(np.float32))
            for _ in range(24)]
    outs = [f.result() for f in futs]
    print("served", len(outs), "requests on mesh", dict(mesh.shape))
    print("stats:", eng.stats())
