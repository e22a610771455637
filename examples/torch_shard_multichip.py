"""Demo: DP x TP sharding over a device mesh with the PyTorch port.

    python examples/torch_shard_multichip.py [--device cpu]

The mesh is 8 repeated devices: ``cuda:0`` by default, the CPU with
``--device cpu`` (a (2, 4) mesh of one card runs the same plan as eight).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from planer_tpu_torch import models
from planer_tpu_torch.parallel import make_mesh, shard_program

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

net = models.resnet18(num_classes=64, device=dev)
net.quantize("int8")
mesh = make_mesh((2, 4), ("data", "model"), devices=[dev] * 8)
shard_program(net, mesh)
x = np.random.randn(8, 3, 64, 64).astype(np.float32)
out = net(x)
print("mesh:", dict(mesh.shape), "out:", out.shape)
