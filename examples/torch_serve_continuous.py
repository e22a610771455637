"""Demo: continuous-batching serving front end with shape buckets, with the
PyTorch port: the batches run on the CUDA card.

    python examples/torch_serve_continuous.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import planer_tpu_torch as pt
from planer_tpu_torch import models


def main(device="cuda", imgs=None):
    """Serve ``imgs`` (32 random 3 x 64 x 64 images from numpy's global
    RNG by default); returns the answers in request order and
    ``stats()``."""
    net = models.resnet18(num_classes=100, device=device)
    eng = pt.ServingEngine(net, buckets=(1, 2, 4, 8), max_delay_ms=10)
    try:
        if imgs is None:
            imgs = [np.random.randn(3, 64, 64).astype(np.float32)
                    for _ in range(32)]
        futs = [eng.submit(im) for im in imgs]
        outs = [f.result() for f in futs]
        return outs, eng.stats()
    finally:
        eng.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    outs, stats = main(ap.parse_args().device)
    print("served", len(outs), "requests;", "stats:", stats)
