"""Demo: UNet segmentation with tiled big-image inference with the PyTorch
port (reference tile() pattern, util.py:291-348): each window runs on the
CUDA card, the blend on the host.

    python examples/torch_segment_unet_tiled.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import planer_tpu_torch as pt
from planer_tpu_torch import models

SHAPE = (700, 900)


def run_window(img2d, net):
    out = np.asarray(net(img2d[None, None]))
    return out[0, 0]


def main(device="cuda"):
    """The (700, 900) mask of a random image, in windows of 256."""
    net = models.unet(in_ch=1, out_ch=1, base=16, depth=3, device=device)

    big = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)

    seg = pt.tile(window=256, margin=24, glob=8)(run_window)
    return seg(big, net)          # tile passes net on to each window


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    mask = main(ap.parse_args().device)
    print("input ", SHAPE, "-> mask", mask.shape,
          "range [%.3f, %.3f]" % (mask.min(), mask.max()))
