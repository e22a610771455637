"""Demo: ResNet-18 classification with the PyTorch port (reference
readme.md:58-82 flow).

    python examples/torch_classify_resnet.py [--device cpu]

Builds the native ResNet-18, quantizes its weights to INT8 with bf16
compute, and classifies a synthetic image on the CUDA card (``--device
cpu`` for the CPU).  Swap in ``pt.read_net("resnet18.onnx", device=...)``
or ``pt.torch2planer(torchvision_model, "resnet18")`` for real weights.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from planer_tpu_torch import models


def main(device="cuda"):
    """The 1000 logits of one synthetic 224 image."""
    net = models.resnet18(device=device)
    net.quantize("int8").astype_compute("bfloat16")
    x = next(models.eval.synthetic_images(1, (3, 224, 224), seed=7, batch=1))
    return np.asarray(net(x))[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    logits = main(ap.parse_args().device)
    top5 = np.argsort(-logits)[:5]
    print("top-5 class ids:", top5.tolist())
    print("top-5 scores  :", np.round(logits[top5], 3).tolist())
