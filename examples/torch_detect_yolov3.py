"""Demo: YOLO-v3 detection with the PyTorch port — the multi-scale heads on
the CUDA card, box decode + native C++ NMS on the host.

    python examples/torch_detect_yolov3.py [--device cpu] [--size 416]

``--size`` sets the square input side (a multiple of 32).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from planer_tpu_torch import models, native


def main(device="cuda", size=416):
    """The detections of one synthetic image: a list with one (n, 6) array
    of rows [x1 y1 x2 y2 score class]."""
    net = models.yolov3(device=device)          # 80 classes, random weights
    img = next(models.eval.synthetic_images(1, (3, size, size), seed=3,
                                            batch=1))
    return models.yolo_post.detect(net, img, conf_thresh=0.3)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=416)
    args = ap.parse_args()
    dets = main(args.device, args.size)
    print(f"native NMS: {native.available()}")
    print(f"{len(dets[0])} detections: [x1 y1 x2 y2 score class]")
    for row in dets[0][:10]:
        print(np.round(row, 1))
