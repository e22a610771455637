"""Main-path step times of one checkout of the port, for A/B runs.

    python3 ab_steps.py DIR LABEL [main|path2]

imports ``planer_tpu_torch`` and ``chip_smoke`` from the checkout at DIR
(building its kernels into ``DIR/build/ab``), builds the main path as
``chip_smoke.py`` does (INT8 ResNet-18 at 224, seed 0, default fuse, bf16
compute), or with ``path2`` its path 2 (INT8 ResNet-50 at 224,
``fuse="all"``), and prints its step time at batch 1 and 64 twice, with
CUDA events, each line tagged with LABEL and the card's name and power
limit.
Compare two checkouts inside one call, in turns: parent, change, change,
parent (unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists).
"""
from __future__ import annotations

import os
import sys


def main():
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    model, fuse = {"main": ("resnet18", None), "path2": ("resnet50", "all")}[
        sys.argv[3] if len(sys.argv) > 3 else "main"]
    sys.path.insert(0, root)
    os.environ["PLANER_TORCH_BUILD_DIR"] = os.path.join(root, "build", "ab")
    import torch
    import chip_smoke as cs
    import planer_tpu_torch
    from planer_tpu_torch import models
    from planer_tpu_torch.models.eval import synthetic_images
    from planer_tpu_torch.ops.kernels import build
    from planer_tpu_torch.quant import calibrate_act_scales
    if not torch.cuda.is_available():
        sys.exit("ab_steps: no CUDA device")
    if not planer_tpu_torch.__file__.startswith(root):
        sys.exit(f"ab_steps: imported {planer_tpu_torch.__file__}, not {root}")
    build.build()
    torch.manual_seed(cs.SEED)
    net = cs.build_net(models, calibrate_act_scales, synthetic_images,
                       model, fuse)
    requests = {b: next(synthetic_images(b, (3, 224, 224), seed=100 + b,
                                         batch=b)) for b in (1, 64)}
    card = cs.card_line()
    for rep in range(2):
        cs.step_times(torch, net, requests, f"AB {label} rep{rep}", card)


if __name__ == "__main__":
    main()
