"""Example zoo package for the PyTorch port (the `planer_zoo.*` packaging
convention, reference __init__.py:116-141): a readme.md manifest table lists
the model files; `planer_tpu_torch.Model(this_module)` attaches
source/list_source/download and auto-loads.

This example generates its model locally on first load (no network), which
doubles as the air-gapped deployment pattern: pre-populate the cache dir.
``main()`` does that and loads the net on the CUDA card (``device="cpu"``
for the CPU)::

    sys.path.insert(0, "examples")
    import torch_planer_zoo_example as pkg
    net = pkg.main()
"""
import os
import sys

import numpy as np

root = None  # set by Model() to ~/.planer_zoo/torch_planer_zoo_example

# explicit manifest (overrides readme.md parsing when present):
# [name, required, url]  — empty url means "fetch from package dir"
source = [["resnet18_tiny.pla", True,
           "http://example.invalid/resnet18_tiny.pla"]]

_net = None


def _ensure_local():
    """Air-gapped fallback: materialize the model into the cache dir."""
    path = os.path.join(root, "resnet18_tiny")
    if not os.path.exists(path + ".pla"):
        from planer_tpu_torch import models, io
        os.makedirs(root, exist_ok=True)
        # models.resnet18 makes its weights as host arrays: writing them
        # needs no device
        net = models.resnet18(num_classes=10, device="cpu")
        io.save_pla(path, net.graph, net.weights)
    return path


def load(device="cuda"):
    global _net
    from planer_tpu_torch import read_net
    _net = read_net(_ensure_local(), device=device)
    return _net


def predict(x: np.ndarray) -> np.ndarray:
    assert _net is not None, "call load() first (Model(auto=True) does)"
    return np.asarray(_net(x))


def main(device="cuda"):
    """Attach this package through the zoo (its cache dir under
    ``planer_tpu_torch.utils.zoo.root``), write the model there if it is
    absent, and load it on ``device``; returns the net."""
    from planer_tpu_torch import Model
    Model(sys.modules[__name__], auto=False)
    return load(device)
