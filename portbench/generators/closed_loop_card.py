"""One closed-loop client whose answers stay on the card
(``"generator": "closed_loop_card"``): the keys, pool, sample and loop of
``closed_loop``, but each call is ``forward(x)`` (the port's entry with
device tensors out, as a caller that decodes and filters the answer on the
card calls it) followed by a synchronize of the answer's device, so each
call is timed from submit to its answer complete on the card.  The sampled
answers stay device tensors."""
from __future__ import annotations

import torch

from . import closed_loop


def make(traffic: dict, make_inputs, seed: int):
    return ClosedLoopCard(traffic, make_inputs, seed)


def _forward(net):
    def call(x):
        y = net.forward(x)
        first = y[0] if isinstance(y, (tuple, list)) else y
        if first.is_cuda:
            torch.cuda.synchronize(first.device)
        return y
    return call


class ClosedLoopCard(closed_loop.ClosedLoop):
    def warm(self, net):
        super().warm(_forward(net))

    def run(self, net, seconds: float, span=None):
        return super().run(_forward(net), seconds, span)
