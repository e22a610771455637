"""Model builders of the port (the ResNets of the JAX package's zoo)."""
from .builder import GraphBuilder
from .resnet import resnet18, resnet50
from . import eval

__all__ = ["GraphBuilder", "resnet18", "resnet50", "eval"]
