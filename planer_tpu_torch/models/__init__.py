"""Model builders of the port (the JAX package's zoo: ResNet-18/50, UNet,
YOLO-v3; and the port's own ConvNeXt), YOLO's host post-processing and the
evaluation harness."""
from .builder import GraphBuilder
from .convnext import convnext, convnext_base
from .resnet import resnet18, resnet50
from .unet import unet
from .yolov3 import yolov3, YOLO_ANCHORS
from . import eval
from . import yolo_post

__all__ = ["GraphBuilder", "convnext", "convnext_base", "resnet18",
           "resnet50", "unet", "yolov3", "YOLO_ANCHORS", "yolo_post", "eval"]
