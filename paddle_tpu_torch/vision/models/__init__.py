"""The ResNet family (ref paddle_tpu/vision/models)."""

from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, SpaceToDepthStem, fold_conv7_stem,
    resnet18, resnet34, resnet50, resnet101, resnet152, resnext50_32x4d,
    wide_resnet50_2, wide_resnet101_2,
)
