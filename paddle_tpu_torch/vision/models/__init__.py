"""The model zoo of the port: LeNet, ResNet and ResNeXt (the other
families of ``paddle_tpu/vision/models/`` are not ported yet)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2, wide_resnet101_2)
from .resnext import (ResNeXt, resnext50_32x4d, resnext50_64x4d,  # noqa: F401
                      resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
                      resnext152_64x4d)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "ResNeXt",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]
