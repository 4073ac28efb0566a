"""LeNet, the model of the JAX package's ``mnist`` row: the port of
``paddle_tpu/vision/models/lenet.py``."""
from __future__ import annotations

from ... import nn
from ...device import resolve_device
from ...nn.layer import Layer

__all__ = ["LeNet"]


class LeNet(Layer):
    """Two conv / relu / max-pool stages and three Linear layers over a
    1 x 28 x 28 image; ``num_classes=0`` keeps the features only.  Runs on
    ``cuda`` unless ``device="cpu"``."""

    def __init__(self, num_classes: int = 10, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, device=dev),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, device=dev),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Flatten(),
                nn.Linear(400, 120, device=dev),
                nn.Linear(120, 84, device=dev),
                nn.Linear(84, num_classes, device=dev),
            )

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
