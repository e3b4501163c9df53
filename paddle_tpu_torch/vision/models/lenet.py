"""LeNet (port of paddle_tpu/vision/models/lenet.py): 1 x 28 x 28 NCHW
input, two conv + ReLU + max-pool stages, three linear layers."""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **f),
            nn.ReLU(**f),
            nn.MaxPool2D(2, 2, **f),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **f),
            nn.ReLU(**f),
            nn.MaxPool2D(2, 2, **f),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, **f),
                nn.Linear(120, 84, **f),
                nn.Linear(84, num_classes, **f),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
