"""The paper's own two model/dataset configurations (Table I).

* Human Gait Sensor: a 5-layer feed-forward network (~32k params), binary
  gender classification over 28 sensor features; client stage = first 2
  layers, server stage = last 3 (paper §V-C-1).
* CIFAR-10: ResNet-18 (11.7M params) split at a cut-off inside the
  residual stack; client stage = stem + early blocks (paper §V-C-2).

Real datasets are gated offline; ``repro_torch.data.synthetic`` provides
shape-matched generators with controllable non-IID skew.  A copy of
``repro/configs/wssl_paper.py`` (the port imports nothing of ``repro``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class GaitConfig:
    """5-layer FFN, ~32k params (Table I row 1)."""

    name: str = "wssl-gait-ffn"
    in_features: int = 28
    hidden: Tuple[int, ...] = (96, 96, 96, 64)   # 4 hidden + 1 output = 5 layers
    num_classes: int = 2
    split_layer: int = 2            # client = layers [0,2), server = [2,5)
    batch_size: int = 128

    def param_count(self) -> int:
        dims = (self.in_features,) + self.hidden + (1,)
        return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))


@dataclass(frozen=True)
class CifarConfig:
    """ResNet-18 for 32x32x10-class images (Table I row 2)."""

    name: str = "wssl-cifar-resnet18"
    image_size: int = 32
    in_channels: int = 3
    num_classes: int = 10
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2)
    # split after this many residual stages: client = stem + stages[:split],
    # server = stages[split:] + pool + fc   (paper's "cut-off point", §V-C-2)
    split_stage: int = 1
    batch_size: int = 128


@dataclass(frozen=True)
class CifarLiteConfig(CifarConfig):
    """Reduced ResNet for CPU-budget experiments (same family/topology)."""

    name: str = "wssl-cifar-resnet-lite"
    widths: Tuple[int, ...] = (16, 32, 64, 128)
    blocks_per_stage: Tuple[int, ...] = (1, 1, 1, 1)
