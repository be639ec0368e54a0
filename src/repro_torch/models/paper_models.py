"""The paper's own model architectures (Table I), in PyTorch.

The twin of ``repro/models/paper_models.py``:

* GaitFFN — a 5-layer fully-connected network (~32k params) for the
  Human Gait Sensor binary (gender) task.  Client stage = the first
  ``split_layer`` layers, server stage = the rest, ending in one logit.
* ResNet-18 — the CIFAR variant (3x3 stem, no max-pool), split after
  ``split_stage`` residual stages.

The parameter trees keep the JAX layout, leaf for leaf: dicts and lists in
the same nesting, each dict built in sorted key order (the order JAX
flattens it in, so the two packages list the leaves alike), convolution
weights in HWIO, so a JAX tree converts without a permutation and
``tree_bytes`` agrees.  Activations run NCHW:
``resnet_client_apply`` takes the loaders' NHWC images and views them as
NCHW (``channels_last`` in memory), and each convolution views its HWIO
weight as OIHW.

Convolutions pad as XLA's ``"SAME"``: ``ceil(size / stride)`` outputs and
the padding split with the odd element at the end, so a 3x3 stride-2
convolution on an even input pads (0, 1), not torch's symmetric (1, 1).
``_bn`` is the JAX model's per-example, per-channel norm over H and W with
the population variance, and no running statistics.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.wssl_paper import CifarConfig, GaitConfig

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


# ---------------------------------------------------------------------------
# Gait FFN
# ---------------------------------------------------------------------------


def gait_init(gen: torch.Generator, cfg: GaitConfig) -> Params:
    """He-normal weights and zero biases, on ``gen``'s device."""
    dims = (cfg.in_features,) + cfg.hidden + (1,)
    layers = []
    for i in range(len(dims) - 1):
        w = _normal(gen, (dims[i], dims[i + 1]), math.sqrt(2.0 / dims[i]))
        layers.append({"b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                                        device=gen.device), "w": w})
    return {"layers": layers}


def _apply_layers(layers: List[Params], x: torch.Tensor, *,
                  final_is_output: bool) -> torch.Tensor:
    """ReLU between layers; no activation after the network's output layer."""
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if not (final_is_output and i == len(layers) - 1):
            x = F.relu(x)
    return x


def gait_client_apply(cfg: GaitConfig, client_params: Params,
                      x: torch.Tensor) -> torch.Tensor:
    """Client stage on the client-split tree (layers [0, split))."""
    return _apply_layers(client_params["layers"], x, final_is_output=False)


def gait_server_apply(cfg: GaitConfig, server_params: Params,
                      a: torch.Tensor) -> torch.Tensor:
    """Server stage on the server-split tree (layers [split, n))."""
    return _apply_layers(server_params["layers"], a,
                         final_is_output=True)[..., 0]


def gait_split_params(cfg: GaitConfig, params: Params
                      ) -> Tuple[Params, Params]:
    return ({"layers": params["layers"][: cfg.split_layer]},
            {"layers": params["layers"][cfg.split_layer:]})


def gait_join_params(cfg: GaitConfig, client: Params,
                     server: Params) -> Params:
    return {"layers": list(client["layers"]) + list(server["layers"])}


def gait_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits (the paper's sigmoid output)."""
    logit = logit.float()
    return torch.mean(torch.clamp(logit, min=0) - logit * label.float()
                      + torch.log1p(torch.exp(-torch.abs(logit))))


# ---------------------------------------------------------------------------
# ResNet-18 (CIFAR variant: 3x3 stem, no max-pool)
# ---------------------------------------------------------------------------


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int,
               cout: int) -> torch.Tensor:
    return _normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)))


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W), w HWIO -> (B, O, ceil(H / s), ceil(W / s))."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                    padding=(top, left))


def _bn_init(c: int, device) -> Params:
    return {"bias": torch.zeros((c,), dtype=torch.float32, device=device),
            "scale": torch.ones((c,), dtype=torch.float32, device=device)}


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-example, per-channel norm over H and W (GroupNorm-1 style, no
    running statistics), with the population variance."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def _block_init(gen: torch.Generator, cin: int, cout: int,
                stride: int) -> Params:
    p = {"conv1": _conv_init(gen, 3, 3, cin, cout),
         "bn1": _bn_init(cout, gen.device),
         "conv2": _conv_init(gen, 3, 3, cout, cout),
         "bn2": _bn_init(cout, gen.device)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
        p["bnp"] = _bn_init(cout, gen.device)
    return dict(sorted(p.items()))


def _block_apply(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_bn(p["bn1"], _conv(x, p["conv1"], stride)))
    h = _bn(p["bn2"], _conv(h, p["conv2"]))
    sc = x
    if "proj" in p:
        sc = _bn(p["bnp"], _conv(x, p["proj"], stride))
    return F.relu(h + sc)


def resnet_init(gen: torch.Generator, cfg: CifarConfig) -> Params:
    """He-normal convolutions, unit norms, a 1/sqrt(width) head, on
    ``gen``'s device."""
    dev = gen.device
    stem = {"bn": _bn_init(cfg.widths[0], dev),
            "conv": _conv_init(gen, 3, 3, cfg.in_channels, cfg.widths[0])}
    stages = []
    cin = cfg.widths[0]
    for s, (w, nb) in enumerate(zip(cfg.widths, cfg.blocks_per_stage)):
        stage = []
        for b in range(nb):
            stride = 2 if (b == 0 and s > 0) else 1
            stage.append(_block_init(gen, cin, w, stride))
            cin = w
        stages.append(stage)
    fc = {"b": torch.zeros((cfg.num_classes,), dtype=torch.float32,
                           device=dev),
          "w": _normal(gen, (cfg.widths[-1], cfg.num_classes),
                       1.0 / math.sqrt(cfg.widths[-1]))}
    return {"fc": fc, "stages": stages, "stem": stem}


def _resnet_stage_apply(cfg: CifarConfig, stage_params, x: torch.Tensor,
                        s: int) -> torch.Tensor:
    for b, bp in enumerate(stage_params):
        stride = 2 if (b == 0 and s > 0) else 1
        x = _block_apply(bp, x, stride)
    return x


def resnet_client_apply(cfg: CifarConfig, params: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """Stem + stages[:split_stage], the edge device's front end.  x: the
    loaders' NHWC images; returns the cut activation (B, C, H, W)."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_bn(params["stem"]["bn"], _conv(h, params["stem"]["conv"])))
    for s in range(cfg.split_stage):
        h = _resnet_stage_apply(cfg, params["stages"][s], h, s)
    return h


def resnet_server_apply(cfg: CifarConfig, params: Params,
                        a: torch.Tensor) -> torch.Tensor:
    h = a
    for s in range(cfg.split_stage, len(cfg.widths)):
        h = _resnet_stage_apply(cfg, params["stages"][s - cfg.split_stage],
                                h, s)
    h = h.mean(dim=(2, 3))
    return h @ params["fc"]["w"] + params["fc"]["b"]


def resnet_split_params(cfg: CifarConfig, params: Params
                        ) -> Tuple[Params, Params]:
    client = {"stages": params["stages"][: cfg.split_stage],
              "stem": params["stem"]}
    server = {"fc": params["fc"],
              "stages": params["stages"][cfg.split_stage:]}
    return client, server


def resnet_join_params(cfg: CifarConfig, client: Params,
                       server: Params) -> Params:
    return {"fc": server["fc"],
            "stages": list(client["stages"]) + list(server["stages"]),
            "stem": client["stem"]}


def resnet_init_split(gen: torch.Generator, cfg: CifarConfig
                      ) -> Tuple[Params, Params]:
    return resnet_split_params(cfg, resnet_init(gen, cfg))


def softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - gold)
