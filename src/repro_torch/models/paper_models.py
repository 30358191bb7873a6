"""The paper's Table 1 benchmark models, as eager Modules.

Counterpart of ``repro/models/paper_models.py``: AlexNet, VGG-19,
ResNet-50, MobileNet(v1) — images/sec; GNMTv2 — tokens/sec; NCF (NeuMF)
— samples/sec.  Same architectures, layer for layer, and the same
initializers, so ``repro_torch.manual_seed(s)`` then ``ResNet50()``
gives the reference's weights.
"""

from __future__ import annotations

from typing import List, Optional

from ..core import tensor_mod as T
from ..core.tensor import Tensor
from .. import nn
from ..nn import functional as F


# ----------------------------------------------------------------------
# AlexNet (Krizhevsky 2012, torchvision layout)
# ----------------------------------------------------------------------

class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x: Tensor) -> Tensor:
        x = self.features(x)
        x = self.avgpool(x)
        return self.classifier(x.flatten(1))


# ----------------------------------------------------------------------
# VGG-19
# ----------------------------------------------------------------------

_VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class VGG19(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        layers: List[nn.Module] = []
        in_ch = 3
        for v in _VGG19:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU()]
                in_ch = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x: Tensor) -> Tensor:
        x = self.features(x)
        x = self.avgpool(x)
        return self.classifier(x.flatten(1))


# ----------------------------------------------------------------------
# ResNet-50
# ----------------------------------------------------------------------

class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample or nn.Identity()

    def forward(self, x: Tensor) -> Tensor:
        identity = self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        self.layer1 = self._make_layer(64, 3)
        self.layer2 = self._make_layer(128, 4, stride=2)
        self.layer3 = self._make_layer(256, 6, stride=2)
        self.layer4 = self._make_layer(512, 3, stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(512 * 4, num_classes)

    def _make_layer(self, planes: int, blocks: int,
                    stride: int = 1) -> nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes * 4:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride,
                          bias=False),
                nn.BatchNorm2d(planes * 4),
            )
        layers = [Bottleneck(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * 4
        layers += [Bottleneck(self.inplanes, planes)
                   for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x: Tensor) -> Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x).flatten(1)
        return self.fc(x)


# ----------------------------------------------------------------------
# MobileNet v1 (depthwise-separable)
# ----------------------------------------------------------------------

def _dw_block(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(in_ch, in_ch, 3, stride=stride, padding=1, groups=in_ch,
                  bias=False),
        nn.BatchNorm2d(in_ch), nn.ReLU(),
        nn.Conv2d(in_ch, out_ch, 1, bias=False),
        nn.BatchNorm2d(out_ch), nn.ReLU(),
    )


class MobileNet(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
               (1024, 2), (1024, 1)]
        layers: List[nn.Module] = [
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False),
            nn.BatchNorm2d(32), nn.ReLU(),
        ]
        in_ch = 32
        for out_ch, stride in cfg:
            layers.append(_dw_block(in_ch, out_ch, stride))
            in_ch = out_ch
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x: Tensor) -> Tensor:
        x = self.features(x)
        return self.fc(self.avgpool(x).flatten(1))


# ----------------------------------------------------------------------
# GNMTv2 (seq2seq LSTM with attention; tokens/sec benchmark)
# ----------------------------------------------------------------------

class BahdanauAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim, bias=False)
        self.k = nn.Linear(dim, dim, bias=False)
        self.v = nn.Linear(dim, 1, bias=False)

    def forward(self, query: Tensor, keys: Tensor) -> Tensor:
        # query (B, Sq, D), keys (B, Sk, D); with the fusion queue on,
        # the add -> tanh over (B, Sq, Sk, D) is one fused chain
        scores = self.v(F.tanh(self.q(query).unsqueeze(2)
                               + self.k(keys).unsqueeze(1))).squeeze(-1)
        weights = F.softmax(scores, dim=-1)          # (B, Sq, Sk)
        return weights @ keys


class GNMT(nn.Module):
    """4-layer encoder (1 bidir) / 4-layer decoder with attention —
    GNMTv2 structure at configurable width."""

    def __init__(self, vocab: int = 32000, hidden: int = 1024,
                 layers: int = 4):
        super().__init__()
        self.embed_src = nn.Embedding(vocab, hidden)
        self.embed_tgt = nn.Embedding(vocab, hidden)
        self.enc_bidir = nn.LSTM(hidden, hidden, 1, bidirectional=True)
        self.enc_proj = nn.Linear(2 * hidden, hidden, bias=False)
        self.enc_stack = nn.LSTM(hidden, hidden, layers - 1)
        self.attention = BahdanauAttention(hidden)
        self.dec_stack = nn.LSTM(2 * hidden, hidden, layers)
        self.out = nn.Linear(hidden, vocab)

    def forward(self, src: Tensor, tgt: Tensor) -> Tensor:
        enc = self.embed_src(src)
        enc, _ = self.enc_bidir(enc)
        enc = self.enc_proj(enc)
        enc, _ = self.enc_stack(enc)
        dec_in = self.embed_tgt(tgt)
        ctx = self.attention(dec_in, enc)            # (B, St, D)
        dec, _ = self.dec_stack(T.cat([dec_in, ctx], dim=-1))
        return self.out(dec)


# ----------------------------------------------------------------------
# NCF / NeuMF (samples/sec benchmark)
# ----------------------------------------------------------------------

class NCF(nn.Module):
    def __init__(self, n_users: int = 138_000, n_items: int = 27_000,
                 mf_dim: int = 64, mlp_dims=(256, 256, 128, 64)):
        super().__init__()
        self.user_mf = nn.Embedding(n_users, mf_dim)
        self.item_mf = nn.Embedding(n_items, mf_dim)
        self.user_mlp = nn.Embedding(n_users, mlp_dims[0] // 2)
        self.item_mlp = nn.Embedding(n_items, mlp_dims[0] // 2)
        mlp: List[nn.Module] = []
        for i in range(len(mlp_dims) - 1):
            mlp += [nn.Linear(mlp_dims[i], mlp_dims[i + 1]), nn.ReLU()]
        self.mlp = nn.Sequential(*mlp)
        self.head = nn.Linear(mf_dim + mlp_dims[-1], 1)

    def forward(self, users: Tensor, items: Tensor) -> Tensor:
        mf = self.user_mf(users) * self.item_mf(items)
        mlp = self.mlp(T.cat([self.user_mlp(users), self.item_mlp(items)],
                             dim=-1))
        return self.head(T.cat([mf, mlp], dim=-1)).squeeze(-1)


PAPER_MODELS = {
    "alexnet": AlexNet,
    "vgg19": VGG19,
    "resnet50": ResNet50,
    "mobilenet": MobileNet,
    "gnmt": GNMT,
    "ncf": NCF,
}
