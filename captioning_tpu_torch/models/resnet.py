"""ResNet image encoder for feature extraction.

Port of ``captioning_tpu/models/resnet.py``: the reference's torchvision
ResNet with its ``myResnet`` pooling head as a PyTorch module (NCHW) that
loads torchvision ``.pth`` ``state_dict``s as they are (OIHW).

Reference quirks kept:
* maxpool 3x3 stride 2 pad 0 in **ceil mode**;
* the first bottleneck of layers 2-4 puts its stride on conv1 (a 1x1),
  not on conv2 (caffe-style);
* BatchNorm in eval mode, eps 1e-5;
* head: ImageNet normalisation in, then ``fc`` = the mean of layer4 and
  ``att`` = its adaptive 14x14 average pool (torch's bins), channels-last.

The convolutions are ``F.conv2d`` (cuDNN on the card): the JAX package
computes them with ``lax.conv_general_dilated``, outside any Pallas
kernel.  ``resnet_features`` runs in float32 with TF32 off whatever the
global switches say, so that its features match the CPU's.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

RESNET_LAYERS = {'resnet18': [2, 2, 2, 2], 'resnet34': [3, 4, 6, 3],
                 'resnet50': [3, 4, 6, 3], 'resnet101': [3, 4, 23, 3],
                 'resnet152': [3, 8, 36, 3]}
BOTTLENECK = {'resnet50', 'resnet101', 'resnet152'}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = _bn(width)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck with the stride on conv1."""
    expansion = 4

    def __init__(self, cin, width, stride=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(cin, width, 1, stride)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = _bn(width * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """The trunk of torchvision's ResNet ``arch`` under its parameter
    names (its classifier ``fc`` too, which loads and is never run)."""

    def __init__(self, arch: str = 'resnet101'):
        super().__init__()
        if arch not in RESNET_LAYERS:
            raise ValueError('unknown ResNet %r (one of %s)'
                             % (arch, sorted(RESNET_LAYERS)))
        block = Bottleneck if arch in BOTTLENECK else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for li, n_blocks in enumerate(RESNET_LAYERS[arch], start=1):
            width = 64 * 2 ** (li - 1)
            stride = 1 if li == 1 else 2
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                down = None
                if bi == 0 and (s != 1 or cin != width * block.expansion):
                    down = nn.Sequential(
                        nn.Conv2d(cin, width * block.expansion, 1, s,
                                  bias=False),
                        _bn(width * block.expansion))
                blocks.append(block(cin, width, s, down))
                cin = width * block.expansion
            setattr(self, 'layer%d' % li, nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, 1000)

    def forward(self, x):
        """x: [N, 3, H, W], ImageNet-normalised.  Returns layer4's map
        [N, C, h, w]."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
        for li in range(1, 5):
            x = getattr(self, 'layer%d' % li)(x)
        return x


@contextlib.contextmanager
def _no_tf32():
    """Float32 convolutions and products without TF32, restoring the
    global switches after."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@torch.inference_mode()
def resnet_features(model: ResNet, img, att_size: int = 14):
    """img: [H, W, 3] float in [0, 1] (numpy or a tensor).  Returns (fc
    [C], att [att_size, att_size, C]) on the model's device: the
    reference ``myResnet.forward`` after the callers' ImageNet
    normalisation."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(img, np.float32)).to(dev)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    x = ((x - mean) / std).permute(2, 0, 1)[None]
    with _no_tf32():
        y = model(x)
    fc = y.mean((2, 3))[0]
    att = F.adaptive_avg_pool2d(y, att_size)[0].permute(1, 2, 0)
    return fc, att


def load_resnet(path: str, arch: str = 'resnet101', device='cuda'
                ) -> ResNet:
    """A torchvision ``.pth`` ``state_dict`` at ``path`` into an eval
    ``ResNet`` on ``device`` (float32)."""
    if (torch.device(device).type == 'cuda'
            and not torch.cuda.is_available()):
        raise RuntimeError("device 'cuda': no CUDA device is available "
                           "(pass device='cpu')")
    model = ResNet(arch)
    model.load_state_dict(torch.load(path, map_location='cpu'))
    return model.to(device).eval().requires_grad_(False)


def state_dict_from_jax_resnet(params: Dict[str, np.ndarray],
                               arch: str = 'resnet101'):
    """The JAX package's ``load_torch_resnet`` dict (conv kernels HWIO) as
    the port's ``state_dict`` (OIHW).  A missing or stray key raises; the
    BatchNorms' ``num_batches_tracked``, which old torchvision files lack,
    may be missing."""
    want = ResNet(arch).state_dict()
    stray = sorted(set(params) - set(want))
    missing = sorted(k for k in set(want) - set(params)
                     if not k.endswith('num_batches_tracked'))
    if stray or missing:
        raise KeyError('%s weights: stray keys %s, missing keys %s'
                       % (arch, stray[:5], missing[:5]))
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if a.ndim == 4:           # conv HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(a, dtype=want[k].dtype)
    return out


def random_state_dict(arch: str, generator: torch.Generator):
    """Seeded random weights in the torchvision layout, for tests and the
    smoke run (no ImageNet weights ship with the repository): He-normal
    convolutions, BatchNorm scales and running statistics drawn near
    their identity, each residual branch's last BatchNorm scaled down so
    the activations stay of order one through the depth."""
    model = ResNet(arch)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith('num_batches_tracked'):
            sd[k] = v
            continue
        u = torch.rand(v.shape, generator=generator)
        if v.dim() == 4:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            sd[k] = torch.randn(v.shape, generator=generator) * (
                2.0 / fan_in) ** 0.5
        elif k.endswith('running_var'):
            sd[k] = 0.5 + u
        elif k.endswith('running_mean') or k.endswith('.bias'):
            sd[k] = 0.2 * (u - 0.5)
        elif k.endswith('.weight') and k.startswith('fc'):
            sd[k] = 0.02 * (u - 0.5)
        else:                     # BatchNorm scales
            last = k.endswith(('bn2.weight', 'bn3.weight')) and (
                ('bn3' in k) == (arch in BOTTLENECK))
            sd[k] = (0.1 if last else 1.0) * (0.5 + u)
    return sd
