"""ResNet family (counterpart of paddle_tpu/vision/models/resnet.py).

The same BasicBlock/BottleneckBlock structure, layer counts, parameter and
buffer names as the reference (``layer1.0.conv1.weight``,
``layer1.0.downsample.1._mean``, ``fc.weight`` ...), so ``convert`` carries
weights across.  ``data_format="NHWC"`` selects the channels-last layout;
in NHWC training on a CUDA input (or under ``_fused_resnet.FORCE``),
bottleneck blocks take the fused path (``_fused_resnet.py``,
``ops/fused_conv_bn.py``): bn2's normalise + ReLU folds into conv3's input
read, BN batch statistics come from the kernels' epilogues, and the
backward runs the combined dX/dW/statistics kernel.  Everything else (eval,
NCHW, BasicBlock models, widths the kernels do not admit) runs the composed
layers, as in the reference; the choice is made from shapes before any
launch.

``resnet50(num_classes=1000, data_format="NHWC", device=None, dtype=None)``
builds on ``device`` (default cuda, which raises without it; pass "cpu" for
the CPU) in ``dtype`` (parameters and buffers, as the reference's
``model.bfloat16()`` casts both), with the reference's initializers on the
global torch RNG; ``init_weights(generator)`` re-draws them from a seeded
generator.  ``pretrained=True`` raises: no weights are shipped, load the
reference's with ``paddle_tpu_torch.convert.load_reference_state``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from ... import nn
from ...core.device import resolve_device


def _fused_path_ok(model, x):
    """NHWC + training + bottleneck blocks + (a CUDA input, or FORCE) +
    aligned input + every block's 1x1 convs admissible to the fused kernel.
    Nonstandard widths (e.g. base_width not a multiple of 64) take the
    composed forward instead of raising mid-forward."""
    from . import _fused_resnet as FR

    if model._data_format != "NHWC" or not model.training:
        return False
    if not FR.FORCE and not x.is_cuda:
        return False
    if x.dtype not in (torch.bfloat16, torch.float32):
        return False
    shape = x.shape
    if not (len(shape) == 4 and shape[3] == 3
            and shape[1] % 32 == 0 and shape[2] % 32 == 0):
        return False
    return _fused_blocks_supported(model)


def _fused_blocks_supported(model):
    """Per-block channel alignment for the fused path: conv1/conv3 of every
    bottleneck must pass ops.fused_conv_bn.supported.  Cached on the model:
    channel widths are fixed at construction."""
    ok = model.__dict__.get("_fused_blocks_ok")
    if ok is None:
        from ...ops.fused_conv_bn import supported

        ok = True
        for stage in (model.layer1, model.layer2, model.layer3, model.layer4):
            for block in stage:
                for conv in (block.conv1, block.conv3):
                    cout, cin = int(conv.weight.shape[0]), int(conv.weight.shape[1])
                    if not supported((1, 1, 8, cin), (1, 1, cin, cout)):
                        ok = False
        model.__dict__["_fused_blocks_ok"] = ok
    return ok


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW", *,
                 device=None):
        super().__init__()
        kw = dict(data_format=data_format, device=device)
        norm_layer = norm_layer or functools.partial(nn.BatchNorm2D, **kw)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                               bias_attr=False, **kw)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False, **kw)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW", *,
                 device=None):
        super().__init__()
        kw = dict(data_format=data_format, device=device)
        norm_layer = norm_layer or functools.partial(nn.BatchNorm2D, **kw)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation, stride=stride,
                               groups=groups, dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self._groups = groups
        self._stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def forward_fused(self, x, wv_in, wv_out, wp_out):
        """NHWC fused fast path (see module docstring).  x: [N, H, W'_in, C]
        with zero pad columns; returns the block output at [N, Ho, W'_out,
        C'] and updates the four BatchNorms' running statistics."""
        from . import _fused_resnet as FR

        eps = float(self.bn1._epsilon)
        N, H = x.shape[0], x.shape[1]
        Ho = H // self._stride
        cnt_out = N * Ho * wv_out
        if self.downsample is not None:
            convd, bnd = self.downsample[0], self.downsample[1]
            identity, md, vd = FR.downsample_step(
                x, convd.weight, bnd.weight, bnd.bias, stride=self._stride, wv_out=wv_out,
                wp_out=wp_out, eps=float(bnd._epsilon))
            FR.update_running_stats(bnd, md, vd, cnt_out)
        else:
            identity = x
        z, m1, v1, m2, v2, m3, v3 = FR.bottleneck_step(
            x, identity, self.conv1.weight, self.bn1.weight, self.bn1.bias,
            self.conv2.weight, self.bn2.weight, self.bn2.bias,
            self.conv3.weight, self.bn3.weight, self.bn3.bias,
            stride=self._stride, groups=self._groups, wv_in=wv_in, wv_out=wv_out,
            wp_out=wp_out, eps=eps)
        FR.update_running_stats(self.bn1, m1, v1, N * H * wv_in)
        FR.update_running_stats(self.bn2, m2, v2, cnt_out)
        FR.update_running_stats(self.bn3, m3, v3, cnt_out)
        return z


class ResNet(tnn.Module):
    """Ref resnet.py ResNet(Block, depth)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True,
                 groups=1, data_format="NCHW", *, device=None, dtype=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._data_format = data_format
        self._device = dev
        self._norm_layer = functools.partial(nn.BatchNorm2D, data_format=data_format,
                                             device=dev)
        self._block_cls = block
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, data_format=data_format, device=dev)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1, data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, device=dev)
        if dtype is not None:
            self.to(dtype=dtype)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        kw = dict(data_format=self._data_format, device=self._device)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                          bias_attr=False, **kw),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, 1, norm_layer, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, norm_layer=norm_layer, **kw))
        return nn.Sequential(*layers)

    @property
    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator=None):
        """Re-draw every parameter with the reference's initializers
        (Kaiming-uniform convs, Xavier-normal fc, ones/zeros BatchNorm) from
        ``generator``; the running statistics go back to zeros and ones."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2D, nn.Linear, nn.BatchNorm2D)):
                m.reset_parameters(generator=generator)
            if isinstance(m, nn.BatchNorm2D):
                m._mean.zero_()
                m._variance.fill_(1.0)
        return self

    def _forward_fused(self, x):
        """NHWC fast path: stem + fused bottleneck stages + masked head."""
        from . import _fused_resnet as FR

        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        wv = x.shape[2]  # 56 for a 224 input; the gate guarantees w0 % 8 == 0
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                stride = block._stride
                wv_out = wv // stride
                wp_out = wv_out if wv_out % 8 == 0 else wv_out + (8 - wv_out % 8)
                x = block.forward_fused(x, wv, wv_out, wp_out)
                wv = wv_out
        if self.with_pool:
            x = FR.masked_gap(x, wv=wv)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x

    def forward(self, x):
        if self._block_cls is BottleneckBlock and _fused_path_ok(self, x):
            return self._forward_fused(x)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not shipped with paddle_tpu_torch: build the model "
            "and load the reference's state with paddle_tpu_torch.convert."
            "load_reference_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=64, width=4, **kwargs)
