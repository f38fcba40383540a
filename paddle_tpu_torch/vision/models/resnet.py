"""ResNet family (counterpart of paddle_tpu/vision/models/resnet.py).

``space_to_depth_stem=True`` replaces the 7x7 / stride-2 stem with pad 3
+ 2x2 space-to-depth + a 4x4 VALID conv over 12 channels; the 4x4
family strictly contains the 7x7 stem, and `fold_conv7_stem` maps 7x7
weights onto it exactly. Every stock Conv2D -> BN -> act(+residual)
chain runs as one `F.fused_conv2d_bn_act` (kernel B10 on CUDA tensors);
non-stock layers (biased, grouped or hooked convs, hooked or subclassed
norms) compose conv(x) and the BN as before.

A model is built on `device` (default cuda; raises when no GPU is
visible) from `generator` (torch's default one when None), so one seed
gives the same weights on every device.
"""

from __future__ import annotations

import numpy as np

from ... import amp, nn, resolve_device
from ...nn import functional as F
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import _BatchNormBase

__all__ = ["fold_conv7_stem", "SpaceToDepthStem", "BasicBlock",
           "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d"]


def fold_conv7_stem(w7):
    """[O,3,7,7] stem weights -> exactly-equivalent [O,12,4,4] weights
    for the space-to-depth stem (channel layout c*4 + py*2 + px)."""
    w7 = np.asarray(w7)
    o, c_in = w7.shape[0], w7.shape[1]
    w4 = np.zeros((o, c_in * 4, 4, 4), w7.dtype)
    for c in range(c_in):
        for py in range(2):
            for px in range(2):
                for q in range(4):
                    for s in range(4):
                        u, v = 2 * q + py, 2 * s + px
                        if u < 7 and v < 7:
                            w4[:, c * 4 + py * 2 + px, q, s] = \
                                w7[:, c, u, v]
    return w4


class SpaceToDepthStem(nn.Layer):
    """pad(3) -> space-to-depth(2) -> Conv2D(12, out, 4, VALID): the
    same function family as Conv2D(3, out, 7, stride=2, padding=3)."""

    def __init__(self, in_channels=3, out_channels=64, generator=None):
        super().__init__()
        self.conv = nn.Conv2D(in_channels * 4, out_channels, 4, padding=0,
                              bias_attr=False, generator=generator)

    def pre(self, x):
        """The pad + space-to-depth half; the 4x4 conv half is applied
        separately so the model-level Conv->BN->ReLU fusion can take it
        (forward == self.conv(pre(x)))."""
        # odd padded dims get one extra zero row/col on the bottom/right
        # so the 2x2 space-to-depth divides evenly; the extra zeros fall
        # on the (3, 1) taps that are zero in the folded 7x7 weights
        h_in, w_in = x.shape[2], x.shape[3]
        x = F.pad(x, [3, 3 + (h_in % 2), 3, 3 + (w_in % 2)])
        n, c, h, w = x.shape
        # each Tensor method casts under the reference's op name (O2)
        (x,) = amp.cast("reshape", x)
        (x,) = amp.cast("transpose", x.reshape(n, c, h // 2, 2, w // 2, 2))
        (x,) = amp.cast("reshape", x.permute(0, 1, 3, 5, 2, 4))
        return x.reshape(n, c * 4, h // 2, w // 2)

    def forward(self, x):
        return self.conv(self.pre(x))


def _downsample(ds, x):
    """Fuse the shortcut's Conv->BN when it is the stock Sequential
    (identity act); any other downsample runs as-is."""
    if isinstance(ds, nn.Sequential) and len(ds) == 2:
        return _conv_bn_act(ds[0], ds[1], x, act="identity")
    return ds(x)


def _bn_act(bn, x, residual=None, act="relu"):
    """Route block BNs through the fused BN+act(+residual) op. Non-plain
    norm layers and BNs carrying hooks keep the composed module call so
    hooks and overridden forwards still fire."""
    if not isinstance(bn, _BatchNormBase) or not bn._is_plain():
        y = bn(x)
        if residual is not None:
            y = amp.binary("elementwise_add", y, residual)
        return F.relu(y) if act == "relu" else y
    return F.fused_bn_act(
        x, bn._mean, bn._variance, bn.weight, bn.bias,
        residual=residual, act=act, training=bn.training,
        momentum=bn._momentum, epsilon=bn._epsilon,
        data_format=bn._data_format,
        use_global_stats=bn._use_global_stats)


def _conv_bn_act(conv, bn, x, residual=None, act="relu"):
    """Route a stock Conv2D -> BN -> act(+residual) chain through the
    fused-epilogue conv op. Anything non-stock composes conv(x) ->
    _bn_act."""
    if (isinstance(conv, Conv2D) and conv._is_plain_for_fusion()
            and isinstance(bn, _BatchNormBase) and bn._is_plain()
            and conv._data_format == bn._data_format):
        return F.fused_conv2d_bn_act(
            x, conv.weight, bn._mean, bn._variance, bn.weight, bn.bias,
            residual=residual, act=act, training=bn.training,
            momentum=bn._momentum, epsilon=bn._epsilon,
            stride=conv._stride, padding=conv._padding,
            dilation=conv._dilation, groups=conv._groups,
            data_format=bn._data_format,
            use_global_stats=bn._use_global_stats)
    return _bn_act(bn, conv(x), residual=residual, act=act)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 generator=None):
        super().__init__()
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1,
                               stride=stride, bias_attr=False,
                               generator=generator)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1,
                               bias_attr=False, generator=generator)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else _downsample(
            self.downsample, x)
        out = _conv_bn_act(self.conv1, self.bn1, x)
        return _conv_bn_act(self.conv2, self.bn2, out, residual=identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 generator=None):
        super().__init__()
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               generator=generator)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False,
                               generator=generator)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, generator=generator)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else _downsample(
            self.downsample, x)
        out = _conv_bn_act(self.conv1, self.bn1, x)
        out = _conv_bn_act(self.conv2, self.bn2, out)
        return _conv_bn_act(self.conv3, self.bn3, out, residual=identity)


class ResNet(nn.Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, space_to_depth_stem=False,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        layer_cfg = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
        }
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        if space_to_depth_stem:
            self.conv1 = SpaceToDepthStem(3, self.inplanes, generator)
        else:
            self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2,
                                   padding=3, bias_attr=False,
                                   generator=generator)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0],
                                       generator=generator)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2,
                                       generator=generator)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2,
                                       generator=generator)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2,
                                       generator=generator)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                generator=generator)
        self.device = dev
        self.to(dev)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False,
                    generator=None):
        norm_layer = self._norm_layer
        gen = generator
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, generator=gen),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer, gen)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, generator=gen))
        return nn.Sequential(*layers)

    def forward(self, x):
        if (isinstance(self.conv1, SpaceToDepthStem)
                and not self.conv1._forward_pre_hooks
                and not self.conv1._forward_hooks):
            # split the stem so its 4x4 conv fuses with bn1 / relu too
            x = _conv_bn_act(self.conv1.conv, self.bn1, self.conv1.pre(x))
        else:
            x = _conv_bn_act(self.conv1, self.bn1, x)
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            (x,) = amp.cast("flatten", x)
            x = self.fc(x.flatten(1))
        return x


def _resnet(block, depth, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, **kwargs)
