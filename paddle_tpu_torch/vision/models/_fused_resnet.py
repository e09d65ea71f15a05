"""The fused path of ResNet bottlenecks in NHWC training (counterpart of
paddle_tpu/vision/models/_fused_resnet.py).

Glue between the model and ``ops.fused_conv_bn``: plain tensor code under
torch autograd around ``conv1x1_bn``, with the reference's math.  bn2's
normalise + ReLU folds into conv3's input read and never materialises; the
BatchNorm batch statistics come back from the kernels' epilogues, and the
Layer updates its running buffers from them with ``F.batch_norm``'s
momentum semantics.

Layout contract: NHWC activations with the W axis padded to a multiple of 8
("W'") from stage 2 on (wv = valid columns); pad columns hold zeros.  The
per-stage (wv, W') ladder for a 224 input is 56/56, 28/32, 14/16, 7/8.
Statistics count N * H * wv valid elements, where the composed
``batch_norm`` counts every element.
"""
from __future__ import annotations

import torch

from ...nn.functional.conv import conv2d
from ...nn.functional.norm import update_running
from ...ops.fused_conv_bn import conv1x1_bn

# With FORCE, the fused path runs off the card too (CPU tensors take the
# kernels' plain versions); the tests set it, as the reference's do.
FORCE = False


def masked_gap(x, *, wv):
    """Global average pool over the VALID spatial region of a W-padded NHWC
    activation -> [N, 1, 1, C] (AdaptiveAvgPool2D((1, 1)) parity)."""
    s = x.float().sum((1, 2), keepdim=True)
    return (s / (x.shape[1] * wv)).to(x.dtype)


def update_running_stats(bn, mean_t, var_t, cnt):
    """Write batch statistics back to a BatchNorm layer's buffers with the
    exact ``F.batch_norm`` momentum semantics (momentum * rm + (1 - m) *
    stat, var debiased by n / (n - 1), with n = cnt valid elements)."""
    update_running(bn._mean, bn._variance, mean_t, var_t, cnt, bn._momentum)


def _w1x1(w):
    """[Cout, Cin, 1, 1] (paddle layout) -> [1, 1, Cin, Cout] (kernel layout)."""
    return w.permute(2, 3, 1, 0)


def _affine(s1, s2, cnt, gamma, beta, eps):
    """Batch stats -> (mean, biased var, f32 scale/offset row vectors)."""
    m = s1 / cnt
    v = torch.clamp(s2 / cnt - m * m, min=0.0)
    sc = gamma.float() * torch.rsqrt(v + eps)
    of = beta.float() - m * sc
    return m, v, sc.reshape(1, -1), of.reshape(1, -1)


def _colmask(Wp, wv, device):
    return (torch.arange(Wp, device=device) < wv).reshape(1, 1, Wp, 1)


def _pad_w(y, wp):
    return torch.nn.functional.pad(y, (0, 0, 0, wp - y.shape[2])) if y.shape[2] < wp else y


def _sums(y):
    yf = y.float()
    return yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


def downsample_step(x, wd, gd, bd, *, stride, wv_out, wp_out, eps):
    """conv1x1(stride) + BN (no relu) for the projection shortcut.

    x may be W-padded: a strided 1x1 conv maps zero pad columns to zero pad
    columns, so only a possible re-pad (stage-2 entry, 28 -> 32) is needed.
    Returns (identity, batch mean, biased batch var)."""
    y = _pad_w(conv2d(x, wd, stride=stride, data_format="NHWC"), wp_out)
    s1, s2 = _sums(y)
    cnt = y.shape[0] * y.shape[1] * wv_out
    m, v, sc, of = _affine(s1, s2, cnt, gd, bd, eps)
    idn = y.float() * sc.reshape(-1) + of.reshape(-1)
    if wv_out != wp_out:
        idn = torch.where(_colmask(wp_out, wv_out, x.device), idn, 0.0)
    return idn.to(x.dtype), m, v


def bottleneck_step(x, identity, w1, g1, b1, w2, g2, b2, w3, g3, b3,
                    *, stride, groups, wv_in, wv_out, wp_out, eps):
    """One fused bottleneck block.  Returns (z, m1, v1, m2, v2, m3, v3)."""
    N, H, wp_in, _ = x.shape
    dt = x.dtype

    # conv1 (1x1, stride 1, input already normalised) + bn1 stats epilogue
    y1, s11, s12 = conv1x1_bn(x, _w1x1(w1), wv=wv_in)
    m1, v1, sc1, of1 = _affine(s11, s12, N * H * wv_in, g1, b1, eps)

    # bn1 normalise + relu materialises z1 (conv2 is a 3x3: producers cannot
    # fold into its input read)
    z1 = torch.relu(y1.float() * sc1.reshape(-1) + of1.reshape(-1))
    if wv_in != wp_in:
        z1 = torch.where(_colmask(wp_in, wv_in, x.device), z1, 0.0)
    z1 = z1.to(dt)

    # conv2: 3x3, explicit (1, 1) padding; on a padded-W input the zero
    # columns reproduce SAME-pad semantics for the valid region
    y2 = _pad_w(conv2d(z1, w2, stride=stride, padding=1, groups=groups, data_format="NHWC"),
                wp_out)
    Ho = y2.shape[1]
    if wv_out != wp_out:
        # garbage appears at pad columns (the last valid column's window
        # reaches into real data); re-zero them before stats / conv3
        y2 = torch.where(_colmask(wp_out, wv_out, x.device), y2,
                         torch.zeros((), dtype=dt, device=x.device))
    s21, s22 = _sums(y2)
    m2, v2, sc2, of2 = _affine(s21, s22, N * Ho * wv_out, g2, b2, eps)

    # conv3 (1x1) with bn2's normalise + relu FOLDED into the input read
    y3, s31, s32 = conv1x1_bn(y2, _w1x1(w3), sc2, of2, wv=wv_out)
    m3, v3, sc3, of3 = _affine(s31, s32, N * Ho * wv_out, g3, b3, eps)

    z = y3.float() * sc3.reshape(-1) + of3.reshape(-1) + identity.float()
    z = torch.relu(z)
    if wv_out != wp_out:
        z = torch.where(_colmask(wp_out, wv_out, x.device), z, 0.0)
    return z.to(dt), m1, v1, m2, v2, m3, v3
