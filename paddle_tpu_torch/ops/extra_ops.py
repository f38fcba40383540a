"""Long-tail ops (counterpart of paddle_tpu/ops/extra_ops.py): CTC,
spatial warps, small losses, spectral norm, 3-D pooling, maxout, the
hierarchical sigmoid and the beam-search backtrace.

`warpctc` is ``torch.nn.functional.ctc_loss`` on the log-softmax of the
logits, per sample: the reference's op is a native forward algorithm,
not a Pallas kernel, and torch's gives the same losses (its gradient,
taken through the log-softmax, is the reference's too). Everything else
is written from the reference's arithmetic, op for op.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .nn_ops import adaptive_pool_nd, pool_nd

__all__ = ["warpctc", "affine_grid", "grid_sampler", "npair_loss",
           "spectral_norm", "pool3d", "maxout", "hierarchical_sigmoid",
           "gather_tree"]


def warpctc(logits, labels, logit_lengths, label_lengths, *, blank=0,
            norm_by_times=False):
    """Per-sample CTC loss [B] of logits [B, T, C] (normalised here)."""
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    in_len = logit_lengths.reshape(-1).long()
    lab_len = label_lengths.reshape(-1).long()
    loss = tF.ctc_loss(logp, labels.long(), in_len, lab_len, blank=blank,
                       reduction="none", zero_infinity=False)
    if norm_by_times:
        loss = loss / torch.clamp_min(in_len, 1).to(loss.dtype)
    return loss


def affine_grid(theta, *, out_shape, align_corners=True):
    """Sampling grid [N, H, W, 2] from [N, 2, 3] `theta`."""
    theta = theta.float()
    h, w = int(out_shape[-2]), int(out_shape[-1])

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sampler(x, grid, *, mode="bilinear", padding_mode="zeros",
                 align_corners=True):
    """Sample x [N, C, H, W] at grid [N, Ho, Wo, 2] (normalised xy):
    bilinear / nearest (round half to even), zeros / border /
    reflection padding, as the reference computes it."""
    grid = grid.float()
    n, c, h, w = x.shape

    def unnorm(g, size):
        if align_corners:
            return (g + 1.0) / 2.0 * (size - 1)
        return ((g + 1.0) * size - 1.0) / 2.0

    gx, gy = unnorm(grid[..., 0], w), unnorm(grid[..., 1], h)
    if padding_mode == "reflection":
        def reflect(cd, size):
            if align_corners:
                period = max(2.0 * (size - 1), 1.0)
                r = torch.remainder(cd.abs(), period)
                return torch.where(r > size - 1, period - r, r)
            period = 2.0 * size
            r = torch.remainder((cd + 0.5).abs(), period)
            r = torch.minimum(r, period - r)
            return torch.clamp(r - 0.5, 0.0, size - 1)

        gx, gy = reflect(gx, w), reflect(gy, h)
    flat = x.reshape(n, c, h * w)

    def sample_at(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        vals = vals.reshape(n, c, *yi.shape[1:])
        if padding_mode == "zeros":
            vals = vals * inside[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return sample_at(torch.round(gy).long(), torch.round(gx).long())
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    x0i, y0i = x0.long(), y0.long()
    return (sample_at(y0i, x0i) * (1 - wy) * (1 - wx)
            + sample_at(y0i, x0i + 1) * (1 - wy) * wx
            + sample_at(y0i + 1, x0i) * wy * (1 - wx)
            + sample_at(y0i + 1, x0i + 1) * wy * wx)


def npair_loss(anchor, positive, labels, *, l2_reg=0.002):
    labels = labels.reshape(-1)
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / same.sum(dim=1, keepdim=True)
    logits = anchor @ positive.T
    xent = -(tgt * torch.log_softmax(logits, dim=1)).sum(dim=1)
    reg = ((anchor * anchor).sum(1) + (positive * positive).sum(1)).mean() \
        * l2_reg * 0.25
    return xent.mean() + reg


def spectral_norm(weight, u, v, *, dim=0, power_iters=1, eps=1e-12):
    """weight / sigma, sigma from `power_iters` power iterations on f32
    copies of u and v (the given vectors are not updated)."""
    w = weight.float()
    w2 = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    uu, vv = u.float(), v.float()
    for _ in range(max(power_iters, 1)):
        vv = w2.T @ uu
        vv = vv / torch.clamp_min(torch.linalg.vector_norm(vv), eps)
        uu = w2 @ vv
        uu = uu / torch.clamp_min(torch.linalg.vector_norm(uu), eps)
    sigma = uu @ w2 @ vv
    return (w / sigma).to(weight.dtype)


def pool3d(x, *, ksize, stride=None, padding=0, pooling_type="max",
           ceil_mode=False, exclusive=True, global_pooling=False,
           adaptive=False, data_format="NCDHW"):
    channel_last = data_format == "NDHWC"
    if channel_last:
        x = x.movedim(-1, 1)
    if adaptive:
        out = adaptive_pool_nd(x, ksize, pooling_type)
    elif global_pooling:
        out = x.amax(dim=(2, 3, 4), keepdim=True) if pooling_type == "max" \
            else x.mean(dim=(2, 3, 4), keepdim=True)
    else:
        # torch's CPU avg_pool3d has no 16-bit kernel: pool those in f32
        # there and round once (the card pools them in their own dtype)
        up = pooling_type == "avg" and x.device.type == "cpu" and \
            x.dtype in (torch.bfloat16, torch.float16)
        out = pool_nd(x.float() if up else x, 3, ksize=ksize, stride=stride,
                      padding=padding, ceil_mode=ceil_mode,
                      pooling_type=pooling_type, exclusive=exclusive)
        out = out.to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


def maxout(x, *, groups, axis=1):
    axis = axis % x.dim()
    c = x.shape[axis]
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    shape = tuple(x.shape[:axis]) + (c // groups, groups) + \
        tuple(x.shape[axis + 1:])
    return x.reshape(shape).amax(dim=axis + 1)


def hierarchical_sigmoid(x, w, label, bias=None, path_table=None,
                         path_code=None, *, num_classes):
    """Per-sample [N, 1] losses over the default heap-numbered tree
    (leaf = label + num_classes, root 1) or a custom one."""
    lbl = label.reshape(-1).long()
    if path_table is not None:
        nodes = path_table.long()
        bits = path_code.float()
        valid = nodes >= 0
        nodes_safe = nodes.clamp_min(0)
    else:
        depth = max(int(math.ceil(math.log2(num_classes))), 1)
        leaf = lbl + num_classes
        ks = torch.arange(depth, 0, -1, device=x.device)
        anc = leaf[:, None] >> ks[None, :]
        valid = anc >= 1
        nodes_safe = (anc - 1).clamp_min(0)
        bits = ((leaf[:, None] >> (ks[None, :] - 1)) & 1).float()
    wrows = w[nodes_safe]
    logit = torch.einsum("nlf,nf->nl", wrows.float(), x.float())
    if bias is not None:
        logit = logit + bias.reshape(-1)[nodes_safe]
    z = torch.where(bits > 0.5, -logit, logit)
    losses = torch.where(valid, tF.softplus(z), torch.zeros_like(z))
    return losses.sum(dim=1, keepdim=True)


def gather_tree(ids, parents):
    """Beams re-threaded through their parent pointers: ids / parents
    [T, B, W] -> [T, B, W]."""
    t, _, w = ids.shape
    beam = torch.arange(w, device=ids.device).expand(ids.shape[1:])
    outs = []
    for step in range(t - 1, -1, -1):
        outs.append(torch.gather(ids[step], 1, beam))
        beam = torch.gather(parents[step].long(), 1, beam)
    return torch.stack(outs[::-1])
