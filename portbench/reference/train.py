"""The reference's training steps: the plain Y-Net in float32, the hybrid
loss, and Adam, written out.

A step takes a batch of u8 patches and their labels, applies the colour
jitter of the reference augmentor with factors drawn from the step's
generator (brightness, contrast about the grayscale mean, saturation and
hue in HSV, in that order, as the program defines it), normalises, runs
the model in train mode (BatchNorm on the batch's statistics), sums
cross entropy on the classifier's logits (class-weighted, rows with a
class), the mean squared error of the regressor (rows with a value) and
pixel cross entropy on the segmentation logits (class-weighted, rows with
a label map), and takes one Adam step with L2 weight decay added to the
gradient (``torch.optim.Adam``'s rule). TF32 is off. Imports nothing of
the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.infer import exact_f32

JITTER = (0.25, 0.75, 0.25, 0.04)     # brightness, contrast, saturation, hue


def step_generator(seed: int, epoch: int, step: int,
                   device) -> torch.Generator:
    """The generator of a step's jitter: numpy's SeedSequence of (seed,
    epoch, step), its first 64-bit word halved, seeds a torch generator
    on the device."""
    s = np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The rows of an epoch in the order its batches take them."""
    return np.random.RandomState((seed * 100003 + epoch) & 0x7FFFFFFF
                                 ).permutation(n)


def jitter_factors(n: int, gen: torch.Generator) -> torch.Tensor:
    """(n, 4) uniform factors in [1 − x, 1 + x] (hue: [−x, x])."""
    b, c, s, h = JITTER
    lo = torch.tensor([max(0.0, 1 - b), max(0.0, 1 - c), max(0.0, 1 - s),
                       -h])
    hi = torch.tensor([1 + b, 1 + c, 1 + s, h])
    u = torch.rand((n, 4), generator=gen, device=gen.device)
    return lo.to(u.device) + u * (hi - lo).to(u.device)


def _hsv(rgb):
    r, g, b = rgb.unbind(-1)
    v = rgb.max(-1).values
    c = v - rgb.min(-1).values
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    cs = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, (g - b) / cs,
                    torch.where(v == g, 2.0 + (b - r) / cs,
                                4.0 + (r - g) / cs))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0),
                    torch.zeros_like(h))
    return h, s, v


def _rgb(h, s, v):
    k = lambda n: torch.remainder(n + h * 6.0, 6.0)  # noqa: E731
    f = lambda n: v - v * s * torch.clamp(  # noqa: E731
        torch.minimum(k(n), 4.0 - k(n)), 0.0, 1.0)
    return torch.stack([f(5.0), f(3.0), f(1.0)], dim=-1)


def jitter(rgb: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1], (B, 4) factors → jittered images."""
    fb, fc, fs, fh = (f[:, i].view(-1, 1, 1, 1) for i in range(4))
    x = torch.clamp(rgb * fb, 0.0, 1.0)
    gray = x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
    mean = gray.mean(dim=(1, 2)).view(-1, 1, 1, 1)
    x = torch.clamp((x - mean) * fc + mean, 0.0, 1.0)
    h, s, v = _hsv(x)
    s = torch.clamp(s * fs[..., 0], 0.0, 1.0)
    h = torch.remainder(h + fh[..., 0], 1.0)
    return torch.clamp(_rgb(h, s, v), 0.0, 1.0)


def hybrid_loss(out: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                cls_w: torch.Tensor, seg_w: torch.Tensor) -> torch.Tensor:
    is_cls, is_reg, is_seg = b["is_cls"], b["is_reg"], b["is_seg"]
    t = b["cls_label"].long()
    valid = t >= 0
    tc = torch.where(valid, t, torch.zeros_like(t))
    nll = -F.log_softmax(out["cls"], dim=1).gather(1, tc[:, None])[:, 0]
    w = valid.float() * cls_w[tc] * is_cls
    l_cls = (nll * w).sum() / w.sum().clamp(min=1e-8)
    err = (out["reg"][:, 0] - b["reg_label"]) ** 2
    l_reg = (err * is_reg).sum() / is_reg.sum().clamp(min=1e-8)
    ts = b["seg_label"].long()
    nll = -F.log_softmax(out["seg"], dim=1).gather(1, ts[:, None])[:, 0]
    w = seg_w[ts] * is_seg.view(-1, 1, 1)
    l_seg = (nll * w).sum() / w.sum().clamp(min=1e-8)
    return l_cls + l_reg + l_seg


def row_losses(out: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
               cls_w: torch.Tensor, seg_w: torch.Tensor) -> torch.Tensor:
    """(B,) float32: each row's own share of :func:`hybrid_loss`, the
    class-weighted cross entropy of its class, the squared error of its
    value and the class-weighted pixel cross entropy of its label map,
    each where the row has one."""
    t = b["cls_label"].long()
    valid = (t >= 0).float()
    tc = torch.where(t >= 0, t, torch.zeros_like(t))
    nll = -F.log_softmax(out["cls"].float(), dim=1).gather(
        1, tc[:, None])[:, 0]
    l_cls = nll * valid * cls_w[tc] * b["is_cls"]
    l_reg = (out["reg"][:, 0].float() - b["reg_label"]) ** 2 * b["is_reg"]
    ts = b["seg_label"].long()
    nll = -F.log_softmax(out["seg"].float(), dim=1).gather(
        1, ts[:, None])[:, 0]
    w = seg_w[ts]
    l_seg = ((nll * w).sum(dim=(1, 2)) / w.sum(dim=(1, 2)).clamp(min=1e-8)
             * b["is_seg"])
    return (l_cls + l_reg + l_seg).detach()


class Adam:
    """``torch.optim.Adam`` with L2 weight decay, written out."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 betas: Sequence[float], eps: float, weight_decay: float):
        self.params, self.lr, self.eps, self.wd = params, lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """One update; returns the gradients as the update took them."""
        self.t += 1
        got = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            got.append(g.clone())
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return got


def run_steps(model, batches, gens, cfg: Dict, train: Dict,
              cls_w: torch.Tensor, seg_w: torch.Tensor) -> Dict:
    """The first steps of training ``model`` (the reference, in train
    mode) on host-side ``batches`` (dicts of tensors on the device, u8
    images) with the jitter generators ``gens``. Returns each step's loss,
    the first step's loss row by row (:func:`row_losses`), its gradients
    as Adam took them, and the parameters after the last step, by
    name."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = Adam(params, train["lr"], (train["beta1"], train["beta2"]), 1e-8,
               train["weight_decay"])
    mean = torch.tensor(cfg["dataset_mean"], device=params[0].device)
    std = torch.tensor(cfg["dataset_std"], device=params[0].device)
    model.train()
    losses, first, rows = [], None, None
    with exact_f32():
        for b, gen in zip(batches, gens):
            x = b["image"].float() / 255.0
            x = jitter(x, jitter_factors(x.shape[0], gen))
            x = ((x - mean) / std).permute(0, 3, 1, 2)
            for p in params:
                p.grad = None
            out = model(x)
            loss = hybrid_loss(out, b, cls_w, seg_w)
            if rows is None:
                rows = row_losses(out, b, cls_w, seg_w)
            loss.backward()
            losses.append(float(loss.detach()))
            got = opt.step()
            if first is None:
                first = dict(zip(names, got))
    return {"losses": losses, "rows": rows, "grads": first,
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}


def gaps(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor]) -> Dict:
    """The program's first steps against the reference's:

    - ``row_loss_gap``: the first step's loss row by row, the root mean
      square over the rows of each row's gap over the larger of its
      reference loss and the median row's (a row the program left out
      reads 1);
    - ``update_gap``: the worst leaf's gap between the norms of the
      parameters' change over the steps, over the larger of the
      reference leaf's and the median leaf's, leaving out leaves whose
      first reference gradient is under a thousandth of the median
      leaf's (they move by round-off alone under Adam)."""
    def norms(d):
        return {k: float(v.double().norm()) for k, v in d.items()}

    rp, rr = prog["rows"].double().cpu(), ref["rows"].double().cpu()
    n = min(len(rp), len(rr))
    scale = torch.clamp(rr.abs(), min=float(rr.abs().median()))
    row = torch.cat([(rp[:n] - rr[:n]).abs() / scale[:n],
                     torch.ones(len(rr) - n, dtype=torch.float64)])
    gr = norms(ref["grads"])
    med_g = float(np.median(list(gr.values())))
    live = [k for k in gr if gr[k] >= 1e-3 * med_g]
    dp = norms({k: prog["params"][k] - start[k] for k in live})
    dr = norms({k: ref["params"][k] - start[k] for k in live})
    med_d = float(np.median(list(dr.values())))
    return {"row_loss_gap": float(row.pow(2).mean().sqrt()),
            "update_gap": max(abs(dp[k] - dr[k]) / max(dr[k], med_d)
                              for k in live)}
