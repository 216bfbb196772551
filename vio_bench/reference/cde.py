"""The cde pose core's stages, each from given inputs: the path from the
features, and the solve of a segment redone over the steps a program
logged. Plain float32 PyTorch in the precision of the reference it is
given (:class:`vio_bench.reference.model.ReferenceModel`); nothing of the
measured program is imported.

Why a replay: two sound float32 dopri5 solves at rtol 1e-4 that choose
their steps apart differ by up to a few 1e-3 of |z| at the cde field's
random init, where rounding decides a step; so does a solve whose
products run in TF32. Over the program's own accepted steps (its ``(t,
h)``, the field evaluated at the same stage times) only rounding differs:
~1e-6 for float32, ~1e-3 for TF32. The replay also holds the steps
themselves: each accepted step's error ratio at the configuration's
tolerances, and that the steps run from the segment's start to its end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vio_bench.reference import dopri5
from vio_bench.reference.model import ACTIVATIONS

ROWS = 2048  # rows of one replay


def cde_path(ref, fv, fi, ts, cold):
    """The reference's fusion, reduction and linear path on features ``fv``,
    ``fi`` (B, S-1, .) and clock ``ts`` (B, S): (knots (B, S-1), per-segment
    slopes (B, S-2, H+1), the cold start ``tanh(initial(obs0))`` (B, H)),
    ``cold`` rows on their own window's clock."""
    feat = torch.cat([fv, fi], -1).float()
    if ref.m["fuse_method"] == "soft":
        feat = feat * ref._linear(feat, "Pose_net.fuse.net.0")
    x = ref._linear(F.leaky_relu(ref._linear(feat, "Pose_net.reduction_net.0"), 0.1),
                    "Pose_net.reduction_net.2")
    ts = ts.float()
    knots = torch.where(cold[:, None], ts - ts[:, :1], ts)[:, 1:]
    obs = torch.cat([knots[..., None], x], -1)
    gap = knots[:, 1:] - knots[:, :-1]
    slopes = (obs[:, 1:] - obs[:, :-1]) / torch.where(gap > 0, gap, torch.ones_like(gap))[..., None]
    return knots, slopes, torch.tanh(ref._linear(obs[:, 0], "Pose_net.initial.0"))


def accepted(steps: torch.Tensor):
    """A step log's accepted steps, ``steps`` (R, K, 2) ((t, h) an attempt,
    h > 0 where accepted), moved to the front in their order: ((R, K) t,
    (R, K) h, (R,) their number)."""
    ok = steps[..., 1] > 0
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices
    packed = torch.gather(steps, 1, order[..., None].expand(-1, -1, 2))
    n = ok.sum(1)
    keep = torch.arange(steps.shape[1], device=steps.device) < n[:, None]
    return packed[..., 0] * keep, packed[..., 1] * keep, n


def covered(steps: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Per row, whether the accepted steps of ``steps`` (R, K, 2) run from
    ``t0`` to ``t1`` (R,) as the controller takes them: the first from
    ``t0``, each next from where the last ended (``t + h`` in float32), the
    last onto ``t1`` (``h = t1 - t``, or ``t + h = t1``); none where ``t1
    <= t0``."""
    t, h, n = accepted(steps)
    k = torch.arange(t.shape[1], device=t.device)
    inner = (k[None, 1:] < n[:, None]) & (t[:, 1:] != t[:, :-1] + h[:, :-1])
    last = (n - 1).clamp_min(0)[:, None]
    tl, hl = t.gather(1, last)[:, 0], h.gather(1, last)[:, 0]
    lands = (hl == t1 - tl) | (tl + hl == t1)
    stepping = t1 > t0
    return torch.where(stepping, (n > 0) & (t[:, 0] == t0) & ~inner.any(1) & lands, n == 0)


def replay(ref, z, steps, knots, slopes):
    """Each row's CDE from ``z`` (R, H) over the accepted steps of its
    step log ``steps`` (R, K, 2), dopri5 steps of exactly those ``(t, h)``
    (the stage times ``t + c h`` rounded as a float32 solve rounds them,
    the first stage of a step the last of the one before), on its own
    linear path (``knots`` (R, T), ``slopes`` (R, T-1, C); a stage at a
    knot takes the next segment's slope), the field of ``ref``'s
    configuration in ``ref``'s precision. Returns (z after the last step,
    each row's widest error ratio of its steps at the configuration's
    tolerances, 0 where it took none)."""
    m = ref.m
    H = m["cde_hidden_dim"]
    act = ACTIVATIONS[m["cde_activation_fn"]]
    n_layers = m["cde_fn_num_layers"] + 1
    ctl = ref.cde_ctl
    out, worst = [], []
    for a in range(0, z.shape[0], ROWS):
        rows = slice(a, a + ROWS)
        kn, sl = knots[rows], slopes[rows]
        idx = torch.arange(kn.shape[0], device=z.device)
        t_all, h_all, n = accepted(steps[rows])

        def field(t, zz):
            seg = ((kn <= t[:, None]).sum(-1) - 1).clamp(0, kn.shape[1] - 2)
            g = ref._mlp("Pose_net.cde_func.net", n_layers, act, zz).reshape(-1, H, H + 1)
            return ref._out(ref._c(g) @ ref._c(sl[idx, seg][..., None]))[..., 0]

        y = z[rows]
        ratio = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        f = field(t_all[:, 0], y) if bool((n > 0).any()) else None
        for k in range(int(n.max()) if n.numel() else 0):
            on = k < n
            t, h = t_all[:, k], h_all[:, k]
            hc = h[:, None]
            ks = [f]
            for i in range(1, 7):
                ks.append(field(t + dopri5.C[i] * h, y + hc * dopri5._combine(dopri5.A[i], ks)))
            y1 = y + hc * dopri5._combine(dopri5.B_SOL, ks)
            err = hc * dopri5._combine(dopri5.B_ERR, ks)
            scale = ctl.atol + ctl.rtol * torch.maximum(y.abs(), y1.abs())
            r = torch.sqrt(((err / scale) ** 2).mean(-1))
            ratio = torch.where(on, torch.maximum(ratio, r), ratio)
            y = torch.where(on[:, None], y1, y)
            f = torch.where(on[:, None], ks[6], f)
        out.append(y)
        worst.append(ratio)
    return torch.cat(out), torch.cat(worst)


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row, the widest ``|got - want|`` over the widest ``|want|`` (inf
    where the reference is 0 and the program is not)."""
    num = (got.double() - want.double()).abs().amax(-1)
    den = want.double().abs().amax(-1)
    return torch.where(den > 0, num / den.clamp_min(1e-300),
                       torch.where(num > 0, torch.inf, 0.0))
