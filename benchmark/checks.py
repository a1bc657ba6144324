"""The numbers that decide ``correct``, each a gap between what the
program produced and what the plain reference works out again."""

from __future__ import annotations

import torch


def force_gap(f, f_ref):
    """The largest per-atom force error over the root mean square of the
    reference's per-atom force: max_i |F_i - F_ref,i| / rms_i |F_ref,i|."""
    f_ref = f_ref.to(torch.float64)
    err = torch.linalg.vector_norm(f.to(torch.float64) - f_ref, dim=1)
    rms = torch.sqrt((f_ref * f_ref).sum(1).mean())
    return float(err.max() / rms)


def position_gap(x, x_ref, mic):
    """The largest per-atom distance (nm) between two frames, each pair
    of positions taken by the minimum image."""
    d = mic(x.to(torch.float64) - x_ref.to(torch.float64))
    return float(torch.linalg.vector_norm(d, dim=1).max())
