"""Hungarian assignment of TransFusion's queries to ground-truth boxes (port
of the JAX package's "host" method, `_hungarian_host` and `hungarian_match`
in df3d/models/heads/transfusion_head.py).

Each sample's (P, M) cost goes to scipy's `linear_sum_assignment` on the
host over its valid columns, as the JAX package and the reference
(mmdet3d's HungarianAssigner3D) do. The whole batch's costs cross to the
host in one copy; the B assignments run there one after another; the
match comes back to the cost's device. This is the port's one scipy
import: the assignment is a host step, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def hungarian_match(cost: torch.Tensor, valid_cols: torch.Tensor
                    ) -> torch.Tensor:
    """cost (B, P, M), valid_cols (B, M) bool -> (B, P) int64 on cost's
    device: the matched column of each row, or -1. Only the valid columns
    take part; with more valid columns than rows some columns stay
    unmatched, with fewer some rows do."""
    b, p, _ = cost.shape
    # costs and validity in one device-to-host copy
    both = torch.cat([cost.detach(), valid_cols[:, None, :].to(cost.dtype)],
                     1).cpu().numpy()
    out = np.full((b, p), -1, np.int64)
    for s in range(b):
        cols = np.nonzero(both[s, p])[0]
        if len(cols):
            rows, cidx = linear_sum_assignment(both[s, :p][:, cols])
            out[s, rows] = cols[cidx]
    return torch.from_numpy(out).to(cost.device)
