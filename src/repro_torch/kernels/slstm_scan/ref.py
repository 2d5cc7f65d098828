"""Plain PyTorch version of the sLSTM scan kernel."""
from __future__ import annotations

import torch


def slstm_scan_plain(gx: torch.Tensor, r_gates: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor):
    """The sequential sLSTM recurrence, one step at a time.

    gx (B, T, H, 4Dh), r_gates (H, Dh, 4Dh), h0 / c0 (B, H, Dh) ->
    (hs (B, T, H, Dh), hT, cT), computed in f32 (f64 for f64 inputs)
    with the state carried in that type; with a bf16 state (h0, c0) the
    outputs are rounded to bf16, as the kernel stores them.  Per step
    t, with the gate columns split as [i | f | z | o]:

        pre = gx[:, t] + h @ r_gates[head]
        c   = sigmoid(f) * c + sigmoid(i) * tanh(z)
        h   = sigmoid(o) * tanh(c)
    """
    dt = torch.promote_types(gx.dtype, torch.float32)
    r = r_gates.to(dt)
    h, c = h0.to(dt), c0.to(dt)
    hs = []
    for t in range(gx.shape[1]):
        pre = gx[:, t].to(dt) + torch.einsum("bhd,hdg->bhg", h, r)
        i, f, z, o = pre.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    B, _, H, Dh4 = gx.shape
    out = (torch.stack(hs, dim=1) if hs
           else gx.new_zeros((B, 0, H, Dh4 // 4), dtype=dt))
    if h0.dtype == torch.bfloat16:
        return tuple(t.to(torch.bfloat16) for t in (out, h, c))
    return out, h, c
