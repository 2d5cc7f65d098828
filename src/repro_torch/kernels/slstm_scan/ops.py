"""Wrapper of the sLSTM scan kernel (``kernel.cu``)."""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain

MAX_HEAD_DIM = 512       # 4 dims x 16 groups x 8 blocks of a cluster


def slstm_scan(gx: torch.Tensor, r_gates: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, *, device: str | torch.device = "cuda"):
    """The sLSTM recurrence over all T steps of ``gx`` in one launch.

    gx (B, T, H, 4Dh), r_gates (H, Dh, 4Dh), h0 / c0 (B, H, Dh) ->
    (hs (B, T, H, Dh), hT, cT), f32.  The kernel takes f32 and Dh a
    multiple of 4 up to 512; the CPU runs the plain version.
    """
    dev = resolve_device(device)
    check_on(dev, gx=gx, r_gates=r_gates, h0=h0, c0=c0)
    B, T, H, Dh4 = gx.shape
    Dh = Dh4 // 4
    if (Dh4 % 4 or r_gates.shape != (H, Dh, Dh4)
            or h0.shape != (B, H, Dh) or c0.shape != h0.shape):
        raise ValueError(f"gx {tuple(gx.shape)}, r_gates "
                         f"{tuple(r_gates.shape)}, h0 {tuple(h0.shape)}, "
                         f"c0 {tuple(c0.shape)} do not fit")
    if dev.type == "cpu":
        return slstm_scan_plain(gx, r_gates, h0, c0)
    if any(t.dtype != torch.float32 for t in (gx, r_gates, h0, c0)):
        raise TypeError("slstm_scan kernel takes f32 gx, r_gates, h0, c0")
    if Dh % 4 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"slstm_scan kernel takes a head dim that is a "
                         f"multiple of 4 up to {MAX_HEAD_DIM}, got {Dh}")
    gx, h0, c0 = gx.contiguous(), h0.contiguous(), c0.contiguous()
    r_gates = r_gates.contiguous()
    if r_gates.data_ptr() % 16:            # the kernel loads R as float4s
        r_gates = r_gates.clone()
    hs = torch.empty((B, T, H, Dh), dtype=torch.float32, device=dev)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    if T == 0 or B == 0:
        return hs, hT.copy_(h0), cT.copy_(c0)
    lib = runtime.library()
    rc = lib.slstm_scan_launch(
        gx.data_ptr(), r_gates.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H, Dh,
        runtime.stream_arg(hs.device))
    runtime.count_launch("slstm_scan")
    runtime.check_status("slstm_scan", rc)
    return hs, hT, cT

