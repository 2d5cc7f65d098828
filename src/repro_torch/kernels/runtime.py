"""Build, load, check and count the port's hand-written CUDA kernels.

The ``kernel.cu`` sources under ``repro_torch/kernels/<name>/``
compile with ``nvcc`` for ``sm_90a`` into one shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The build runs at first use, one ``nvcc`` per
source started together, into ``build/repro_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``); the library's file name
carries a hash of the sources and flags, so an edited source rebuilds.

Right after loading, every kernel is launched once on a tiny input and
any CUDA error raises: this is the port's counterpart of the
reference's Pallas lowering probe (``repro/compat.py``), except that
there is no dispatch decision behind it — on CUDA tensors the port
always runs its kernels.

Each wrapper counts its launches (:func:`count_launch`), so a run can
show that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

KERNEL_DIR = Path(__file__).resolve().parent
SOURCES = ("cim_mvm/kernel.cu", "flash_attention/kernel.cu",
           "manhattan_score/kernel.cu", "slstm_scan/kernel.cu",
           "bitslice_pack/kernel.cu", "line_solve/kernel.cu")
HEADERS = ("tf32_mma.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("cim_mvm", "cim_fold", "cim_mvm_batched", "cim_mvm_grouped",
           "cim_mvm_grouped_folded", "flash_attention",
           "manhattan_score", "slstm_scan", "bitslice_pack", "line_solve")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_U = ctypes.c_uint
# C signatures of the launchers (each returns cudaGetLastError()).
_ARGTYPES = {
    "cim_mvm_launch": [_P] * 6 + [_F, _P, _U, _U, _F, _P],
    "cim_fold_launch": [_P] * 7 + [_F, _P],
    "cim_mvm_batched_launch": [_P, _P, _L] + [_P] * 5 + [_U, _F, _P],
    "cim_mvm_grouped_launch": [_P] * 6 + [_L, _L, _P, _F, _P],
    "cim_mvm_grouped_folded_launch": [_P, _P, _L] + [_P] * 5 + [_U, _F, _P],
    "cim_occupancy": [_P, _P],
    "flash_attention_launch": [_P] * 6 + [_I] * 9 + [_F, _P, _P],
    "flash_occupancy": [_P, _I, _P],
    "manhattan_score_launch": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "slstm_scan_launch": [_P] * 7 + [_I] * 4 + [_P, _I, _P],
    "slstm_scan_max_clusters": [_I, _P],
    "bitslice_pack_launch": [_P, _I, _P, _L, _I, _I, _P],
    "line_solve_launch": [_P, _P, _P, _P, _L, _I, _I, _D, _P, _P],
    "line_solve_occupancy": [_P, _P],
}

class Geometry(NamedTuple):
    """One launch of a kernel whose launcher takes its geometry as an int
    array: the fields by name, and the same values as a ctypes array in
    the order of the kernel's ``Geom`` struct."""

    geom: dict
    array: ctypes.Array

    @classmethod
    def of(cls, fields: tuple[str, ...], geom: dict) -> "Geometry":
        values = [geom[f] for f in fields]
        return cls(geom, (ctypes.c_int * len(values))(*values))

    def __getattr__(self, name):
        try:
            return self.geom[name]
        except KeyError:
            raise AttributeError(name) from None


def round4(n: int) -> int:
    return -(-n // 4) * 4


_LAUNCHES = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()      # a redeploy thread launches too
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_INFO: dict = {}


def count_launch(name: str) -> None:
    """One launch of kernel ``name``; called by its wrapper only."""
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return KERNEL_DIR.parents[2] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels "
                           "are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((KERNEL_DIR / src).read_bytes())
    return h.hexdigest()


def _compile(lib_path: Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    nvcc = _nvcc()
    out = lib_path.parent
    objs, procs = [], []
    for src in SOURCES:
        obj = out / (src.split("/")[0] + f".{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(KERNEL_DIR / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        log.append(f"== {src}\n{text}")
        if proc.returncode:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return "\n".join(log)


def _self_check(lib: ctypes.CDLL) -> None:
    """Launch every kernel once on a tiny input; raise on any error."""
    dev = torch.device("cuda")
    stream = _P(torch.cuda.current_stream().cuda_stream)
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                     device=dev)
    from repro_torch.kernels.cim_mvm.ops import (
        FORM_GROUPED_FOLDED,
        GROUPED_FOLDED_FORMS,
        batched_geometry,
        cim_geometry,
        fold_geometry,
        grouped_folded_geometry,
        grouped_geometry,
    )
    from repro_torch.kernels.flash_attention.ops import flash_geometry
    from repro_torch.kernels.line_solve.ops import GEOM_FIELDS as LINE_FIELDS
    from repro_torch.kernels.line_solve.ops import line_geometry
    from repro_torch.kernels.slstm_scan.ops import slstm_geometry

    codes, pos, scale = (z(8, 8, dt=torch.int16), z(8, 1, dt=torch.int32),
                         z(1))
    gain, colp, wf = z(8, 8), z(1, 1, 64, dt=torch.int32), z(8, 8)
    rc = {}
    for rows in (0, 8):                # the fold without and with col_pos
        rc[f"cim_fold rows={rows}"] = lib.cim_fold_launch(
            codes.data_ptr(), pos.data_ptr(), scale.data_ptr(),
            gain.data_ptr(), colp.data_ptr() if rows else None,
            wf.data_ptr(), fold_geometry(8, 8, 8, 8, 64, False, True,
                                         rows).array, 0.0, stream)
    for M in (1, 17):                  # the decode and the prefill forms
        for folded, noise in ((False, False), (True, False), (True, True)):
            x, out = z(M, 8), z(M, 8)
            geom = cim_geometry(M, 8, 8, 8, 8, 8, 8, 64, False, 1, True,
                                False, folded, noise)
            rc[f"cim_mvm M={M} folded={folded} noise={noise}"] = \
                lib.cim_mvm_launch(
                    x.data_ptr(), codes.data_ptr(), pos.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), geom.array, 0.0,
                    wf.data_ptr() if folded else None, 0, 0,
                    0.1 if noise else 0.0, stream)
    # The batched folded decode form's four instances, bf16 x split over
    # a cluster of 2 (two slabs of I on a card of 4 SMs).
    wf2, reps, tags = z(2, 64, 8), z(2, dt=torch.int32), z(2, dt=torch.int32)
    for noise in (False, True):
        for bf16 in (False, True):
            x = z(2, 1, 64, dt=torch.bfloat16 if bf16 else torch.float32)
            out = z(2, 1, 8)
            geom = batched_geometry(2, 1, 64, 8, 64, 8, 8, 8, 64, False,
                                    4 if bf16 else 1, bf16, noise)
            rc[f"cim_mvm_batched noise={noise} bf16={bf16}"] = \
                lib.cim_mvm_batched_launch(
                    x.data_ptr(), wf2.data_ptr(), 512, scale.data_ptr(),
                    reps.data_ptr(), tags.data_ptr(), out.data_ptr(),
                    geom.array, 0, 0.1 if noise else 0.0, stream)
    # The grouped forms over two experts of I x 8 with offsets [0, 1, 3]:
    # the decode form (cap 2) and the prefill form with bf16 and f32 x
    # (cap 40), each also at I = 128 (split over a cluster of 2), the
    # general form (codes taken as off 16 bytes).
    offs = torch.tensor([0, 1, 3], dtype=torch.int32, device=dev)
    for I, cap, aligned, bf16 in ((8, 2, True, True), (128, 2, True, True),
                                  (8, 40, True, True), (8, 40, True, False),
                                  (128, 40, True, True), (8, 2, False, True)):
        codes2, pos2, scale2 = (z(2, I, 8, dt=torch.int16),
                                z(2, I, 1, dt=torch.int32), z(2))
        x = z(3, I, dt=torch.bfloat16 if bf16 else torch.float32)
        out = z(3, 8)
        geom = grouped_geometry(2, cap, I, 8, 8, 8, 8, 64, False, aligned,
                                bf16, 3)
        rc[f"cim_mvm_grouped form={geom.form} I={I} bf16={bf16}"] = \
            lib.cim_mvm_grouped_launch(
                x.data_ptr(), codes2.data_ptr(), pos2.data_ptr(),
                scale2.data_ptr(), offs.data_ptr(), out.data_ptr(), I * 8, I,
                geom.array, 0.0, stream)
    # The grouped folded forms (general, decode, prefill), each in its four
    # instances (noise, bf16 x), over the same two experts' folds at I =
    # 8, cap 2; the decode and prefill forms also at I = 128, split over a
    # cluster of 2.
    sc3, tags3 = z(2), z(2, dt=torch.int32)
    for form in GROUPED_FOLDED_FORMS:
        for I in ((8,) if form == FORM_GROUPED_FOLDED else (8, 128)):
            wf3 = z(2, I, 8)
            for noise in (False, True):
                for bf16 in (False, True):
                    x = z(3, I, dt=torch.bfloat16 if bf16 else torch.float32)
                    out = z(3, 8)
                    geom = grouped_folded_geometry(2, 2, I, 8, 8, bf16, noise,
                                                   3, form=form)
                    rc[f"cim_mvm_grouped_folded form={form} I={I} "
                       f"noise={noise} bf16={bf16}"] = \
                        lib.cim_mvm_grouped_folded_launch(
                            x.data_ptr(), wf3.data_ptr(), I * 8,
                            sc3.data_ptr(), tags3.data_ptr(), offs.data_ptr(),
                            out.data_ptr(), geom.array, 0,
                            0.1 if noise else 0.0, stream)
    # Both forms in f32 and in bf16, and the bf16 decode split over a
    # cluster of 2.
    for Sq, bf16, split in ((1, False, None), (17, False, None),
                            (1, True, None), (17, True, None), (1, True, 2)):
        dt = torch.bfloat16 if bf16 else torch.float32
        q, o = z(1, Sq, 1, 32, dt=dt), z(1, Sq, 1, 32, dt=dt)
        qp = z(1, Sq, dt=torch.int32)
        fg = flash_geometry(Sq, bf16, 1, 1, 1, Sq, 32, split=split)
        rc[f"flash_attention Sq={Sq} bf16={bf16} split={split}"] = \
            lib.flash_attention_launch(
                q.data_ptr(), q.data_ptr(), q.data_ptr(), qp.data_ptr(),
                qp.data_ptr(), o.data_ptr(), 1, Sq, Sq, 1, 1, 32, Sq, Sq, 0,
                1.0, fg.array, stream)
    m = z(1, 4, 16, dt=torch.uint8)
    s, n, nf = z(1, 4), z(1, 4), z(1)
    for form in (0, 1):                # the byte and the vector form
        rc[f"manhattan_score form={form}"] = lib.manhattan_score_launch(
            m.data_ptr(), None, s.data_ptr(), n.data_ptr(), nf.data_ptr(),
            1, 4, 16, 0, 1.0, form, stream)
    g, r = z(1, 1, 1, 16), z(1, 4, 16)
    h, hs, hT, cT = z(1, 1, 4), z(1, 1, 1, 4), z(1, 1, 4), z(1, 1, 4)
    rc["slstm_scan"] = lib.slstm_scan_launch(
        g.data_ptr(), r.data_ptr(), h.data_ptr(), h.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), 1, 1, 1, 4,
        slstm_geometry(1, 4).array, 0, stream)
    gb, rb, hb = (t.to(torch.bfloat16) for t in (g, r, h))
    hsb, hTb, cTb = (t.to(torch.bfloat16) for t in (hs, hT, cT))
    rc["slstm_scan bf16"] = lib.slstm_scan_launch(
        gb.data_ptr(), rb.data_ptr(), hb.data_ptr(), hb.data_ptr(),
        hsb.data_ptr(), hTb.data_ptr(), cTb.data_ptr(), 1, 1, 1, 4,
        slstm_geometry(1, 4, True).array, 7, stream)
    img = z(2, dt=torch.int64)
    rc["bitslice_pack"] = lib.bitslice_pack_launch(
        codes.data_ptr(), 2, img.data_ptr(), 2, 8, 0, stream)
    # line_solve's forms in both dtypes: the factor in registers (64x64),
    # in shared memory (3x5), and the stream form (8x8, forced).
    for dt in (torch.float64, torch.float32):
        for J, K, form in ((64, 64, None), (3, 5, None), (8, 8, "stream")):
            g, r, zz = z(1, J, K, dt=dt), z(1, 2, J, K, dt=dt), z(
                1, 2, J, K, dt=dt)
            lg = dict(line_geometry(J, K, dt, form=form), grid=1)
            scr = z(1, 3, J, K, dt=dt)      # the stream form's scratch
            rc[f"line_solve {dt} {J}x{K} {form}"] = lib.line_solve_launch(
                g.data_ptr(), r.data_ptr(), zz.data_ptr(), scr.data_ptr(), 1,
                J, K, 0.4, Geometry.of(LINE_FIELDS, lg).array, stream)
    torch.cuda.synchronize()
    bad = {k: v for k, v in rc.items() if v}
    if bad:
        raise RuntimeError(f"CUDA kernel self-check failed: {bad}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and checked at first call."""
    global _LIB
    if _LIB is not None:             # loaded: no lock on the launch path
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch kernels need a CUDA device")
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        lib_path = out / f"librepro_torch_kernels.{_digest()}.so"
        built = not lib_path.exists()
        log = _compile(lib_path) if built else ""
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _BUILD_INFO.update(path=str(lib_path), built=built, log=log)
        _self_check(lib)
        _LIB = lib
        return lib


def build_info() -> dict:
    """Path of the loaded library, whether this process built it, and
    the compiler log (``-Xptxas -v`` register and shared-memory use)."""
    return dict(_BUILD_INFO)


def check_status(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def stream_arg(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle (the
    launchers take it as ``void*``)."""
    return torch._C._cuda_getCurrentRawStream(device.index or 0)
