"""Wrapper of the line-preconditioner kernel (``kernel.cu``) and its
launch geometry."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.line_solve.ref import line_solve_plain
from repro_torch.launch.roofline import PEAK_F32, PEAK_F64, Cost

# A block's shared memory on Hopper (227 KB); the longest chain a family
# (a thread a chain, 8 warps a family).
MAX_SMEM = 232_448
MAX_SIDE = 256
# Square sides whose fast form keeps the Thomas factor in registers (a
# fully unrolled sweep; 64 f64 factors take 128 registers).
REG_LENGTHS = {torch.float64: (32, 64), torch.float32: (32, 64, 128)}
# Rows this short are staged at pitch K where 16-byte copies fit.
SHORT_ROW = 16
# The kernel's Geom struct, in order.
GEOM_FIELDS = ("f64", "form", "reg_len", "stages", "pitch", "vec_load",
               "vec_store", "threads", "smem", "chunk", "grid")
FORMS = ("fast", "stream")
# Operations a node of a chain: its diagonal (2), the pivot (2), one
# reciprocal, c (1), y (3) and the back sweep (2).
LINE_OPS = 11


def cost(T: int, J: int, K: int, dtype=torch.float64) -> Cost:
    """The work of one :func:`line_solve` over T tiles of J x K: r (two
    planes) and g read and z (two planes) written once; LINE_OPS a node
    of each of the two chain families, at the f64 (or f32) rate outside
    the tensor cores."""
    n = T * J * K
    f64 = dtype == torch.float64
    return Cost(2.0 * n * LINE_OPS, PEAK_F64 if f64 else PEAK_F32,
                5 * n * (8 if f64 else 4))


@functools.lru_cache(maxsize=None)
def line_geometry(J: int, K: int, dtype=torch.float64, form: str | None = None,
                  stages: int = 1, pitch: int | None = None,
                  registers: bool | None = None) -> dict:
    """The launch of a (J, K) tile in ``dtype`` (pure Python).

    ``fast`` when a tile's planes fit a block's shared memory: ``stages``
    slots of g and both r planes (two: the next tile's copies in flight
    beside the sweep), rows at ``pitch`` (odd by default, so the
    wordline sweep is free of bank conflicts, one word a copy; rows of
    at most ``SHORT_ROW`` at K, 16 bytes a copy, where that is aligned);
    the factor in registers where the tile is a square of a side in
    ``REG_LENGTHS``, else in two more planes.
    ``stream`` otherwise: a ring of ``chunk`` columns of the wordline
    family's g and r, two slots.  ``grid`` is left 0: the wrapper sets
    it from the card's occupancy (and the slots, ``geometry``)."""
    if not (1 <= J <= MAX_SIDE and 1 <= K <= MAX_SIDE):
        raise ValueError(f"line_solve takes tiles of at most {MAX_SIDE}x"
                         f"{MAX_SIDE} on the card (a thread a chain), got "
                         f"{J}x{K}")
    word = 8 if dtype == torch.float64 else 4
    vec = 16 // word
    threads = 32 * (-(-J // 32) + -(-K // 32))
    square = J == K and J in REG_LENGTHS[dtype]
    if registers is None:
        registers = square
    if registers and not square:
        raise ValueError(f"line_solve: no factor in registers at {J}x{K} "
                         f"in {dtype}")
    reg = J if registers else 0
    if pitch is None:
        # Odd, so a warp's wordline threads hit distinct banks; but where
        # the wordline chains are short, K (16-byte copies, a smaller
        # tile) gained more than the conflicts cost (128x10 on the H100).
        pitch = K if K <= SHORT_ROW and K % vec == 0 else K | 1

    def fast_smem(s: int) -> int:
        return (3 * s + (0 if reg else 2)) * J * pitch * word

    if form is None:
        form = "fast" if fast_smem(1) <= MAX_SMEM else "stream"
    if form == "fast":
        geom = dict(reg_len=reg, stages=stages, pitch=pitch,
                    vec_load=vec if pitch % vec == 0 and K % vec == 0 else 1,
                    vec_store=vec if K % vec == 0 else 1,
                    smem=fast_smem(stages), chunk=0)
    elif form == "stream":
        chunk = min(K, 128 // word)     # at most a 128-byte line a row
        geom = dict(reg_len=0, stages=2, pitch=0, vec_load=1, vec_store=1,
                    smem=4 * J * (chunk + 1) * word, chunk=chunk)
    else:
        raise ValueError(f"unknown line_solve form {form!r}")
    if geom["smem"] > MAX_SMEM:
        raise ValueError(f"line_solve: a {J}x{K} {form} tile takes "
                         f"{geom['smem']} bytes of shared memory (at most "
                         f"{MAX_SMEM})")
    return dict(geom, f64=int(word == 8), form=FORMS.index(form),
                threads=threads, grid=0)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(key: tuple) -> int:
    """Resident blocks a SM of the launch ``key`` (the GEOM_FIELDS values)
    describes, from the CUDA runtime's occupancy calculator."""
    out = (ctypes.c_int * 1)()
    geo = runtime.Geometry.of(GEOM_FIELDS, dict(zip(GEOM_FIELDS, key)))
    rc = runtime.library().line_solve_occupancy(geo.array, out)
    runtime.check_status("line_solve occupancy", rc)
    if out[0] < 1:
        raise RuntimeError(f"line_solve: no block of {geo.geom} fits an SM")
    return out[0]


def _blocks(geom: dict) -> int:
    return _blocks_per_sm(tuple(geom[f] for f in GEOM_FIELDS))


@functools.lru_cache(maxsize=None)
def geometry(J: int, K: int, dtype=torch.float64) -> dict:
    """The launch ``line_solve`` takes on the card: ``line_geometry``'s,
    with two slots (the next tile's copies in flight) where that leaves
    as many resident blocks a SM as one slot does, else one (the SM's
    other blocks then overlap a block's copies with their sweeps)."""
    one = line_geometry(J, K, dtype)
    if FORMS[one["form"]] != "fast":
        return one
    try:
        two = line_geometry(J, K, dtype, stages=2)
    except ValueError:
        return one
    return two if _blocks(two) >= _blocks(one) else one


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def line_solve(g: torch.Tensor, r: torch.Tensor, cw) -> torch.Tensor:
    """z = M^-1 r for the crossbar solver's line preconditioner: M =
    blockdiag(wordline chains along k, bitline chains along j) of
    conductances g (T, J, K) and wire conductance ``cw``; r (T, 2, J, K)
    of g's dtype (f64 or f32).  On a CUDA tensor the kernel runs (or
    this raises; J, K <= 256); on a CPU tensor its plain version."""
    if g.dim() != 3 or tuple(r.shape) != (g.shape[0], 2, *g.shape[1:]):
        raise ValueError(f"line_solve takes g (T, J, K) and r (T, 2, J, K), "
                         f"got {tuple(g.shape)} and {tuple(r.shape)}")
    if g.dtype != r.dtype or g.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"line_solve takes f64 or f32 g and r of one dtype, "
                        f"got {g.dtype} and {r.dtype}")
    if g.device != r.device:
        raise ValueError(f"g is on {g.device}, r on {r.device}")
    if g.device.type == "cpu":
        return line_solve_plain(g, r, cw)
    _, J, K = g.shape
    return launch(g, r, cw, geometry(J, K, g.dtype))


def launch(g: torch.Tensor, r: torch.Tensor, cw, geom: dict) -> torch.Tensor:
    """Launch the kernel at ``geom`` (``line_geometry``'s) on CUDA g, r;
    16-byte copies fall back to word copies on unaligned tensors."""
    g, r = g.contiguous(), r.contiguous()
    T, J, K = g.shape
    z = torch.empty_like(r)
    if any(t.data_ptr() % 16 for t in (g, r, z)):
        geom = dict(geom, vec_load=1, vec_store=1)
    grid = max(1, min(T, _sm_count(g.device.index or 0) * _blocks(geom)))
    scratch = (torch.empty((grid, 3, J, K), dtype=g.dtype, device=g.device)
               if FORMS[geom["form"]] == "stream" else None)
    geo = runtime.Geometry.of(GEOM_FIELDS, dict(geom, grid=grid))
    rc = runtime.library().line_solve_launch(
        g.data_ptr(), r.data_ptr(), z.data_ptr(),
        None if scratch is None else scratch.data_ptr(), T, J, K, float(cw),
        geo.array, runtime.stream_arg(g.device))
    runtime.count_launch("line_solve")
    runtime.check_status("line_solve", rc)
    return z


def occupancy(J: int, K: int, dtype=torch.float64) -> dict:
    """The kernel's launch at (J, K) in ``dtype``: its form, the side of
    a factor kept in registers (0: in shared planes), slots, shared
    memory and threads a block, resident blocks a SM (the CUDA runtime's
    occupancy calculator) and the warps a SM that sweep chains."""
    geom = geometry(J, K, dtype)
    blocks = _blocks(geom)
    return dict(form=FORMS[geom["form"]], reg_len=geom["reg_len"],
                stages=geom["stages"], blocks_per_sm=blocks,
                smem_bytes=geom["smem"], threads=geom["threads"],
                sweeping_warps_per_sm=blocks * (-(-J // 32) + -(-K // 32)))
