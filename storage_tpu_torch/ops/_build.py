"""Build and bind the hand-written CUDA kernels of ``storage_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds rather than minutes.  Each source compiles in its
own ``nvcc`` process, all started together, and one more links them.  The
library lands in
``build/storage_tpu_torch/<source hash>/`` at the repository root, so a
changed source or flag rebuilds and an unchanged one is reused.  Nothing
happens at import time: the first wrapper that launches a kernel builds.

Each C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "storage_tpu_torch"
LIB_NAME = "libstorage_tpu_torch_kernels.so"
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_D = ctypes.c_double

# C signature of every entry point: (argtypes), all returning a cudaError_t.
SIGNATURES = {
    # k0, k1, b0, nb, S, ids, sign (or NULL), z1, z2, stream
    "stt_normal_halves": (_U, _U, _U, _I, _I, _P, _P, _P, _P, _P),
    # k0, k1, b0, nb, S, ids, w1, w2, stream
    "stt_threefry_words": (_U, _U, _U, _I, _I, _P, _P, _P, _P),
    # k0, k1, start, P, F, S, ids, sign (or NULL), x_in (or NULL), decay, chol,
    # vols, c, factors, spot, stream
    "stt_simulate_sweep": (_U, _U, _U, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # F, out int[6] (the sweep's launch report)
    "stt_simulate_sweep_info": (_I, _P),
    # G, tile, S, F, D, basis table (host int[B*(1+F)+1]), v, spot, factors,
    # spot_prev, factors_prev, mean, std, mean_prev, std_prev, idx_lo, w_hi,
    # dci, a, b, best_out, partials, moments, stream
    "stt_decision_update_moments": (
        _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P,
    ),
    # Kernel B's wide body: G, tile, S, F, D, B, shared row (else the register
    # row), powers (a device int8 [B, F + 1]), then as
    # stt_decision_update_moments from v
    "stt_decision_update_moments_wide": (_I,) * 7 + (_P,) * 19,
    # G, D, B, large route, out int[6] (kernel B's launch report)
    "stt_decision_update_moments_info": (_I, _I, _I, _I, _P),
    # G (or a tile), D, B, F, shared row (else the register row), out int[6]
    # (kernel B's wide body's launch report)
    "stt_decision_update_moments_wide_info": (_I, _I, _I, _I, _I, _P),
    # G (a tile), D, B, out int[6] (kernel D's launch report)
    "stt_decision_update_info": (_I, _I, _I, _P),
    # out int[4]: the most basis functions and factors a kernel takes, the
    # most basis functions of kernel E's wide route and of its register row
    "stt_limits": (_P,),
    # out int[1]: the current device's shared memory a block can opt in to
    "stt_smem_limit": (_P,),
    # G, D, B, idx_lo, w_hi, ci, a, b, records, stream
    "stt_pack_records": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # G, tile, S, D, B, v, dm_std_t, spot, records, best_out, stream
    "stt_decision_update": (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # G, tile, spread solve, S, F, D, basis table, ridge, v, spot, factors,
    # spot_prev, factors_prev, xtx, xty_t, cmean, cstd, mean_prev (or NULL),
    # std_prev (or NULL), idx_lo, w_hi, a, b, best_out, mean_out, std_out,
    # coeffs_out, dci, solve scratch (or NULL), partials, moments, stream
    "stt_decision_update_fullstep": (
        _I, _I, _I, _I, _I, _I, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ),
    # Kernel E's wide route: G, tile, spread solve, S, F, D, B, shared row
    # (else the register row), powers (a device int8 [B, F + 1]), ridge, then
    # as stt_decision_update_fullstep from v
    "stt_decision_update_fullstep_wide": (
        _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ),
    # N, S, F, G, R, E, is_step, general grids, basis table, packed tables,
    # spot, factors, inv0, pv0 (or NULL), inv_out, pv_out, then (each or
    # NULL) the rows of inventory, volume, fuel and immediate PV, partials,
    # totals, stream
    "stt_forward_sweep": (
        _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P,
    ),
    # The monomial mode's wide route: N, S, F, B, G, R, E, is_step, general
    # grids, powers (a device int8 [B, F + 1]), then as stt_forward_sweep
    # from the packed tables
    "stt_forward_sweep_wide": (_I,) * 9 + (_P,) * 15,
    # N, S, B, G, R, E, is_step, general grids, packed tables, spot, design
    # [N, B, S], then as stt_forward_sweep from inv0
    "stt_forward_sweep_design": (
        _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P,
    ),
    # G, B, R, F, E, design mode, general grids, out int[6] (the sweep's
    # launch report)
    "stt_forward_sweep_info": (_I, _I, _I, _I, _I, _I, _I, _P),
    # N, G, grid rows [N, G], out (rows of 2G + 1 floats), out's row stride
    # in floats, stream: the general-grid mode's index (general_tail)
    "stt_general_tail": (_I, _I, _P, _P, _I, _P),
    # The large route: as stt_forward_sweep and stt_forward_sweep_design, the
    # coefficients [N, G, B] and the grid rows [N, G] (or NULL) after the
    # packed tables; its launch report without G
    "stt_forward_sweep_large": (
        _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P,
    ),
    "stt_forward_sweep_design_large": (
        _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P,
    ),
    "stt_forward_sweep_wide_large": (_I,) * 9 + (_P,) * 17,
    "stt_forward_sweep_large_info": (_I, _I, _I, _I, _I, _I, _P),
    # N, S, is_double, dec, cons, spot, g, fwd, df_settle, partials, grad, stream
    "stt_forward_sweep_vjp": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # out int[1]: the sims one block of the VJP's first pass sums
    "stt_forward_sweep_vjp_chunk": (_P,),
    # N, G, R, E, is_step, mode, steps, ratchet inv/min/max, grids, v_end,
    # solver (or NULL), starting inventory, vs, moments (or NULL), the
    # decision tables' scratch, out, stream
    **{f"stt_intrinsic_dp_{bits}": (_I,) * 6 + (_P,) * 7 + (_D,) + (_P,) * 5
       for bits in ("f32", "f64")},
    # The large route: the same, with block_moments' rhs scratch (or NULL) in
    # place of the tables' scratch
    **{f"stt_intrinsic_dp_large_{bits}": (_I,) * 6 + (_P,) * 7 + (_D,) + (_P,) * 5
       for bits in ("f32", "f64")},
    # is_double, G, R, E, mode, out int[9] (the DP kernel's launch report)
    "stt_intrinsic_dp_info": (_I, _I, _I, _I, _I, _P),
    # is_double, G, R, E, mode, out int[9] (the large route's launch report)
    "stt_intrinsic_dp_large_info": (_I, _I, _I, _I, _I, _P),
    # N, M, G, W, R, E, is_step, mode, steps, ratchet inv/min/max, grids, spot,
    # band, band start, solver (or NULL), values, then the cluster route's
    # decision tables' scratch, stream: the cluster route (one launch) and the
    # large-slab route (a launch a step, no scratch)
    **{f"stt_tree_dp_{bits}": (_I,) * 8 + (_P,) * 12 for bits in ("f32", "f64")},
    **{f"stt_tree_dp_steps_{bits}": (_I,) * 8 + (_P,) * 11 for bits in ("f32", "f64")},
    # the large route: as the large-slab route, then the tables' scratch, the
    # steps it holds, the scratch of a step's ev, moments and rhs (or NULL),
    # stream
    **{f"stt_tree_dp_large_{bits}": (_I,) * 8 + (_P,) * 11 + (_I,) + (_P,) * 4
       for bits in ("f32", "f64")},
    # is_double, G, mode, out int[6] (the large-slab route's launch report)
    "stt_tree_dp_info": (_I, _I, _I, _P),
    # is_double, mode, out int[8] (the large route's launch report)
    "stt_tree_dp_large_info": (_I, _I, _P),
    # is_double, M, G, W, E, mode, out int[8] (the cluster route's report)
    "stt_tree_cluster_info": (_I, _I, _I, _I, _I, _I, _P),
    # kind (0 block, 1 cluster, 2 grid, 3 launch), cluster or grid size,
    # threads, iterations, stream (the chain floor's timing kernels)
    "stt_chain_steps": (_I, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build.")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact source set is already built;
    returns the library path.  The compiler's register/spill report is kept
    beside the library as ``ptxas.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        (lib.parent / "ptxas.log").write_text("".join(logs))
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log[-8000:]}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp_lib), *map(str, objects)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-8000:]}")
        os.replace(tmp_lib, lib)
    return lib


def sass_opcodes(lib: Path, kernel: str) -> collections.Counter:
    """Instructions by opcode (``FMUL.FTZ`` counts as ``FMUL``) in the SASS of
    the kernels of ``lib`` whose name holds ``kernel`` (``cuobjdump`` of the
    toolkit that built it)."""
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return counts


def sass_instructions(lib: Path, kernel: str) -> int:
    """Instructions in the SASS of the kernels of ``lib`` whose name holds
    ``kernel``."""
    return sum(sass_opcodes(lib, kernel).values())


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")


# kMaxB and kMaxF of csrc/common.cuh: the most basis functions and factors
# of the register routes of the kernels that build a monomial design on the
# card (B, E and C's monomial mode); kMaxWideB, the most basis functions of
# their wide routes, which take any factor count past them, and
# kMaxWideRegB, the most (padded) that B's and E's register row takes.  The
# shape routes (engines/lsmc.py design_in_memory, ops/decision_kernel.py
# moments_plan and fullstep_route, ops/forward_kernel.py sweep_route) read
# this copy, so they need no build and work on the CPU; chip_smoke.py holds
# it to the built library's ``limits``.
MAX_BASIS = 16
MAX_FACTORS = 8
MAX_WIDE_BASIS = 64
MAX_WIDE_REGISTER_BASIS = 32


@functools.lru_cache(maxsize=1)
def limits() -> dict:
    """The most basis functions and factors the monomial kernels take
    (``kMaxB`` and ``kMaxF`` of ``csrc/common.cuh``) and the most basis
    functions of kernel E's wide route (``kMaxWideB``) and of its register
    row (``kMaxWideRegB``), read from the built library."""
    out = (ctypes.c_int * 4)()
    check(library().stt_limits(out), "stt_limits")
    return {"max_basis": out[0], "max_factors": out[1], "max_wide_basis": out[2],
            "max_wide_register_basis": out[3]}


@functools.lru_cache(maxsize=16)
def _smem_limit(device_index: int) -> int:
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device_index):
        check(library().stt_smem_limit(out), "stt_smem_limit")
    return out[0]


def smem_limit(device) -> int:
    """The shared memory a block of the kernels can opt in to on a CUDA
    device, in bytes (232,448 on an H100): what the grid routes of kernels
    B, C, D and E are decided by (``ops.decision_kernel.moments_route`` and
    the others)."""
    return _smem_limit(torch.device(device).index or 0)


# What sets a launch's blocks per SM on an H100 (sm_90; every SM the same)
# besides its registers: the SM's threads and blocks, and the shared memory
# reserved for each block beside its own (the SM's shared memory is a
# block's limit, ``smem_limit``, plus this).
SM_THREADS = 2_048
SM_BLOCKS = 32
SMEM_RESERVED = 1_024
SMEM_UNIT = 128  # a block's shared memory is allocated in these


def blocks_per_sm(smem_bytes: int, threads: int, reg_blocks: int, smem_limit: int) -> int:
    """Blocks of a launch resident on one SM, as the card's occupancy counts
    them: none where its shared memory passes a block's limit, else the
    fewest that its shared memory (each block's rounded up to 128 bytes,
    with 1 KB reserved, of ``smem_limit`` + 1 KB an SM), its threads (2,048
    an SM), the SM's 32 blocks and its registers (``reg_blocks``) allow.
    The grid routes compare their kernels' routes by it."""
    if smem_bytes > smem_limit:
        return 0
    block = -(-smem_bytes // SMEM_UNIT) * SMEM_UNIT + SMEM_RESERVED
    by_smem = (smem_limit + SMEM_RESERVED) // block
    return min(by_smem, SM_THREADS // threads, SM_BLOCKS, reg_blocks)


def require_wide_basis(name: str, num_basis: int) -> None:
    """Raises ``ValueError`` before any launch past ``MAX_WIDE_BASIS`` terms,
    the most that the kernels building a monomial design on the card take
    (kernel B and C's monomial mode, on their wide routes, on any factor
    count).  No valuation reaches it: the engine routes such a basis to the
    design read from memory."""
    if num_basis > MAX_WIDE_BASIS:
        raise ValueError(
            f"{name}: {num_basis} basis functions; this kernel builds a monomial design on the "
            f"card and takes at most {MAX_WIDE_BASIS} (csrc/common.cuh kMaxWideB); the "
            f"design-in-memory route (kernel D, kernel C's design mode) takes any size")


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> torch.device:
    """Checks shared by the wrappers: every tensor on one CUDA device,
    contiguous and of ``dtype`` (``None`` skips the dtype check)."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {device}")
    return device


@functools.lru_cache(maxsize=64)
def basis_table(monomials, num_factors: int):
    """Monomial powers as the C ``int`` array the kernels read:
    ``[B, then per monomial its spot power and F factor powers]``; cached per
    basis (the kernels only read it)."""
    vals = [len(monomials)]
    for m in monomials:
        vals.extend(_powers(m, num_factors))
    return (ctypes.c_int * len(vals))(*vals)


def _powers(monomial, num_factors: int) -> list:
    powers = dict(monomial.factor_powers)
    return [monomial.spot_power, *(powers.get(f, 0) for f in range(num_factors))]


@functools.lru_cache(maxsize=64)
def wide_basis_table(monomials, num_factors: int, device: torch.device) -> torch.Tensor:
    """Monomial powers as the wide routes of kernels B, C and E read them: an
    int8 tensor [B, F + 1] on ``device`` (per monomial its spot power, then
    its F factor powers), which each block stages in shared memory; cached
    per basis, factor count and device (the kernels only read it)."""
    rows = [_powers(m, num_factors) for m in monomials]
    if any(not 0 <= p <= 127 for row in rows for p in row):
        raise ValueError("a monomial power beyond 127 does not fit the kernels' int8 table")
    return torch.tensor(rows, dtype=torch.int8, device=device)
