"""Threefry-2x32 counter normals (kernel A) and the simulation sweep built on
them.

Counterpart of ``storage_tpu.ops.rng_kernel.normal_halves_pallas``: for each
block row r and path s, the counter pair (ids[s], b0 + r) is hashed under a
fixed key and both output words become standard normals,
z1[r, s] and z2[r, s].  The CUDA kernel is ``csrc/rng_kernel.cu``; the plain
version below is the same function in tensor code and is what runs for CPU
tensors.

The valuation's paths do not go through those panels of normals: the
simulation sweep (``simulate_sweep``, ``csrc/sim_sweep.cu``) draws the same
words in registers, takes the exact OU steps and builds the spot, and writes
only the factors and the spot (the JAX package's ``simulate_ou_paths``: the
Pallas draw, a ``lax.scan`` of OU steps and one spot pass).
``simulate_sweep_plain`` is the same function in tensor code, in the kernel's
order of operations.

torch has no uint32 ``add`` or shifts on the CPU, so the plain threefry hashes
in int64 masked to 32 bits.  ``erfinv`` is a transcription of XLA's
``erf_inv`` polynomials (Giles) in f32 and f64, not ``torch.special.erfinv``:
the RNG identity with the JAX package is part of the reference contract.
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import numpy as np
import torch

from . import _build

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The threefry-2x32 hash on int64 tensors holding uint32 values, exactly
    as JAX's unrolled lowering (same key schedule, rotations and injection
    order).  Returns the two output words as int64 tensors."""
    k0, k1 = int(k0) & MASK32, int(k1) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV64_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356,
)
_ERFINV64_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV64_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221,
)


def erfinv(x):
    """XLA's ``erf_inv`` (Giles' polynomials: 9 terms in f32, three ranges of
    23/19/17 terms in f64), evaluated op for op in the tensor's dtype."""
    w = -torch.log1p(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        lo, hi = _ERFINV32
        p = torch.where(lt, lo[0], hi[0]).to(x.dtype)
        for i in range(1, len(lo)):
            p = torch.where(lt, lo[i], hi[i]) + p * w
    else:
        lt_625 = w < 6.25
        lt_16 = w < 16.0
        sqrt_w = torch.sqrt(w)
        w = torch.where(lt_625, w - 3.125, sqrt_w - torch.where(lt_16, 3.25, 5.0))

        def coeff(i):
            c = torch.full_like(x, _ERFINV64_LT_6_25[i])
            if i < 19:
                c = torch.where(lt_625, c, _ERFINV64_LT_16[i])
            if i < 17:
                c = torch.where(lt_16, c, _ERFINV64_GE_16[i])
            return c

        p = coeff(0)
        for i in range(1, 17):
            p = coeff(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt_16, coeff(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt_625, coeff(i) + p * w, p)
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def bits_to_normal(bits_hi, bits_lo, dtype):
    """uint32 word(s) held in int64 → standard normal via √2·erfinv(u), u
    uniform on (−1, 1) from the mantissa trick.  f32 consumes one word per
    draw, f64 two (``spot_sim._bits_to_normal`` of the JAX package)."""
    if dtype == torch.float64:
        mantissa = (bits_hi << 20) | (bits_lo >> 12) | 0x3FF0000000000000
        x = mantissa.view(torch.float64) - 1.0
        lo = float(np.nextafter(np.float64(-1.0), np.float64(0.0)))
        sqrt2 = float(np.sqrt(2.0))
    else:
        mantissa = ((bits_hi >> 9) | 0x3F800000).to(torch.int32)
        x = mantissa.view(torch.float32) - 1.0
        lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
        sqrt2 = float(np.float32(np.sqrt(2.0)))
    u = torch.clamp(x * 2.0 - 1.0, min=lo)
    return sqrt2 * erfinv(u)


def normal_halves_plain(key: tp.Tuple[int, int], b0: int, nb: int, ids, sign=None):
    """(z1, z2) [nb, S] f32 in tensor code (the kernel's plain version).
    ``ids`` [S] int (path identities, uint32 values), ``sign`` [S] f32 or None."""
    hi = ids.to(torch.int64)[None, :]
    lo = (b0 + torch.arange(nb, dtype=torch.int64, device=ids.device))[:, None] & MASK32
    w1, w2 = threefry2x32(key[0], key[1], hi.expand(nb, -1), lo.expand(-1, ids.shape[0]))
    z1 = bits_to_normal(w1, None, torch.float32)
    z2 = bits_to_normal(w2, None, torch.float32)
    if sign is not None:
        z1 = z1 * sign[None, :]
        z2 = z2 * sign[None, :]
    return z1, z2


def normal_halves(key: tp.Tuple[int, int], b0: int, nb: int, ids, sign=None):
    """(z1, z2) [nb, S] f32 normals of the counter pairs (ids[s], b0 + r).

    CPU tensors take the plain version; CUDA tensors launch the kernel (ids
    int32 holding the uint32 path identities, sign f32 or None)."""
    if ids.device.type == "cpu":
        return normal_halves_plain(key, b0, nb, ids, sign)
    if ids.dim() != 1 or ids.shape[0] < 1 or nb < 1:
        raise ValueError("normal_halves: ids must be [S] with S >= 1, and nb >= 1")
    _build.require_cuda("normal_halves", ids, dtype=torch.int32)
    if sign is not None:
        _build.require_cuda("normal_halves", sign)
        if sign.device != ids.device or sign.shape != ids.shape:
            raise ValueError("normal_halves: sign must be f32 [S] beside ids")
    s = ids.shape[0]
    z1 = torch.empty((nb, s), dtype=torch.float32, device=ids.device)
    z2 = torch.empty((nb, s), dtype=torch.float32, device=ids.device)
    lib = _build.library()
    rc = lib.stt_normal_halves(
        int(key[0]) & MASK32, int(key[1]) & MASK32, int(b0) & MASK32, nb, s,
        ids.data_ptr(), None if sign is None else sign.data_ptr(),
        z1.data_ptr(), z2.data_ptr(), _build.stream_handle(ids.device),
    )
    normal_halves.launches += 1
    _build.check(rc, "normal_halves")
    return z1, z2


normal_halves.launches = 0


def threefry_words(key: tp.Tuple[int, int], b0: int, nb: int, ids):
    """The raw threefry words (w1, w2) [nb, S] of the counter pairs
    (ids[s], b0 + r), computed on the card by the hash of kernel A: the check
    that holds the CUDA hash bit for bit against ``threefry2x32``.  CUDA
    tensors only (ids int32); the words come back as int32 bit patterns."""
    _build.require_cuda("threefry_words", ids, dtype=torch.int32)
    s = ids.shape[0]
    w1 = torch.empty((nb, s), dtype=torch.int32, device=ids.device)
    w2 = torch.empty((nb, s), dtype=torch.int32, device=ids.device)
    rc = _build.library().stt_threefry_words(
        int(key[0]) & MASK32, int(key[1]) & MASK32, int(b0) & MASK32, nb, s,
        ids.data_ptr(), w1.data_ptr(), w2.data_ptr(), _build.stream_handle(ids.device),
    )
    _build.check(rc, "threefry_words")
    return w1, w2


def normals_by_step(z1, z2, num_steps: int, num_factors: int):
    """The f32 draws of steps 0..P-1 as [P, F, S] from the halves (z1, z2) of
    blocks 0.. (``normal_halves``): word W = k·F + i is row W//2 of z1 when W
    is even, of z2 when odd."""
    p, f, s = int(num_steps), int(num_factors), z1.shape[1]
    return torch.stack([z1, z2], dim=1).reshape(-1, s)[:p * f].reshape(p, f, s)


def sweep_normals_plain(key: tp.Tuple[int, int], ids, sign, num_steps: int, num_factors: int,
                        start: int = 0):
    """The f32 draws of steps start..start+P-1 as [P, F, S] in tensor code, as
    the sweep kernel addresses them: word W = k·F + i of step k is half W%2 of
    the block of counter (ids[s], W//2).  Each normal times ``sign`` [S] where
    given."""
    p, f = int(num_steps), int(num_factors)
    w0 = int(start) * f
    z1, z2 = normal_halves_plain(key, w0 // 2, (w0 % 2 + p * f) // 2 + 1, ids, sign)
    words = torch.stack([z1, z2], dim=1).reshape(-1, z1.shape[1])
    return words[w0 % 2:w0 % 2 + p * f].reshape(p, f, -1)


def ou_sweep_plain(z, decay, chol, vols, c, x0=None):
    """The sweep kernel's steps in tensor code, elementwise and in its order:
    x_k = decay_k ⊙ x_{k-1} + L_k z_k with L_k z_k summed over j left to right,
    ln S_k = (Σ_i vols_k,i·x_k,i, i left to right) + c_k, S_k = exp(ln S_k).
    z [P, F, S], the entry state ``x0`` [F, S] (zeros where None); returns
    (factors [P, F, S], spot [P, S])."""
    p, f, s = z.shape
    factors = torch.empty_like(z)
    log_spot = torch.empty((p, s), dtype=z.dtype, device=z.device)
    x = torch.zeros((f, s), dtype=z.dtype, device=z.device) if x0 is None else x0
    for k in range(p):
        lz = chol[k, :, 0, None] * z[k, 0]
        for j in range(1, f):
            lz = lz + chol[k, :, j, None] * z[k, j]
        x = x * decay[k, :, None] + lz
        factors[k] = x
        ln_s = vols[k, 0] * x[0]
        for i in range(1, f):
            ln_s = ln_s + vols[k, i] * x[i]
        log_spot[k] = ln_s + c[k]
    return factors, torch.exp(log_spot)


def simulate_sweep_plain(key: tp.Tuple[int, int], ids, sign, decay, chol, vols, c, start: int = 0,
                         x0=None):
    """(factors [P, F, S], spot [P, S]) of the paths ``ids`` in tensor code,
    f32: the sweep kernel's plain version (``sweep_normals_plain``, then
    ``ou_sweep_plain``), resumed at ``start`` from ``x0`` as the kernel."""
    p, f = decay.shape
    z = sweep_normals_plain(key, ids, sign, p, f, start)
    return ou_sweep_plain(z, decay, chol, vols, c, x0)


def simulate_sweep(key: tp.Tuple[int, int], ids, sign, decay, chol, vols, c, start: int = 0,
                   x0=None):
    """(factors [P, F, S], spot [P, S]) of steps start..start+P−1 of the paths
    ``ids`` (the identities of their counters: path ids, halved when
    antithetic), with each normal times ``sign`` [S] where given, from the
    entry state ``x0`` [F, S] (x_{start−1}; zeros where None) and those steps'
    tables decay [P, F], chol [P, F, F], vols [P, F] and c [P] = ln F −
    half_var.  A resumed sweep gives the rows of one sweep from step 0, to
    the bit; the state it leaves is its last factor row.

    CPU tensors take the plain version; CUDA tensors launch the sweep kernel
    once (ids int32 holding the uint32 identities, everything else f32): at
    any F that the card's shared memory takes (``sweep_info``'s
    ``max_factors``, over a hundred on an H100), compiled per F up to 12
    factors and on its wide route beyond."""
    if decay.device.type == "cpu":
        return simulate_sweep_plain(key, ids, sign, decay, chol, vols, c, start, x0)
    if decay.dim() != 2:
        raise ValueError("simulate_sweep: decay must be [P, F]")
    p, f = decay.shape
    if (chol.shape != (p, f, f) or vols.shape != (p, f) or c.shape != (p,) or ids.dim() != 1
            or ids.shape[0] < 1 or f < 1 or start < 0):
        raise ValueError("simulate_sweep: expected decay [P, F], chol [P, F, F], vols [P, F], "
                         "c [P] and ids [S] with F >= 1 and S >= 1, and start >= 0")
    device = _build.require_cuda("simulate_sweep", decay, chol, vols, c)
    tensors = tuple(t for t in (ids, sign, x0) if t is not None)
    if any(t.device != device for t in tensors):
        raise ValueError("simulate_sweep: ids, sign and x0 must lie beside the step tables")
    _build.require_cuda("simulate_sweep", ids, dtype=torch.int32)
    if sign is not None:
        _build.require_cuda("simulate_sweep", sign)
        if sign.shape != ids.shape:
            raise ValueError("simulate_sweep: sign must be f32 [S] beside ids")
    s = ids.shape[0]
    if x0 is not None:
        _build.require_cuda("simulate_sweep", x0)
        if x0.shape != (f, s):
            raise ValueError(f"simulate_sweep: x0 must be f32 [F, S] = [{f}, {s}]")
    info = sweep_info(f, device)
    if f > info["max_factors"]:
        raise ValueError(
            f"simulate_sweep: F={f} factors need {info['smem_bytes']} bytes of shared memory per "
            f"block (the state and draws of 256 paths, 2 KB a factor); this card allows "
            f"{info['smem_limit']}, so at most F={info['max_factors']}")
    factors = torch.empty((p, f, s), dtype=torch.float32, device=device)
    spot = torch.empty((p, s), dtype=torch.float32, device=device)
    rc = _build.library().stt_simulate_sweep(
        int(key[0]) & MASK32, int(key[1]) & MASK32, int(start), p, f, s, ids.data_ptr(),
        None if sign is None else sign.data_ptr(), None if x0 is None else x0.data_ptr(),
        decay.data_ptr(), chol.data_ptr(), vols.data_ptr(), c.data_ptr(), factors.data_ptr(),
        spot.data_ptr(), _build.stream_handle(device),
    )
    simulate_sweep.launches += 1
    _build.check(rc, "simulate_sweep")
    return factors, spot


simulate_sweep.launches = 0

_INFO_FIELDS = ("paths_per_block", "smem_bytes", "smem_limit", "max_factors", "blocks_per_sm",
                "registers")


@functools.lru_cache(maxsize=16)
def _sweep_info(f: int, device_index: int) -> dict:
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.library().stt_simulate_sweep_info(f, out), "stt_simulate_sweep_info")
    return dict(zip(_INFO_FIELDS, out))


def sweep_info(f: int, device) -> dict:
    """Launch report of the sweep kernel at F factors on a CUDA device: paths
    per block, shared memory bytes per block (none up to 12 factors; the
    wide route's state and draws beyond), the device's limit per block, the
    largest F of the route that F takes, blocks per SM (0 where F does not
    fit) and registers per thread."""
    if f < 1:
        raise ValueError(f"sweep_info: F={f}; the sweep takes F >= 1")
    return _sweep_info(int(f), torch.device(device).index or 0)


def sweep_sass_name(f: int) -> str:
    """What the mangled name of the sweep kernel at F factors holds (for
    ``_build.sass_instructions``; the wide route's beyond 12)."""
    return f"sim_sweep_kernelILi{f if f <= 12 else 0}EE"
