"""The two DP kernels' large routes, from shapes alone (no card here).

* ``intrinsic_kernel.large_grid_blocks``, the Python copy of the intrinsic
  DP's cooperative grid (csrc/intrinsic_kernel.cu large_grid_blocks): one
  grid point a thread of 256-thread blocks up to every block the card holds,
  every block it holds in cubic mode; ``chip_smoke.py`` and
  tests/test_torch_cuda_kernels.py hold it to the kernel's launch report.
  The route rule at an hourly year's crossing (the table cap at G = 3,830).
* ``tree_kernel.large_table_steps`` and ``large_launches``: the tree's large
  route fills as many steps' decision tables a launch as
  ``TABLE_SCRATCH_CAP`` holds, then launches ev and decide a step (ev,
  moments and decide in cubic mode).
* With CUDA and the kernel library stood in (each wrapper's checks pass on
  CPU tensors, and a recording function takes the place of each C entry),
  what ``tree_dp`` and ``intrinsic_dp`` hand their large route's entry and
  count in their launch counters.
"""
import types

import pytest
import torch

from storage_tpu_torch.ops import _build, intrinsic_kernel, tree_kernel

H100_SMEM = 232_448
H100_SMS = 132
STEP_KEYS = intrinsic_kernel.STEP_KEYS


@pytest.mark.parametrize("g,mode,per_sm,want", [
    (32_768, "linear", 4, 128),       # one grid point a thread: 128 of the 528 resident blocks
    (32_768, "general", 2, 128),
    (100, "linear", 4, 1),
    (257, "general", 4, 2),
    (1_000_000, "linear", 4, 528),    # past the resident threads: each takes several points
    (6_144, "cubic", 4, 528),         # the moment rows over every SM
    (100, "cubic", 2, 264),
])
def test_intrinsic_large_grid_blocks(g, mode, per_sm, want):
    assert intrinsic_kernel.large_grid_blocks(g, mode, H100_SMS, per_sm) == want


def test_intrinsic_large_grid_blocks_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode must be one of"):
        intrinsic_kernel.large_grid_blocks(100, "spline", H100_SMS, 4)


def test_intrinsic_route_at_an_hourly_years_table_cap():
    """An hourly year (8,760 steps) in f32 keeps the shared route while its
    tables' scratch fits ``TABLE_SCRATCH_CAP``: up to G = 3,830, the large
    route from 3,831 (and on the headline's year far beyond)."""
    route = lambda g, n: intrinsic_kernel.intrinsic_route(g, 3, 0, "linear", 4, H100_SMEM, n)  # noqa: E731
    assert 8_760 * intrinsic_kernel.table_len(3_830, 0) * 4 <= intrinsic_kernel.TABLE_SCRATCH_CAP
    assert (route(3_830, 8_760), route(3_831, 8_760), route(3_831, 365)) == (
        "shared", "large", "shared")


@pytest.mark.parametrize("n,g,e,mode,itemsize,steps,launches", [
    (16, 65_536, 0, "linear", 4, 16, 33),           # T1 at G = 65,536: 4 MiB a step's table
    (16, 65_536, 0, "linear", 8, 16, 33),
    (16, 65_536, 0, "cubic", 4, 16, 49),
    (8_760, 65_536, 0, "linear", 4, 64, 137 + 2 * 8_760),  # an hourly year: 64 steps a fill
    (5, 2_000_000, 2, "general", 8, 1, 15),         # one step's table past the cap
])
def test_tree_large_table_steps_and_launches(n, g, e, mode, itemsize, steps, launches):
    assert tree_kernel.large_table_steps(n, g, e, itemsize) == steps
    assert tree_kernel.large_launches(n, g, e, mode, itemsize) == launches
    one = intrinsic_kernel.table_len(g, e) * itemsize
    assert steps == 1 or steps * one <= tree_kernel.TABLE_SCRATCH_CAP


def _arrays(n, g, r=3, dtype=torch.float64):
    """Tables of the DPs' shapes (values immaterial: nothing runs)."""
    arrays = {k: torch.ones(n, dtype=dtype) for k in STEP_KEYS[1:9]}
    arrays.update(fwd=torch.ones(n + 1, dtype=dtype), lower=torch.zeros(n + 1, dtype=dtype),
                  upper=torch.ones(n + 1, dtype=dtype),
                  grids=torch.linspace(0, 1, g, dtype=dtype).repeat(n + 1, 1),
                  **{k: torch.ones(n, r, dtype=dtype)
                     for k in ("ratchet_inv", "ratchet_min", "ratchet_max")})
    return arrays


class _Entry:
    """A stand-in C entry: records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _stand_in(monkeypatch, entries):
    """CUDA stood in: the wrappers' checks pass on CPU tensors, the stream
    is none, an H100's shared memory a block, the tree's launch report of a
    slab no shared-memory route holds, and ``entries`` as the library."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t, dtype=None: t[0].device)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(_build, "smem_limit", lambda device: H100_SMEM)
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(**entries))
    monkeypatch.setattr(tree_kernel, "_info",
                        lambda *args: {"max_rows": 0, "max_grid": 2})


@pytest.mark.parametrize("mode", ["linear", "general", "cubic"])
def test_tree_dp_large_route_bookkeeping(monkeypatch, mode):
    """N = 7 steps with the table scratch cut to 3 steps' tables: the entry
    gets a scratch of 3 steps and an ev scratch (and moments and rhs scratch
    in cubic mode alone), and ``large_launches`` counts 3 table launches and
    14 ev and decide launches (21 with the moments in cubic mode)."""
    n, m, g, w, e = 7, 5, 40, 3, 1
    monkeypatch.setattr(tree_kernel, "TABLE_SCRATCH_CAP",
                        3 * intrinsic_kernel.table_len(g, e) * 8)
    entry = _Entry()
    _stand_in(monkeypatch, {"stt_tree_dp_large_f64": entry})
    tree = {"spot": torch.ones(n + 1, m, dtype=torch.float64),
            "band": torch.full((n, m, w), 1 / w, dtype=torch.float64),
            "band_start": torch.zeros(n, m, dtype=torch.int64)}
    solver = torch.eye(g - 2, dtype=torch.float64) if mode == "cubic" else None
    before = (tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches,
              tree_kernel.tree_dp.large_launches)
    values = tree_kernel.tree_dp(_arrays(n, g), tree, torch.zeros(m, g, dtype=torch.float64), e,
                                 False, mode, solver)
    assert values.shape == (n + 1, m, g)
    (args,) = entry.calls
    assert args[:8] == (n, m, g, w, 3, e, 0, intrinsic_kernel.MODES[mode])
    table, table_steps, ev, cubic_scratch = args[18], args[19], args[20], args[21:23]
    assert table is not None and table_steps == 3 and ev is not None
    assert all((p is not None) == (mode == "cubic") for p in cubic_scratch)
    launches = 3 + n * (3 if mode == "cubic" else 2)
    assert tree_kernel.large_launches(n, g, e, mode, 8) == launches
    assert (tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches,
            tree_kernel.tree_dp.large_launches) == (before[0], before[1], before[2] + launches)


@pytest.mark.parametrize("mode", ["linear", "general", "cubic"])
def test_intrinsic_dp_large_route_bookkeeping(monkeypatch, mode):
    """Past the shared route's largest G (cubic: forced at G = 40) the
    wrapper calls the large route's entry once, with the rhs scratch in
    cubic mode alone and no table scratch, and counts one launch in
    ``launches`` and ``large_launches``."""
    cubic = mode == "cubic"
    n, g = 4, 40 if cubic else intrinsic_kernel.max_grid(3, 0, mode, 8, H100_SMEM) + 1
    entry = _Entry()
    _stand_in(monkeypatch, {"stt_intrinsic_dp_large_f64": entry})
    solver = torch.zeros(g - 2, g - 2, dtype=torch.float64) if cubic else None
    before = intrinsic_kernel.intrinsic_dp.launches, intrinsic_kernel.intrinsic_dp.large_launches
    intrinsic_kernel.intrinsic_dp(_arrays(n, g), torch.zeros(g, dtype=torch.float64), 0.0, 0,
                                  False, mode, solver, route="large" if cubic else None)
    (args,) = entry.calls
    assert args[:6] == (n, g, 3, 0, 0, intrinsic_kernel.MODES[mode])
    moments, rhs = args[15], args[16]
    assert (moments is not None, rhs is not None) == (cubic, cubic)
    assert (intrinsic_kernel.intrinsic_dp.launches,
            intrinsic_kernel.intrinsic_dp.large_launches) == (before[0] + 1, before[1] + 1)
