"""Command-line front-end of storage_tpu_torch (counterpart of
``storage_tpu.cli``): the user-facing analog of the reference's Excel
add-in worksheet functions (``CmdtyStorageXl.cs:37-113``,
``MultiFactorXl.cs:41-79``, ``IntrinsicXl.cs:38``, ``TrinomialXl.cs:39``,
``AddInInfoXl.cs:34-51``) for an environment without a spreadsheet host:
facilities and markets are described in JSON files, valuations run on the
card (``--device cuda``, the default) or on the CPU (``--device cpu``), the
LSMC valuation interactively (progress streamed to the terminal, Ctrl-C
cancels between 16-step segments and exits 130), and results land as CSV
files.

    python -m storage_tpu_torch create-storage facility.json --probe 2021-06-01:500
    python -m storage_tpu_torch intrinsic facility.json market.json
    python -m storage_tpu_torch three-factor facility.json market.json model.json \\
        --out results/
    python -m storage_tpu_torch trinomial facility.json market.json model.json
    python -m storage_tpu_torch version

Spec formats (JSON):

facility.json — CmdtyStorage constructor args:
    {"freq": "D", "start": "2021-04-01", "end": "2022-04-01",
     "injection_cost": 0.01, "withdrawal_cost": 0.025,
     "ratchets": [["2021-04-01", [[0, -150, 250], [2000, -200, 175]]]],
     "ratchet_interp": "linear"}
  or constant-rate form with min/max_inventory + max_injection/withdrawal_rate.

market.json:
    {"val_date": "2021-04-01", "inventory": 0.0, "interest_rate": 0.03,
     "fwd": {"2021-04-01": 20.0, ...}        # or "fwd_csv": "curve.csv"
     "settlement_lag_days": 20}              # settle = period end + lag

model.json (three-factor):
    {"spot_mean_reversion": 16.2, "spot_vol": 1.15, "long_term_vol": 0.14,
     "seasonal_vol": 0.18, "num_sims": 4096, "seed": 11,
     "basis_funcs": "1 + s + s*s + x_st + x_lt + x_sw"}
model.json (trinomial):
    {"spot_vol": 0.7, "mean_reversion": 14.5, "time_delta": 0.00274}
"""
from __future__ import annotations

import argparse
import json
import sys
import typing as tp

import pandas as pd


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _build_storage(spec: dict):
    from .facility import CmdtyStorage, RatchetInterp

    kwargs = dict(spec)
    freq = kwargs.pop("freq")
    start = kwargs.pop("start")
    end = kwargs.pop("end")
    inj = kwargs.pop("injection_cost")
    wdr = kwargs.pop("withdrawal_cost")
    if "ratchets" in kwargs:
        kwargs["ratchets"] = [
            (period, [tuple(node) for node in nodes])
            for period, nodes in kwargs["ratchets"]
        ]
        interp = kwargs.pop("ratchet_interp", "linear")
        kwargs["ratchet_interp"] = (
            RatchetInterp.STEP if str(interp).lower() == "step"
            else RatchetInterp.LINEAR
        )
    return CmdtyStorage(freq, start, end, inj, wdr, **kwargs)


def _load_curve(market: dict, freq: str) -> pd.Series:
    if "fwd_csv" in market:
        frame = pd.read_csv(market["fwd_csv"], header=None, names=["period", "price"])
        idx = pd.PeriodIndex(frame["period"], freq=freq)
        return pd.Series(frame["price"].to_numpy(dtype=float), index=idx)
    fwd = market["fwd"]
    idx = pd.PeriodIndex(list(fwd.keys()), freq=freq)
    return pd.Series([float(v) for v in fwd.values()], index=idx)


def _market_args(market: dict, storage) -> dict:
    freq = storage.freq
    lag = int(market.get("settlement_lag_days", 0))

    def settle(period):
        return period.asfreq("D", "end") + lag

    rates = market.get("interest_rate", 0.0)
    if "rates_csv" in market:
        frame = pd.read_csv(market["rates_csv"], header=None, names=["period", "rate"])
        rates = pd.Series(
            frame["rate"].to_numpy(dtype=float),
            index=pd.PeriodIndex(frame["period"], freq="D"),
        )
    return {
        "val_date": market["val_date"],
        "inventory": float(market.get("inventory", 0.0)),
        "fwd_curve": _load_curve(market, freq),
        "interest_rates": rates,
        "settlement_rule": settle if lag else None,
    }


def _write_results(out_dir: tp.Optional[str], res) -> None:
    if not out_dir:
        return
    import os

    os.makedirs(out_dir, exist_ok=True)
    res.deltas.to_csv(os.path.join(out_dir, "deltas.csv"), header=["delta"])
    res.expected_profile.to_csv(os.path.join(out_dir, "expected_profile.csv"))
    res.intrinsic_profile.to_csv(os.path.join(out_dir, "intrinsic_profile.csv"))
    res.trigger_prices.to_csv(os.path.join(out_dir, "trigger_prices.csv"))
    print(f"results written to {out_dir}/", file=sys.stderr)


def _progress_printer(label: str):
    def cb(frac: float) -> None:
        print(f"\r{label}: {frac:6.1%}", end="", file=sys.stderr, flush=True)
        if frac >= 1.0:
            print(file=sys.stderr)

    return cb


def cmd_version(_args) -> int:
    import torch

    from . import __version__

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"storage_tpu_torch {__version__} "
          f"[torch {torch.__version__}, CUDA {torch.version.cuda}, {cards} card(s)]")
    return 0


def cmd_create_storage(args) -> int:
    storage = _build_storage(_load_json(args.facility))
    print(f"freq={storage.freq} start={storage.start} end={storage.end} "
          f"must_be_empty_at_end={storage.empty_at_end}")
    for probe in args.probe or []:
        period, inv = probe.split(":")
        rng = storage.inject_withdraw_range(period, float(inv))
        print(
            f"{period} @ {inv}: inject_rate={rng.max_inject_withdraw_rate} "
            f"withdraw_rate={rng.min_inject_withdraw_rate} "
            f"min_inv={storage.min_inventory(pd.Period(period, freq=storage.freq))} "
            f"max_inv={storage.max_inventory(pd.Period(period, freq=storage.freq))}"
        )
    return 0


def cmd_intrinsic(args) -> int:
    from .api import intrinsic_value

    storage = _build_storage(_load_json(args.facility))
    market = _market_args(_load_json(args.market), storage)
    res = intrinsic_value(
        storage, market["val_date"], market["inventory"], market["fwd_curve"],
        interest_rates=market["interest_rates"],
        settlement_rule=market["settlement_rule"],
        num_inventory_grid_points=args.grid_points,
        grid_scheme=args.grid_scheme,
        device=args.device,
    )
    print(f"intrinsic_npv {res.npv:.2f}")
    if args.out:
        import os

        os.makedirs(args.out, exist_ok=True)
        res.profile.to_csv(os.path.join(args.out, "intrinsic_profile.csv"))
    return 0


def _sigint_poll():
    """Cooperative Ctrl-C: SIGINT sets a flag that the valuation's
    cancellation poll observes between host-chunked segments, so a long LSMC
    run aborts cleanly (JobCancelledError) instead of dying mid-dispatch
    with a KeyboardInterrupt."""
    import signal

    flag = {"cancelled": False}
    previous = signal.getsignal(signal.SIGINT)

    def handler(signum, frame):
        flag["cancelled"] = True

    signal.signal(signal.SIGINT, handler)
    return (lambda: flag["cancelled"]), previous


def cmd_three_factor(args) -> int:
    import signal

    from .api_lsmc import three_factor_seasonal_value
    from .jobs import JobCancelledError

    storage = _build_storage(_load_json(args.facility))
    market = _market_args(_load_json(args.market), storage)
    model = _load_json(args.model)
    # Graceful Ctrl-C is always on (exit 130 instead of a KeyboardInterrupt
    # in the middle of a launch); --quiet only silences the progress printer.
    poll, previous_handler = _sigint_poll()
    try:
        res = three_factor_seasonal_value(
            storage, market["val_date"], market["inventory"], market["fwd_curve"],
            market["interest_rates"], market["settlement_rule"],
            spot_mean_reversion=model["spot_mean_reversion"],
            spot_vol=model["spot_vol"],
            long_term_vol=model["long_term_vol"],
            seasonal_vol=model["seasonal_vol"],
            num_sims=int(model.get("num_sims", 4096)),
            basis_funcs=model.get(
                "basis_funcs", "1 + s + s*s + x_st + x_lt + x_sw"
            ),
            discount_deltas=bool(model.get("discount_deltas", False)),
            seed=model.get("seed"),
            num_inventory_grid_points=args.grid_points,
            on_progress_update=None if args.quiet else _progress_printer("valuing"),
            cancellation_poll=poll,
            deltas_method=model.get("deltas_method", "pathwise"),
            device=args.device,
        )
    except JobCancelledError:
        print("cancelled", file=sys.stderr)
        return 130
    finally:
        signal.signal(signal.SIGINT, previous_handler)
    print(f"npv            {res.npv:,.2f}")
    print(f"intrinsic_npv  {res.intrinsic_npv:,.2f}")
    print(f"extrinsic_npv  {res.extrinsic_npv:,.2f}")
    print(f"standard_error {res.val_sim_standard_error:,.2f}")
    _write_results(args.out, res)
    return 0


def cmd_trinomial(args) -> int:
    from .api import trinomial_value

    storage = _build_storage(_load_json(args.facility))
    market = _market_args(_load_json(args.market), storage)
    model = _load_json(args.model)
    vol_curve = pd.Series(
        float(model["spot_vol"]),
        index=pd.period_range(
            market["val_date"], storage.end, freq=storage.freq
        ),
    )
    npv = trinomial_value(
        storage, market["val_date"], market["inventory"], market["fwd_curve"],
        vol_curve, float(model["mean_reversion"]), float(model["time_delta"]),
        market["interest_rates"], market["settlement_rule"],
        num_inventory_grid_points=args.grid_points,
        device=args.device,
    )
    print(f"trinomial_npv {npv:,.2f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="storage_tpu_torch",
        description="Commodity storage valuation in PyTorch + CUDA (cmdty/storage analog)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("version", help="framework version + compute provider")
    p.set_defaults(fn=cmd_version)

    p = sub.add_parser("create-storage", help="validate a facility spec + probe rates")
    p.add_argument("facility")
    p.add_argument("--probe", action="append", metavar="PERIOD:INVENTORY",
                   help="print inject/withdraw rates at PERIOD:INVENTORY (repeatable)")
    p.set_defaults(fn=cmd_create_storage)

    def common(p):
        p.add_argument("--grid-points", type=int, default=100)
        p.add_argument("--out", help="directory for result CSVs")
        p.add_argument("--quiet", action="store_true")
        p.add_argument("--device", default="cuda",
                       help="where the valuation runs: cuda (the default) or cpu")

    p = sub.add_parser("intrinsic", help="intrinsic valuation")
    p.add_argument("facility")
    p.add_argument("market")
    p.add_argument("--grid-scheme", default="linspace",
                   choices=["linspace", "fixed_spacing"])
    common(p)
    p.set_defaults(fn=cmd_intrinsic)

    p = sub.add_parser("three-factor", help="3-factor-seasonal LSMC valuation")
    p.add_argument("facility")
    p.add_argument("market")
    p.add_argument("model")
    common(p)
    p.set_defaults(fn=cmd_three_factor)

    p = sub.add_parser("trinomial", help="one-factor trinomial-tree valuation")
    p.add_argument("facility")
    p.add_argument("market")
    p.add_argument("model")
    common(p)
    p.set_defaults(fn=cmd_trinomial)
    return parser


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
