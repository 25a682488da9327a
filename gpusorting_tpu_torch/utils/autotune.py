"""Live-card tuner: measure the tile and routing sweeps on the card instead
of shipping a guessed table.

Port of `gpusorting_tpu/utils/autotune.py`.  The reference selects its
TuningParameters from a static table of measured cards (Tuner.h:14-927,
GetTuningParameters :895-927); the port's `"h100"` rows (core/config.py)
were measured on the card with these functions and with
`probes/torch_row_sweeps.py`, for the fields they do not sweep.  These
functions run the sweeps on the card and return `measured=True` rows:

    params, sweep = autotune(Mode.PAIRS)        # measure, pick best tile
    autotune(Mode.PAIRS, install=True)          # and make the tuner use it
    routing, sweep = autotune_routing()         # the segmented window cap
    routing, sweep = autotune_rangesweep()      # AUTO's rangesweep crossover

`install=True` registers the row as the process-wide override read by
`get_tuning_parameters` / `get_routing_parameters` (clear it with
`clear_tuning_overrides()` / `clear_routing_override()`).

Every cell is timed by `utils/timing.batch_timing` on int32 key codes (the
engines' biased carriers; random bits are random codes), so no cell times
the codec, and a pairs cell sorts an independent int32 payload plane made
once per size outside the timed region.  Timing is a device measurement:
every function raises where the device is not a CUDA card.  There is no
retry at a larger batch for a floored row, as the JAX package has: CUDA
events bracket only the sort, with no generator chain to subtract, so a
short sort is measured, never floored.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import config as _config
from ..core import prng as _prng
from ..core.config import Mode
from . import timing as _timing

# Radix tiles, in rows of 128 keys (1024 .. 16384 keys).  Each is a whole
# number of the downsweep's 8-key items and of the Upsweep's 4-key loads;
# radix16's binning pass cuts 4096-key partitions of its own whatever the
# tile.
DEFAULT_TILES = (8, 16, 32, 64, 128)


def _timed(sort_fn, n: int, batch: int, seed: int, device) -> dict:
    """batch_timing of `sort_fn` on n int32 key codes made on `device`."""
    return _timing.batch_timing(sort_fn, n, batch=batch, seed=seed,
                                key_dtype=torch.int32, device=device)


def _payload(n: int, device) -> torch.Tensor:
    """The pairs cells' payload plane: independent of the keys."""
    return torch.arange(n, dtype=torch.int32,
                        device=_prng.require_device(device))


def _engine_sort_fn(engine: str, tile: int, payload: torch.Tensor | None):
    """codes -> sorted codes (and payload) closure for one (engine, tile)
    cell; a payload makes it a pairs cell."""
    if engine == "radix16":
        from ..ops import radix16 as m

        keys, pairs = m.sort_codes_radix16, m.sort_pairs_radix16
    elif engine == "rts":
        from ..ops import rts as m

        keys, pairs = m.sort_codes_rts, m.sort_pairs_rts
    elif engine == "splitsweep":
        from ..ops import splitsweep as m

        keys, pairs = m.sort_codes_splitsweep, m.sort_pairs_splitsweep
    else:
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected radix16/rts/splitsweep)")
    if payload is None:
        return lambda c: keys(c, tile_rows=tile)
    return lambda c: pairs(c, payload, tile_rows=tile)


def autotune(
    mode: Mode = Mode.KEYS_ONLY,
    n: int = 1 << 22,
    tiles: tuple[int, ...] = DEFAULT_TILES,
    batch: int = 3,
    seed: int = 10,
    install: bool = False,
    engine: str = "radix16",
    device: torch.device | str = "cuda",
):
    """Measure the radix tile sweep on the card; return the best row.

    Times the named engine at each `tiles` entry on `n` keys (PAIRS mode
    with an independent payload).  Returns (TuningParameters, sweep) where
    sweep maps tile -> keys_per_sec; the row is the card's row with
    `radix_tile_rows` set to the fastest tile and `measured=True`.

    radix16 stays the default engine for parity with the JAX package, but
    its binning pass partitions 4096 keys of its own whatever the tile, so
    a radix16 sweep moves only the padding and the histogram: the sweep
    that decides `radix_tile_rows` is `engine="rts"`, whose Upsweep and
    downsweep run one block per tile.
    """
    if not tiles:
        raise ValueError("tiles must be non-empty")
    payload = _payload(n, device) if mode == Mode.PAIRS else None
    sweep = {}
    for tile in tiles:
        res = _timed(_engine_sort_fn(engine, tile, payload), n, batch, seed,
                     device)
        sweep[tile] = res["keys_per_sec"]
    best = max(sweep, key=sweep.get)
    base = _config.get_tuning_parameters(_config.get_device_info(device),
                                         mode)
    params = dataclasses.replace(base, radix_tile_rows=best, measured=True)
    if install:
        _config.set_tuning_override(mode, params)
    return params, sweep


def autotune_routing(
    n: int = 1 << 22,
    batch: int = 3,
    seed: int = 10,
    install: bool = False,
    window_candidates: tuple[int, ...] = (8192, 16384, 32768, 65536),
    device: torch.device | str = "cuda",
):
    """Measure the segmented sort's pairs window cap on the card.

    At each max segment length in `window_candidates`, random-length
    segments (`prng.make_random_segments`) of `n` u32 pairs are sorted by
    the two-window ladder (`stable3`) and by the whole-buffer composite;
    `window_max_pairs` becomes the largest length where the window won, or
    stays the card row's where the composite won everywhere.

    The JAX package also sweeps the mapped-row crossovers
    (`map_rows_min_*`); the port's row has none, since it sorts rows in
    one batched `torch.sort`, so there is no `map_candidates`.

    Returns (RoutingParameters, sweep) with `measured=True`;
    `install=True` registers it as the process-wide routing override.
    """
    from ..segsort import splitsort

    if not window_candidates:
        raise ValueError("window_candidates must be non-empty")
    payload = _payload(n, device)
    sweep: dict = {"window_pairs": {}}
    cap = 0
    for ml in window_candidates:
        offs, S = _prng.make_random_segments(n, ml, seed=seed, device=device)

        def win_fn(codes, offs=offs, S=S, ml=ml):
            return splitsort._windowed_segmented_sort(
                offs, codes, (payload,), S, ml, mode="stable3")

        def comp_fn(codes, offs=offs, S=S):
            return splitsort._composite_multi(offs, codes, (payload,), S, 32)

        rw = _timed(win_fn, n, batch, seed, device)["keys_per_sec"]
        rc = _timed(comp_fn, n, batch, seed, device)["keys_per_sec"]
        sweep["window_pairs"][ml] = {"window": rw, "composite": rc}
        if rw > rc:
            cap = max(cap, ml)
    base = _config.get_routing_parameters(_config.get_device_info(device))
    params = dataclasses.replace(base,
                                 window_max_pairs=cap or base.window_max_pairs,
                                 measured=True)
    if install:
        _config.set_routing_override(params)
    return params, sweep


def autotune_rangesweep(
    n_max: int = 1 << 28,
    batch: int = 2,
    seed: int = 10,
    install: bool = False,
    seg_candidates_keys: tuple[int, ...] = (1 << 22, 1 << 21),
    seg_candidates_pairs: tuple[int, ...] = (1 << 22, 1 << 21),
    device: torch.device | str = "cuda",
):
    """Measure AUTO's rangesweep crossovers on the card: the flat
    `torch.sort` against the range-exchange engine (ops/rangesweep.py).

    Sweep shape (per mode, keys then pairs):
      1. at `n_max`, time the flat sort and the engine at each seg
         candidate -> best seg + win/lose at n_max
      2. crossover bracket: re-time both at n_max//2 (pow2) and at
         3*(n_max//4) (non-pow2) with the best seg.  rangesweep_min is then
           - None                  if the engine loses at n_max
           - n_max                 if it loses both smaller sizes
           - (n_max//2) + 1        if it wins the non-pow2 size but loses
                                   the pow2 half
           - n_max//2              if it wins both.

    Returns (RoutingParameters, sweep) with `measured=True`: the card's
    row with `rangesweep_min`, `rangesweep_seg_elems` and their pairs
    twins set.  Where the pairs engine loses at n_max, the row's
    non-power-of-two pairs band (`rangesweep_min_pairs_nonpow2`) goes to
    None too, so no pairs size reaches the engine that lost.
    `rangesweep_min_pairs_wide` and `rangesweep_min_index` are not
    measured here and keep the row's values.  `install=True` registers the
    process-wide routing override.
    """
    from ..ops import flat_sort
    from ..ops import rangesweep as _rs

    if n_max % 4:
        raise ValueError("n_max must be divisible by 4")

    def rate(fn, m):
        return _timed(fn, m, batch, seed, device)["keys_per_sec"]

    sweep: dict = {}
    picks: dict = {}
    for mode_name, segs in (("keys", seg_candidates_keys),
                            ("pairs", seg_candidates_pairs)):
        pay = _payload(n_max, device) if mode_name == "pairs" else None

        def flat_fn(m):
            if pay is None:
                return flat_sort.sort_keys_u32
            p = pay[:m]
            return lambda c: flat_sort.sort_pairs_u32(c, p)

        def rs_fn(seg, m):
            if pay is None:
                return lambda c: _rs.sort_codes_rangesweep(c, seg_elems=seg)
            p = pay[:m]
            return lambda c: _rs.sort_pairs_rangesweep(c, p, seg_elems=seg)

        rows: dict = {("flat", n_max): rate(flat_fn(n_max), n_max)}
        best_seg, best_rate = None, 0.0
        for seg in segs:
            r = rate(rs_fn(seg, n_max), n_max)
            rows[(f"rs_seg{seg}", n_max)] = r
            if r > best_rate:
                best_seg, best_rate = seg, r
        if best_rate <= rows[("flat", n_max)]:
            picks[mode_name] = (None, best_seg or segs[0])
            sweep[mode_name] = {f"{k[0]}@{k[1]}": v for k, v in rows.items()}
            continue
        half, three_q = n_max // 2, 3 * (n_max // 4)
        wins = {}
        for m in (three_q, half):
            rf = rate(flat_fn(m), m)
            rr = rate(rs_fn(best_seg, m), m)
            rows[("flat", m)], rows[(f"rs_seg{best_seg}", m)] = rf, rr
            wins[m] = rr > rf
        if wins[half]:
            rs_min = half
        elif wins[three_q]:
            rs_min = half + 1  # wins strictly above the pow2 half
        else:
            rs_min = n_max
        picks[mode_name] = (rs_min, best_seg)
        sweep[mode_name] = {f"{k[0]}@{k[1]}": v for k, v in rows.items()}

    base = _config.get_routing_parameters(_config.get_device_info(device))
    params = dataclasses.replace(
        base,
        rangesweep_min=picks["keys"][0],
        rangesweep_seg_elems=picks["keys"][1],
        rangesweep_min_pairs=picks["pairs"][0],
        rangesweep_seg_elems_pairs=picks["pairs"][1],
        measured=True,
    )
    if picks["pairs"][0] is None:
        params = dataclasses.replace(params,
                                     rangesweep_min_pairs_nonpow2=None)
    if install:
        _config.set_routing_override(params)
    return params, sweep
