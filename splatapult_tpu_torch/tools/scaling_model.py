"""Per-card milliseconds of the tile-sharded training step against the card
count D, and its scaling efficiency, on the H100: a prediction to test.

    python -m splatapult_tpu_torch.tools.scaling_model [--splats 1500000]
        [--scene garden|ball] [--chips 1 2 4 8]
        [--band-layout interleaved|contiguous] [--no-shard-prepare]
        [--device cuda|cpu]

The counterpart of the JAX repo's tools/scaling_model.py, with its flags, for
one view's step on a 1 x D tile mesh (parallel/mesh.py). For each D:

- the true per-band instance demand of the view
  (parallel/mesh.band_instance_demands: the rect clipping each rank's binning
  applies), its peak and beta = D x peak / total, and the per-card capacity
  from the peak band (render.capacity_mult_for_demand against the band's
  geometry, ops/binning.TileGrid): what parallel/mesh.calibrate_config_sharded
  allocates (its capacity bucket, render.CAPACITY_BUCKET; the JAX model sizes
  it exactly, which band_capacity gives with bucket 1);
- the phases of the peak band's step at that capacity: tools/roofline.py's
  rows on the band's own binning (the sorts and the gather at the card's
  measured rates, the kernels at their bounds, the bytes floors), and
  prepare_splats over N / D rows when it is sharded (N when not). On the card
  the tool measures the step first (roofline.measure_stages, on the whole
  view) and prices each phase at its stage there times its floor at D over
  its floor at D = 1 (each phase keeps the share of its floor that it reaches
  on one card), and the prepare at its time measured on N / D splats (held by
  the host's ~900 launches, it hardly shrinks with N): D = 1 is the measured
  step. On the CPU (no card to measure) each phase is priced at its floor and
  the prepare at the card's recorded busy time (PREPARE_FWD_VJP_MS); the
  output says that this is the floors' scaling, not a prediction of the step;
- the collectives over NVLink at an ASSUMED bandwidth (NVLINK_BYTES_PER_S,
  marked so in the output): with the prepare sharded, the 14-column feature
  all-gather and its gradient's reduce-scatter; on the replicated scene the
  gradient all-reduce of GRAD_FLOATS a splat (ring: 2 (D - 1) / D of the
  bytes), of which the SH gradient's share (SH_FLOATS) is the one all-reduce
  started inside the backward, the rest the terminal all-reduce after it.

The efficiency table (per-card ms and t1 / (D x tD), t1 the first D's
replicated step) has the JAX tool's three columns: the replicated step with
the SH all-reduce hidden behind the prepare's VJP (the terminal one
exposed), the replicated step with every all-reduce exposed, and ZeRO
(parallel/mesh.zero_fit_steps: no gradient all-reduce, Adam over N / D rows,
the prepare over N / D rows with the feature all-gather and its
reduce-scatter). The last line is one JSON object with every D's numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys

import torch

from splatapult_tpu_torch.tools import roofline as RL

NVLINK_BYTES_PER_S = 300e9  # ASSUMED effective per-card NVLink bandwidth; not measured
GRAD_FLOATS = 59  # means 3 + quats 4 + log_scales 3 + opacities 1 + sh 48
SH_FLOATS = 48  # the SH gradient, all-reduced inside the backward
PREP_FLOATS = 14  # prepare_splats' columns the feature all-gather moves
# prepare_splats forward + VJP on the first N splats of the garden stand-in's
# 1.5M, its 1080p view: the card's busy time (torch.profiler's sum of kernel
# times) by splat count, chip_smoke.py phase roofline on an NVIDIA H100 80GB
# HBM3 at 700.00 W. (CUDA events around the call time the host issuing its
# ~900 launches: 16-18 ms at every N here.)
PREPARE_FWD_VJP_MS = [(187_500, 1.7468), (375_000, 2.5946), (750_000, 4.7220),
                      (1_500_000, 9.0628)]
PREPARE_SOURCE = ("prepare_splats forward + VJP, device busy time, chip_smoke.py phase "
                  "roofline, NVIDIA H100 80GB HBM3, 700.00 W")
# the rows of tools/roofline.py that each D prices at the band (the prepare's
# is priced from its measured time), by the phase names of the output
PHASES = {"binning (sorts+expand)": "binning", "instance gather": "gather",
          "fwd kernel": "fwd kernel", "bwd kernel": "bwd kernel", "backward tail": "bwd tail",
          "pack_features fwd+bwd": "pack_features", "adam": "adam"}
PREPARE_ROW = "prepare_splats fwd+VJP"
# the prepare's stages of roofline.measure_stages
PREPARE_FWD_STAGE, PREPARE_STAGE = "prepare_splats forward", "prepare_splats forward + VJP"


def ring_allreduce_s(nbytes: float, d: int, bw: float = NVLINK_BYTES_PER_S) -> float:
    """A ring all-reduce of ``nbytes`` over ``d`` cards: 2 (d - 1) / d of them."""
    return nbytes * 2 * (d - 1) / d / bw


def allgather_s(nbytes: float, d: int, bw: float = NVLINK_BYTES_PER_S) -> float:
    """An all-gather (or its reduce-scatter) of ``nbytes`` in all over ``d``
    cards: (d - 1) / d of them into each."""
    return nbytes * (d - 1) / d / bw


def prepare_s(n: float, points=None) -> float:
    """prepare_splats forward + VJP over ``n`` splats at the measured times
    [(splats, ms)]: piecewise linear, the end segments extended."""
    pts = PREPARE_FWD_VJP_MS if points is None else points
    if len(pts) == 1:
        return pts[0][1] * n / pts[0][0] / 1e3
    i = 1
    while i < len(pts) - 1 and n > pts[i][0]:
        i += 1
    (n0, m0), (n1, m1) = pts[i - 1], pts[i]
    return max(0.0, m0 + (n - n0) * (m1 - m0) / (n1 - n0)) / 1e3


def band_capacity(scene, cam, cfg, d: int, layout: str, bucket: float) -> dict:
    """The per-band demands of the view on D tile shards and the per-card
    capacity the peak band calls for -> {bands, peak, total, beta, mult,
    emax, mcap, cfg (cfg at that capacity), grid (the peak band's),
    row_offset, y_shift (where view_inputs bins it)}."""
    from splatapult_tpu_torch.ops import tiled
    from splatapult_tpu_torch.parallel import mesh as PM

    R = importlib.import_module("splatapult_tpu_torch.render")
    n = scene.means.shape[0]
    bands = [int(x) for x in PM.band_instance_demands(scene, cam, cfg, d, layout)]
    peak, total = max(bands), sum(bands)
    cfg_band = PM._shard_config(cfg, d)
    mult = R.capacity_mult_for_demand(peak, n, cfg_band, bucket=bucket)
    cfg_d = dataclasses.replace(cfg, max_instance_mult=mult)
    rank = bands.index(peak)
    if layout == "interleaved":
        grid, y_shift = PM._band_grid(cfg_d, n, d), 0.0
    else:
        band = PM._shard_config(cfg_d, d)
        grid = tiled._grid_from_config(band, n)
        y_shift = float(cfg.height - (rank + 1) * band.height)
    return {"bands": bands, "peak": peak, "total": total, "beta": peak * d / max(total, 1),
            "mult": mult, "emax": grid.emax, "mcap": grid.mcap, "cfg": cfg_d, "grid": grid,
            "row_offset": rank if layout == "interleaved" else None, "y_shift": y_shift}


def phase_floors(scene, cam, cap: dict) -> dict:
    """tools/roofline.py's rows on the peak band's own binning at ``cap``
    (band_capacity) -> {"s": phase -> floor seconds, "stage": phase -> the
    stage of roofline.measure_stages it is held against, "prepare_fwd_share":
    the forward's share of the prepare row's bytes}."""
    v = RL.view_inputs(scene, cam, cap["cfg"], cap["grid"], cap["row_offset"], cap["y_shift"])
    rows = {r["name"]: r for r in RL.step_rows(v)}
    prep = rows[PREPARE_ROW]
    return {"s": {short: rows[name]["s"] for name, short in PHASES.items()},
            "stage": {short: rows[name]["stage"] for name, short in PHASES.items()},
            "prepare_fwd_share": prep["frame_s"] / prep["s"]}


def calibration(floors: dict, measured: dict) -> dict:
    """Each phase's stage measured on one card over its floor there
    (``floors``: phase_floors at D = 1), and the prepare's measured times by
    splat count (``measured``: roofline.measure_stages' stages_ms and
    prepare_ms_by_splats) -> {"scale": phase -> factor, "prepare_points":
    [(splats, ms)], "prepare_fwd_share": the measured forward's share of
    the prepare}."""
    stages = measured["stages_ms"]
    scale = {k: stages[floors["stage"][k]] / (s * 1e3) for k, s in floors["s"].items()}
    return {"scale": scale, "prepare_points": sorted(measured["prepare_ms_by_splats"].items()),
            "prepare_fwd_share": stages[PREPARE_FWD_STAGE] / stages[PREPARE_STAGE]}


def phase_model(floors: dict, n: int, d: int, shard_prepare: bool, cal=None) -> dict:
    """One card's seconds by phase for the peak band's step on ``d`` cards,
    from its ``floors`` (phase_floors), each times its factor in ``cal``
    (calibration; without it, at its floor) -> {"t": phase -> s of the
    replicated step, "ar": the gradient all-reduce, "ar_sh": its SH part,
    "zero": ZeRO's step, "prepare_vjp": the prepare's VJP, the window the
    SH all-reduce can hide in}."""
    scale = cal["scale"] if cal else {}
    fwd_share = cal["prepare_fwd_share"] if cal else floors["prepare_fwd_share"]
    t = {k: s * scale.get(k, 1.0) for k, s in floors["s"].items()}

    def prep(m):
        return prepare_s(m, cal["prepare_points"] if cal else None)

    gathers = 2 * allgather_s(n * PREP_FLOATS * 4, d) if d > 1 else 0.0
    if shard_prepare:
        t["prepare"] = prep(n / d)
        if d > 1:
            # the feature all-gather, and its backward: the reduce-scatter of
            # the 14 columns' cotangents (in the replicated and the ZeRO step)
            t["prep all-gather"] = t["feat grad-scatter"] = gathers / 2
    else:
        t["prepare"] = prep(n)
    ar = ring_allreduce_s(n * GRAD_FLOATS * 4, d)
    ar_sh = ring_allreduce_s(n * SH_FLOATS * 4, d)
    compute = sum(t.values())
    # ZeRO: the prepare over the tile shard's block, Adam over the chunk
    zero = (compute - t["adam"] * (1 - 1 / d) - t["prepare"] + prep(n / d)
            + (0.0 if shard_prepare else gathers))
    return {"t": t, "ar": ar, "ar_sh": ar_sh, "zero": zero,
            "prepare_vjp": t["prepare"] * (1 - fwd_share)}


def efficiency_rows(chips, per_d: dict) -> list:
    """The efficiency table: per_d[D] = {"compute", "ar_hidden",
    "ar_exposed", "zero"} seconds -> [(D, hidden s, eff, exposed s, eff,
    zero s, eff)], each against t1 = the first D's compute."""
    t1 = per_d[chips[0]]["compute"]
    out = []
    for d in chips:
        p = per_d[d]
        td = (p["compute"] + p["ar_hidden"], p["compute"] + p["ar_exposed"], p["zero"])
        out.append((d, td[0], t1 / (d * td[0]), td[1], t1 / (d * td[1]),
                    td[2], t1 / (d * td[2])))
    return out


def table_lines(rows) -> list:
    """efficiency_rows as the JAX tool prints its table (ms to 3 places)."""
    lines = [f"  {'D':>3} {'repl AR-hidden':>15} {'eff':>6} {'repl AR-exposed':>16} "
             f"{'eff':>6} {'zero (no AR)':>13} {'eff':>6}"]
    for d, th, eh, tx, ex, tz, ez in rows:
        lines.append(f"  {d:>3} {th * 1e3:>13.3f}ms {eh:>6.1%} {tx * 1e3:>14.3f}ms {ex:>6.1%} "
                     f"{tz * 1e3:>11.3f}ms {ez:>6.1%}")
    return lines


def model(scene, cam, cfg, chips, layout: str = "interleaved",
          shard_prepare: bool = True, measured=None) -> dict:
    """Every D of ``chips`` -> {D: {capacity, phases, compute, ar, ...}} and the
    efficiency rows (efficiency_rows), at calibrate_config_sharded's capacity
    (render.CAPACITY_BUCKET); with ``measured`` (roofline.measure_stages on
    the whole view, the prepare also at N / D) each phase priced from its
    measured stage (calibration), else at its floor and the prepare at
    PREPARE_FWD_VJP_MS."""
    R = importlib.import_module("splatapult_tpu_torch.render")
    bucket = R.CAPACITY_BUCKET
    caps = {d: band_capacity(scene, cam, cfg, d, layout, bucket) for d in sorted({1, *chips})}
    floors = {d: phase_floors(scene, cam, cap) for d, cap in caps.items()}
    cal = calibration(floors[1], measured) if measured else None
    n = scene.means.shape[0]
    per_d, out = {}, {}
    for d in chips:
        cap = caps[d]
        m = phase_model(floors[d], n, d, shard_prepare, cal)
        compute = sum(m["t"].values())
        # the SH all-reduce hidden behind the prepare's VJP (it starts when
        # the SH gradient is complete, before the projection's backward);
        # the terminal all-reduce of the rest after the backward
        hidden = m["ar"] - m["ar_sh"] + max(0.0, m["ar_sh"] - m["prepare_vjp"])
        per_d[d] = {"compute": compute, "ar_hidden": hidden if d > 1 else 0.0,
                    "ar_exposed": m["ar"] if d > 1 else 0.0, "zero": m["zero"]}
        out[d] = {**{k: cap[k] for k in ("bands", "peak", "total", "beta", "mult", "emax",
                                        "mcap")},
                  "phases_ms": {k: s * 1e3 for k, s in m["t"].items()},
                  "floors_ms": {k: s * 1e3 for k, s in floors[d]["s"].items()},
                  "compute_ms": compute * 1e3, "grad_allreduce_ms": m["ar"] * 1e3,
                  "sh_allreduce_ms": m["ar_sh"] * 1e3,
                  "prepare_vjp_ms": m["prepare_vjp"] * 1e3,
                  "exposed_if_unhidden_ms": per_d[d]["ar_hidden"] * 1e3,
                  "zero_ms": m["zero"] * 1e3}
    rows = efficiency_rows(chips, per_d)
    for d, th, eh, tx, ex, tz, ez in rows:
        out[d]["efficiency"] = {"repl_ar_hidden": eh, "repl_ar_exposed": ex, "zero": ez,
                                "repl_ar_hidden_ms": th * 1e3, "repl_ar_exposed_ms": tx * 1e3,
                                "zero_ms": tz * 1e3}
    return {"per_d": out, "rows": rows, "bucket": bucket,
            "pricing": "measured stages" if cal else "floors",
            "scale": cal["scale"] if cal else None,
            "prepare_points": cal["prepare_points"] if cal else PREPARE_FWD_VJP_MS}


def main(argv=None) -> int:
    from splatapult_tpu_torch._device import resolve_device
    from splatapult_tpu_torch.tools.scenes import (SCENES, bench_camera, make_bench_scene,
                                                   perturbed)

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=1_500_000)
    ap.add_argument("--scene", choices=SCENES, default="garden")
    ap.add_argument("--chips", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--band-layout", default="interleaved",
                    choices=("interleaved", "contiguous"))
    ap.add_argument("--no-shard-prepare", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    R = importlib.import_module("splatapult_tpu_torch.render")
    n, w, h, ts, b = args.splats, 1920, 1080, 32, 128
    scene = make_bench_scene(args.scene, n, seed=0, device=dev)
    cam = bench_camera(args.scene, w, h, device=dev)
    cfg = R.RenderConfig(width=w, height=h, pipeline="tiled", tile_size=ts, tile_block=b,
                         forward_only=False)
    shard_prepare = not args.no_shard_prepare
    meas = None
    if dev.type == "cuda":  # the step measured on this card prices the phases
        frame_cfg = R.calibrate_config(scene, cam, dataclasses.replace(cfg, forward_only=True))
        meas = RL.measure_stages(scene, perturbed(scene), cam, frame_cfg,
                                 prepare_splats=[n // d for d in args.chips])
        del meas["binning"]  # the view's kept tensors
    res = model(scene, cam, cfg, args.chips, args.band_layout, shard_prepare, meas)
    print(f"scene={args.scene} n={n} 1080p tile{ts} block{b} layout={args.band_layout} "
          f"shard_prepare={shard_prepare} bucket={res['bucket']} "
          f"NVLink={NVLINK_BYTES_PER_S / 1e9:.0f} GB/s (ASSUMED) prepare: {PREPARE_SOURCE}")
    if meas:
        print(f"pricing: each phase at its stage measured on this card x its floor at D / its "
              f"floor at D=1, the prepare at its time on N/D splats (measured step "
              f"{meas['stages_ms']['step']:.3f} ms)")
    else:
        print("pricing: FLOORS (no card to measure the step on): the floors' scaling, not a "
              "prediction of the step")
    for d in args.chips:
        r = res["per_d"][d]
        phase_str = "  ".join(f"{k}={v:.3f}" for k, v in r["phases_ms"].items())
        print(f"\nD={d}: peak_band={r['peak']} beta={r['beta']:.3f} emax={r['emax']} "
              f"mcap={r['mcap']} mult={r['mult']:.3f}")
        print(f"  {phase_str}  [ms]")
        print(f"  compute={r['compute_ms']:.3f} ms  repl-grad-AR={r['grad_allreduce_ms']:.3f} ms "
              f"(exposed-if-unhidden={r['exposed_if_unhidden_ms']:.3f}; zero path: 0)")
    print("\nefficiency vs D=1 (total work fixed at one view):")
    for line in table_lines(res["rows"]):
        print(line)
    print("\n('repl' = replicated scene: 'AR hidden' assumes the SH all-reduce, started "
          "inside the backward, hides behind the prepare's VJP and the terminal "
          "all-reduce is exposed; 'exposed' is the no-overlap worst case. 'zero' = "
          "parameter-sharded zero_fit_steps: no gradient all-reduce, Adam over N/D rows. "
          "Its parameter all-gather and reduce-scatter run over 'views', which has ONE rank "
          "on these 1 x D meshes, so they move nothing and the column needs no overlap "
          "assumption; on a V x T mesh with V > 1 each step adds N/T x 59 x 4 x (V-1)/V "
          "bytes gathered and as many reduce-scattered, issued before and after the "
          "compute and not priced here. Collectives at the ASSUMED NVLink bandwidth.)")
    out = {"tool": "scaling_model", "scene": args.scene, "splats": n, "width": w, "height": h,
           "layout": args.band_layout, "shard_prepare": shard_prepare, "bucket": res["bucket"],
           "device": str(dev), "nvlink_bytes_per_s_assumed": NVLINK_BYTES_PER_S,
           "prepare_source": PREPARE_SOURCE, "curves_card": RL.CURVES_CARD,
           "pricing": res["pricing"], "scale": res["scale"], "stages_ms": meas and meas["stages_ms"],
           "prepare_ms_by_splats": res["prepare_points"],
           "per_d": {str(d): r for d, r in res["per_d"].items()}}
    if dev.type == "cuda":
        from splatapult_tpu_torch.cli import gpu_name_and_power_limit

        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi_name_power_limit"] = gpu_name_and_power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
