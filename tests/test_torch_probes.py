"""The scatter and gather probes' plain versions (splatapult_tpu_torch/tools/
probe_scatter.py, P1-P3, and probe_dyngather.py, G1-G2) on the CPU, against
the JAX repo's tools/probe_scatter.py and tools/test_dyngather.py.

The JAX tools build their Pallas kernels inside main(), so each kernel body is
restated here as written there and run through pl.pallas_call(...,
interpret=True), as the JAX package's own tests run its kernels on the CPU:
kernel_a (tools/probe_scatter.py:66-74, its call :77-85), kernel_b (:107-115,
:118-126), kernel_c (:147-158, :161-169), kernel_lane
(tools/test_dyngather.py:24-25, :30-32) and kernel_sub (:42-43, :48-50). The
scatter probes run at a small size (B 256 rows a block, NB 4 blocks, CH 128,
W 8), the gathers at the JAX tool's shapes, which are small already. The
same seeded numpy inputs go to both sides; the port's plain versions, and the
wrappers on CPU tensors, must give the JAX kernels' arrays bit for bit, and
the JAX tool's own numpy ``want`` (probe_scatter.py:88-90, :129-133,
:172-176; np.take_along_axis for the gathers).

Also: the wrappers refuse a table that is not a permutation of its block and
an index out of range; the library calls the tools time as yardsticks give
the same arrays; each function's bytes; G1's route choice from the shape and
the refusal of a route or a G2 table the shape cannot take; the wrappers on
CPU tensors at odd shapes (the JAX kernels at two of them too); the bound
raised to the launch floor; the tools' flags, defaults and inputs
are the JAX tools' shapes and draws; and both tools exit 1 on a machine
without a CUDA device. The JAX programs are jitted once per module.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import pytest
import torch

from splatapult_tpu_torch.tools import probe_dyngather as PG, probe_scatter as PS

torch.set_num_threads(1)

B, W, NB, CH = 256, 8, 4, 128
NCH, N = B // CH, B * NB
SEED = 15


def _jax_scatter_probes():
    """tools/probe_scatter.py's three pallas_calls at (B, W, NB, CH), in
    interpret mode -> letter -> jitted (rows, table) -> out [N, W]."""

    def kernel_a(dest_ref, in_ref, out_ref):
        j = pl.program_id(0)

        def body(i, _):
            d = dest_ref[j, i]
            out_ref[pl.ds(d, 1), :] = in_ref[pl.ds(i, 1), :]
            return 0

        lax.fori_loop(0, B, body, 0)

    def kernel_b(cd_ref, in_ref, out_ref):
        j = pl.program_id(0)

        def body(c, _):
            start = cd_ref[j, c] * CH
            out_ref[pl.ds(start, CH), :] = in_ref[pl.ds(c * CH, CH), :]
            return 0

        lax.fori_loop(0, NCH, body, 0)

    def kernel_c(cd_ref, in_ref, out_ref):
        j = pl.program_id(0)
        out_ref[:, :] = jnp.zeros((B, W), jnp.float32)

        def body(c, _):
            start = cd_ref[j, c] * CH
            vals = in_ref[pl.ds(c * CH, CH), :]
            mask = lax.broadcasted_iota(jnp.int32, (CH, W), 0) < (CH // 2)
            pltpu.store(out_ref.at[pl.ds(start, CH), :], vals, mask=mask)
            return 0

        lax.fori_loop(0, NCH, body, 0)

    def call(kernel, table_cols):
        return jax.jit(lambda r, d: pl.pallas_call(
            kernel,
            grid=(NB,),
            in_specs=[pl.BlockSpec((NB, table_cols), lambda j: (0, 0)),
                      pl.BlockSpec((B, W), lambda j: (j, 0))],
            out_specs=pl.BlockSpec((B, W), lambda j: (j, 0)),
            out_shape=jax.ShapeDtypeStruct((N, W), jnp.float32),
            interpret=True,
        )(d, r))

    return {"A": call(kernel_a, B), "B": call(kernel_b, NCH), "C": call(kernel_c, NCH)}


def _jax_gather_probe(axis, shape):
    """tools/test_dyngather.py's kernel_lane (axis 1) or kernel_sub (axis 0),
    in interpret mode -> (x, idx) -> out."""

    def kernel(tab_ref, idx_ref, out_ref):
        out_ref[:, :] = jnp.take_along_axis(tab_ref[:, :], idx_ref[:, :], axis=axis)

    return lambda x, idx: pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32), interpret=True)(x, idx)


def _tool_wants(rows, perm, cperm):
    """The JAX tool's numpy wants, as written there (probe_scatter.py:88-90,
    :129-133, :172-176)."""
    want_a = np.zeros((N, W), np.float32)
    for j in range(NB):
        want_a[j * B + perm[j]] = rows[j * B:(j + 1) * B]
    want_b = np.zeros((N, W), np.float32)
    want_c = np.zeros((N, W), np.float32)
    for j in range(NB):
        for c in range(NCH):
            at = j * B + cperm[j][c] * CH
            want_b[at:at + CH] = rows[j * B + c * CH:j * B + (c + 1) * CH]
            want_c[at:at + CH // 2] = rows[j * B + c * CH:j * B + c * CH + CH // 2]
    return {"A": want_a, "B": want_b, "C": want_c}


# the odd shapes chip_smoke.py holds G1's every route and G2 at on the card:
# (axis, x's shape, idx's shape); G1 idx [R, M], G2 idx [M, L]
ODD_GATHERS = {"G1 [3, 37] by [3, 53]": (1, (3, 37), (3, 53)),
               "G1 [3, 36] by [3, 52]": (1, (3, 36), (3, 52)),
               "G1 [5, 2000] by [5, 9000]": (1, (5, 2000), (5, 9000)),
               "G2 [5, 33] by [7, 33]": (0, (5, 33), (7, 33)),
               "G2 [5, 36] by [7, 36]": (0, (5, 36), (7, 36)),
               "G2 [5, 33] by [300, 33]": (0, (5, 33), (300, 33))}
ODD_JAX = ("G1 [3, 37] by [3, 53]", "G2 [5, 33] by [7, 33]")


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(SEED)
    rows = rng.standard_normal((N, W)).astype(np.float32)
    perm = np.stack([rng.permutation(B) for _ in range(NB)]).astype(np.int32)
    cperm = np.stack([rng.permutation(NCH) for _ in range(NB)]).astype(np.int32)
    g = PG.make_inputs(seed=SEED)
    probes = _jax_scatter_probes()
    tables = {"A": perm, "B": cperm, "C": cperm}
    jax_out = {k: np.asarray(f(rows, tables[k])) for k, f in probes.items()}
    jax_out["lane"] = np.asarray(_jax_gather_probe(1, g["lane_x"].shape)(g["lane_x"],
                                                                         g["lane_idx"]))
    jax_out["sub"] = np.asarray(_jax_gather_probe(0, g["sub_x"].shape)(g["sub_x"],
                                                                       g["sub_idx"]))
    odd = {}
    for case, (axis, x_shape, idx_shape) in ODD_GATHERS.items():
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, x_shape, dtype=np.int64).astype(np.int32)
        idx = rng.integers(0, x_shape[axis], idx_shape).astype(np.int32)
        odd[case] = (axis, x, idx)
        if case in ODD_JAX:
            jax_out[case] = np.asarray(_jax_gather_probe(axis, idx_shape)(x, idx))
    return {"rows": rows, "perm": perm, "cperm": cperm, "tables": tables, "gather": g,
            "odd": odd, "jax": jax_out, "want": _tool_wants(rows, perm, cperm)}


SCATTER = {"A": (PS.scatter_rows, PS.scatter_rows_plain),
           "B": (PS.scatter_chunks, PS.scatter_chunks_plain),
           "C": (PS.scatter_half_chunks, PS.scatter_half_chunks_plain)}


@pytest.mark.parametrize("letter", ["A", "B", "C"])
def test_scatter_plain_matches_the_jax_probe(ref, letter):
    """P1-P3: the plain version and the wrapper on CPU tensors give the JAX
    probe's array and the tool's want bit for bit."""
    wrapper, plain = SCATTER[letter]
    rows, table = torch.from_numpy(ref["rows"]), torch.from_numpy(ref["tables"][letter])
    got = plain(rows, table).numpy()
    assert np.array_equal(ref["jax"][letter], ref["want"][letter])
    assert np.array_equal(got, ref["jax"][letter])
    assert np.array_equal(wrapper(rows, table).numpy(), got)


@pytest.mark.parametrize("probe", ["lane", "sub"])
def test_gather_plain_matches_the_jax_probe(ref, probe):
    """G1-G2: the plain version and the wrapper on CPU tensors give the JAX
    probe's array and np.take_along_axis exactly."""
    g = ref["gather"]
    x, idx = g[f"{probe}_x"], g[f"{probe}_idx"]
    wrapper, plain = {"lane": (PG.gather_lane, PG.gather_lane_plain),
                      "sub": (PG.gather_sub, PG.gather_sub_plain)}[probe]
    want = np.take_along_axis(x, idx, axis={"lane": 1, "sub": 0}[probe])
    got = plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(ref["jax"][probe], want)
    assert np.array_equal(got, want)
    assert np.array_equal(wrapper(torch.from_numpy(x), torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("case", list(ODD_GATHERS))
def test_gather_at_odd_shapes(ref, case):
    """The wrappers on CPU tensors (the plain version) give np.take_along_axis
    at idx shapes unlike x's and widths that are not multiples of 4 or 32;
    the JAX kernels agree at two of these shapes."""
    axis, x, idx = ref["odd"][case]
    want = np.take_along_axis(x, idx, axis=axis)
    if case in ODD_JAX:
        assert np.array_equal(ref["jax"][case], want)
    wrapper = PG.gather_lane if axis == 1 else PG.gather_sub
    assert np.array_equal(wrapper(torch.from_numpy(x), torch.from_numpy(idx)).numpy(), want)


_AT = PG.LANE_DIRECT_MAX_BYTES // (4 * PG.L)  # G1's rows of 640 at its threshold


@pytest.mark.parametrize("shape, want", [
    ((PG.R, PG.L), "direct"),                          # the JAX tool's table
    ((65536, PG.L), "staged"),                         # where bytes dominate
    ((_AT, PG.L), "direct"),                           # x at the threshold
    ((_AT + 1, PG.L), "staged"),
    ((4096, PG.LANE_STAGE_MAX_COLS), "staged"),        # the widest row it stages
    ((4096, PG.LANE_STAGE_MAX_COLS + 1), "direct"),
])
def test_gather_lane_route_choice(shape, want):
    """G1's route from x's shape: direct up to LANE_DIRECT_MAX_BYTES and for
    rows too wide to stage, staged above; each route it can take is
    returned as asked."""
    assert PG.pick_route(*shape) == want
    routes = PG.lane_routes(torch.empty(shape, device="meta"))
    assert routes[0] == want and "direct" in routes
    for route in routes:
        assert PG.pick_route(*shape, route=route) == route


def test_gather_refuses_a_route_its_shape_cannot_take():
    """G1's staged route stages a row (at most 58112 columns), G2 a
    32-column strip (at most 1816 rows), in 227 KB of shared memory; G1's
    direct route takes any shape. A route outside LANE_ROUTES is refused."""
    assert (PG.LANE_STAGE_MAX_COLS, PG.SUB_MAX_ROWS) == (232448 // 4, 232448 // 128)
    with pytest.raises(ValueError, match="at most 58112 columns"):
        PG.pick_route(2, 58113, route="staged")
    with pytest.raises(ValueError, match="none of"):
        PG.pick_route(8, 640, route="tiled")
    assert PG.lane_routes(torch.empty(8, 58113, device="meta")) == ("direct",)
    x = torch.zeros((2, PG.LANE_STAGE_MAX_COLS + 1), dtype=torch.int32)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 58112 columns"):
        PG.gather_lane(x, idx, route="staged")
    assert torch.equal(PG.gather_lane(x, idx, route="direct"), idx)
    x = torch.zeros((PG.SUB_MAX_ROWS + 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 1816 rows"):
        PG.gather_sub(x, idx)
    assert torch.equal(PG.gather_sub(x[:-1], idx), idx)


def test_bound_is_raised_to_the_launch_floor():
    """bound_ms is the larger of the bytes' time at 3.35 TB/s and the launch
    floor (bound_by "bytes" or "launch"); the floor is the lesser of its two
    calls' times, a 4-byte copy and an empty kernel."""
    small, large = PS.bound_with_floor(61440, 0.005), PS.bound_with_floor(503316480, 0.005)
    assert small == {"bound_ms": 0.005, "bound_by": "launch",
                     "bytes_bound_ms": pytest.approx(61440 / 3.35e12 * 1e3)}
    assert large["bound_by"] == "bytes" and large["bound_ms"] == large["bytes_bound_ms"]
    assert abs(large["bound_ms"] - 0.15024) < 1e-4
    calls = PS.launch_floor_calls("cpu")
    assert set(calls) == {"copy_", "empty_kernel"}
    assert calls["copy_"]().numel() == 1 and calls["copy_"]().dtype == torch.int32
    ms = {"A": 0.006, "launch_floor/copy_": 0.0052, "launch_floor/empty_kernel": 0.0031}
    assert PS.launch_floor(ms) == {"launch_floor_ms": 0.0031, "launch_floor_calls_ms": {
        "copy_": 0.0052, "empty_kernel": 0.0031}}


def test_library_calls_give_the_same_arrays(ref):
    """The yardsticks the tools time (index_copy_, zeros + index_copy_,
    torch.gather) compute the probes' functions."""
    rows, perm, cperm = (torch.from_numpy(ref[k]) for k in ("rows", "perm", "cperm"))
    for letter, (name, call) in PS.library_calls(rows, perm, cperm).items():
        assert np.array_equal(call().numpy(), ref["want"][letter]), name
    g = PS.on_device(ref["gather"], "cpu")
    assert np.array_equal(torch.gather(g["lane_x"], 1, g["lane_idx"].long()).numpy(),
                          ref["jax"]["lane"])
    assert np.array_equal(torch.gather(g["sub_x"], 0, g["sub_idx"].long()).numpy(),
                          ref["jax"]["sub"])


def _changed(a, at, value):
    a = a.copy()
    a[at] = value
    return torch.from_numpy(a)


@pytest.mark.parametrize("case", ["duplicate", "outside_block", "negative"])
@pytest.mark.parametrize("letter", ["A", "B", "C"])
def test_scatter_refuses_a_table_that_is_not_a_block_permutation(ref, letter, case):
    wrapper, _ = SCATTER[letter]
    table = ref["tables"][letter]
    width = table.shape[1]
    value = {"duplicate": int(table[1, 1]), "outside_block": width, "negative": -1}[case]
    with pytest.raises(ValueError, match="not a permutation"):
        wrapper(torch.from_numpy(ref["rows"]), _changed(table, (1, 0), value))


@pytest.mark.parametrize("probe", ["lane", "sub"])
def test_gather_refuses_an_index_out_of_range(ref, probe):
    g = ref["gather"]
    x, idx = torch.from_numpy(g[f"{probe}_x"]), g[f"{probe}_idx"]
    wrapper = {"lane": PG.gather_lane, "sub": PG.gather_sub}[probe]
    bound = x.shape[1] if probe == "lane" else x.shape[0]
    for value in (-1, bound):
        with pytest.raises(ValueError, match="outside"):
            wrapper(x, _changed(idx, (3, 5), value))


def test_wrappers_refuse_wrong_types_and_shapes(ref):
    rows, perm = torch.from_numpy(ref["rows"]), torch.from_numpy(ref["perm"])
    with pytest.raises(ValueError):
        PS.scatter_rows(rows.double(), perm)
    with pytest.raises(ValueError):
        PS.scatter_rows(rows[:-1], perm)
    with pytest.raises(ValueError):
        PS.scatter_rows(rows, perm.long())
    with pytest.raises(ValueError):  # a block of CH - 1 rows fewer than its table names
        PS.scatter_half_chunks(rows[:-(CH - 1)], torch.from_numpy(ref["cperm"]))
    g = PS.on_device(ref["gather"], "cpu")
    with pytest.raises(ValueError):
        PG.gather_lane(g["lane_x"], g["lane_idx"].long())
    with pytest.raises(ValueError):
        PG.gather_sub(g["sub_x"], g["sub_idx"][:, :-1])


def test_bytes_of_each_function():
    """Each input read once, each output written once: at the large shape the
    bounds are about 85, 80 and 60 us (P1-P3) and 150 us (G1, G2)."""
    rows = torch.empty((4096 * PS.B, PS.W))
    cdest = torch.empty((4096, PS.B // PS.CH), dtype=torch.int32)
    us = {k: PS.scatter_bytes(k, rows, cdest) / 3.35e12 * 1e6 for k in "ABC"}
    assert 84 < us["A"] < 86 and 79 < us["B"] < 81 and 59 < us["C"] < 61
    assert PS.scatter_bytes("A", rows, cdest) == 2 * rows.numel() * 4 + rows.shape[0] * 4


def test_probe_scatter_defaults_and_inputs_are_the_jax_tools():
    """tools/probe_scatter.py:49-52 (B 1024, W 8, NB 64), :101 (CH 128), :186
    (4M baseline rows), :31 (30 repeats); its draws in its order from
    default_rng(0) (:55-62, :103, :187-188)."""
    assert (PS.B, PS.W, PS.NB, PS.CH, PS.BASELINE_ROWS, PS.ITERS) == (
        1024, 8, 64, 128, 4 << 20, 30)
    args = PS.parse_args([])
    assert (args.blocks, args.out) == (64, None)
    assert PS.parse_args(["--blocks", "4096"]).blocks == 4096
    inp = PS.make_inputs(blocks=2, seed=0, baselines=False)
    rng = np.random.default_rng(0)
    rows = np.asarray(jnp.asarray(rng.standard_normal((2 * 1024, 8)), jnp.float32))
    perm = np.stack([rng.permutation(1024) for _ in range(2)]).astype(np.int32)
    cperm = np.stack([rng.permutation(8) for _ in range(2)]).astype(np.int32)
    assert np.array_equal(inp["rows"], rows) and inp["rows"].dtype == np.float32
    assert np.array_equal(inp["dest"], perm) and np.array_equal(inp["cdest"], cperm)
    assert set(inp) == {"rows", "dest", "cdest"}


def test_probe_dyngather_defaults_and_inputs_are_the_jax_tools():
    """tools/test_dyngather.py:22 ([8, 640]), :40 ([640, 512]), the tables of
    :27 and :45, indices in the ranges of :28 and :46."""
    assert (PG.R, PG.L, PG.R2, PG.L2) == (8, 640, 640, 512)
    args = PG.parse_args([])
    assert (args.lane_rows, args.sub_cols, args.out) == (8, 512, None)
    assert PG.parse_args(["--lane-rows", "65536", "--sub-cols", "65536"]).sub_cols == 65536
    inp = PG.make_inputs()
    assert np.array_equal(inp["lane_x"], np.arange(8 * 640).reshape(8, 640))
    assert np.array_equal(inp["sub_x"], np.arange(640 * 512).reshape(640, 512) % 7919)
    for k, hi in (("lane_idx", 640), ("sub_idx", 640)):
        assert inp[k].dtype == np.int32 and inp[k].min() >= 0 and inp[k].max() < hi
    big = PG.make_inputs(lane_rows=16, sub_cols=1024)
    assert big["lane_x"].shape == big["lane_idx"].shape == (16, 640)
    assert big["sub_x"].shape == big["sub_idx"].shape == (640, 1024)


@pytest.mark.parametrize("tool", ["probe_scatter", "probe_dyngather"])
def test_tool_exits_1_without_a_cuda_device(tool, capsys, monkeypatch):
    mod = {"probe_scatter": PS, "probe_dyngather": PG}[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 1
    out, err = capsys.readouterr()
    assert out == "" and f"{tool}: no CUDA device" in err
