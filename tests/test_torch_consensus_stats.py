"""The consensus-statistics kernel's host side on the CPU: the table that
``kernels/consensus_stats/kernel.py`` builds for the CUDA kernel, read back
by an interpreter of the table that follows ``csrc/consensus_stats.cu``'s
arithmetic, the ``meta`` route that a dry run takes, the train step's
statistics counters, and the CPU route through the plain version. The
kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import _tree, telemetry
from repro_torch.core import bus
from repro_torch.core import decentralized as Dc
from repro_torch.kernels import consensus_stats as CS
from repro_torch.kernels.consensus_stats import kernel as K
from repro_torch.launch import cost
from repro_torch.launch.tensor_parallel import ModelCut

BF16, F32 = torch.bfloat16, torch.float32
SHAPES = {"a": (37,), "b": (5, 13), "c": (129, 64), "d": (1,), "e": (3, 101)}


def _tree_of(M, dtype, seed, device="cpu"):
    """Seeded leaves of SHAPES at widening scales, and one laid out as the
    tied embedding's gradient comes out of vmap: each worker's copy
    transposed."""
    g = torch.Generator().manual_seed(seed)
    tree = {k: (torch.randn((M,) + s, generator=g) * 2.0 ** (i - 2)).to(device=device,
                                                                        dtype=dtype)
            for i, (k, s) in enumerate(SHAPES.items())}
    tree["t"] = torch.randn((M, 13, 9), generator=g).to(device=device,
                                                        dtype=dtype).transpose(1, 2)
    return tree


def _bus_views(tree):
    layout = bus.plan_layout(tree)
    return _tree.leaves(bus.unpack(bus.pack(tree, layout), layout)), layout


# ---------------------------------------------------------------------------
# An interpreter of the table, as the kernel reads it
# ---------------------------------------------------------------------------


def _read(ptr: int, count: int, dtype) -> np.ndarray:
    """``count`` elements of ``dtype`` at host address ``ptr``, as float32."""
    if dtype == F32:
        return np.frombuffer((ctypes.c_float * count).from_address(ptr), np.float32).copy()
    raw = np.frombuffer((ctypes.c_uint16 * count).from_address(ptr), np.uint16)
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _round(x: np.ndarray, dtype) -> np.ndarray:
    return torch.from_numpy(x).to(dtype).float().numpy()


def _interpret(rows: np.ndarray, dtype, workers: int, M: int) -> np.ndarray:
    """The (4, 2) sums the kernel's HELD and SUMS forms compute from
    ``rows``: x̄ the float32 worker-order sum (or the row's sums) ÷ M,
    rounded to ``dtype``; deviations rounded to ``dtype``; float64 totals."""
    esize = torch.empty((), dtype=dtype).element_size()
    out = np.zeros(8)
    for ptr, ws, count, units, _rot, sums, flags, _first, n_rows, rstride in rows.tolist():
        vec = 16 // esize if flags & K._VECTOR else 1
        assert units * vec == count * n_rows
        if vec > 1:
            assert ptr % 16 == 0 and (workers == 1 or ws * esize % 16 == 0)
            assert n_rows == 1 or rstride * esize % 16 == 0
        at = [r * rstride for r in range(n_rows)]
        x = np.stack([np.concatenate([_read(ptr + (j * ws + a) * esize, count, dtype)
                                      for a in at]) for j in range(workers)])
        count *= n_rows
        if sums:
            s = np.concatenate([_read(sums + 4 * a, count // n_rows, F32) for a in at])
        else:
            s = np.zeros(count, np.float32)
            for j in range(workers):
                s = s + x[j]
        mean = _round((s / np.float32(M)).astype(np.float32), dtype)
        d = _round((x - mean).astype(np.float32), dtype)
        col = 0 if flags & K._SHARDED else 1
        if flags & K._PARAM:
            out[6 + col] += float(np.sum(d.astype(np.float64) ** 2))
        else:
            out[col] += float(np.sum(x.astype(np.float64) ** 2))
            out[2 + col] += float(np.sum(d.astype(np.float64) ** 2))
            out[4 + col] += float(np.sum(mean.astype(np.float64) ** 2))
    return out.reshape(4, 2).astype(np.float32)


def _rows(grads, params, flags, sums=None):
    """The table rows ``kernel._runs`` and ``kernel._pieces`` give CPU
    leaves (the card's plan routes CPU leaves to the plain version, so the
    rows are built here)."""
    rows = []
    for kind, xs in (("grad", grads), ("param", params)):
        for i, x in enumerate(xs):
            s = sums[kind][i] if sums else None
            flag = (K._PARAM if kind == "param" else 0) | (K._SHARDED if flags[i] else 0)
            run, n_rows, rstride, offsets = K._runs(x.shape[1:], x.stride()[1:])
            for o in offsets:
                rows += K._pieces(x.data_ptr() + o * x.element_size(), x.stride(0), run,
                                  x.element_size(), x.shape[0],
                                  0 if s is None else s.data_ptr() + 4 * o, flag, n_rows,
                                  rstride)
    return np.asarray(rows, np.int64)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M", [2, 4, 5])
def test_table_read_as_the_kernel_reads_it_equals_the_plain_version(dtype, M):
    """Fresh gradients, params as the bus's strided views, half the leaves
    sharded: the interpreter of the table gives the plain version's sums."""
    grads = _tree.leaves(_tree_of(M, dtype, 0))
    assert not grads[-1][0].is_contiguous()
    params, _ = _bus_views(_tree_of(M, dtype, 1))
    flags = [i % 2 == 0 for i in range(len(grads))]
    got = _interpret(_rows(grads, params, flags), dtype, M, M)
    want = CS.consensus_stats_reference(grads, params, M, grad_sharded=flags,
                                        param_sharded=flags)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_table_with_column_sums_equals_the_plain_version(dtype):
    """The worker mesh's form: 2 of M = 6 workers, x̄ from the given sums."""
    M, workers = 6, 2
    grads = _tree.leaves(_tree_of(workers, dtype, 2))
    params, _ = _bus_views(_tree_of(workers, dtype, 3))
    sums = {k: [s.mul_(3) for s in CS.column_sums(t)[1]] for k, t in
            (("grad", grads), ("param", params))}
    assert not sums["grad"][-1].is_contiguous()      # the transposed leaf's order
    flags = [False] * len(grads)
    got = _interpret(_rows(grads, params, flags, sums), dtype, workers, M)
    want = CS.consensus_stats_reference(grads, params, M, grad_sums=sums["grad"],
                                        param_sums=sums["param"])
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("form", ["held", "sums"])
def test_table_of_leaves_with_gaps_equals_the_plain_version(dtype, form):
    """Worker copies with gaps, as a model axis's shard of a wider dim
    leaves them: half of each row, rows of a padded block, a copy whose
    outer dims do not line up, every other element."""
    M, workers = (4, 4) if form == "held" else (8, 4)
    g = torch.Generator().manual_seed(5)
    full = lambda *s: torch.randn((workers,) + s, generator=g).to(dtype)
    grads = [full(4, 160)[..., :80], full(3, 40)[:, 1:, 8:32], full(2, 5, 96)[:, :, 1:4, :64],
             full(50)[:, ::2]]
    params = [full(4, 160)[..., 80:], full(6, 24)[:, :, :16]]
    sums = None
    kw = {}
    if form == "sums":
        sums = {k: [v.mul_(M // workers) for v in CS.column_sums(t)[1]]
                for k, t in (("grad", grads), ("param", params))}
        kw = dict(grad_sums=sums["grad"], param_sums=sums["param"])
    got = _interpret(_rows(grads, params, [False] * len(grads), sums), dtype, workers, M)
    want = CS.consensus_stats_reference(grads, params, M, **kw)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_pieces_cut_a_leaf_into_head_tiles_and_tail():
    # bf16: 8 a tile; a leaf of 37 at byte 6 has a head of 5, 4 tiles, a tail of 0
    assert K._pieces(6, 640, 37, 2, 4, 0, K._PARAM) == [
        [6, 640, 5, 5, 0, 0, K._PARAM, 0, 1, 0],
        [16, 640, 32, 4, 0, 0, K._PARAM | K._VECTOR, 0, 1, 0]]
    # with its column sums: they move with the pieces
    assert [r[5] for r in K._pieces(0, 640, 37, 2, 4, 4096, 0)] == [4096, 4096 + 4 * 32]
    # a worker stride off the 16-byte grid: element by element
    assert K._pieces(0, 37, 37, 2, 4, 0, 0) == [[0, 37, 37, 37, 0, 0, 0, 0, 1, 0]]
    # float32, one worker (the allreduce mode's energy): 4 a tile
    assert K._pieces(0, 9, 9, 4, 1, 0, K._SHARDED) == [
        [0, 9, 8, 2, 0, 0, K._SHARDED | K._VECTOR, 0, 1, 0],
        [32, 9, 1, 1, 0, 0, K._SHARDED, 0, 1, 0]]
    # 4 runs of 80 bf16, 160 apart (half of a wider dim): each piece spans the rows
    assert K._pieces(0, 640, 80, 2, 2, 0, 0, 4, 160) == [
        [0, 640, 80, 40, 0, 0, K._VECTOR, 0, 4, 160]]
    # runs off the 16-byte grid: element by element
    assert K._pieces(0, 640, 80, 2, 2, 0, 0, 4, 161) == [[0, 640, 80, 320, 0, 0, 0, 0, 4, 161]]


def test_runs_of_a_worker_copy():
    """A copy that fills its block is one run; a shard of a wider dim is
    rows of runs; dims that do not line up give several rows' offsets."""
    assert K._runs((13, 9), (1, 13)) == (117, 1, 0, [0])            # transposed
    assert K._runs((4, 80), (160, 1)) == (80, 4, 160, [0])           # half of 160 wide
    assert K._runs((2, 4, 80), (1000, 160, 1)) == (80, 4, 160, [0, 1000])
    assert K._runs((5,), (2,)) == (1, 5, 2, [0])                    # every other element


# ---------------------------------------------------------------------------
# The plan on meta tensors: the card's route as far as the launch
# ---------------------------------------------------------------------------


def test_plan_of_a_bus_unpacked_tree_and_a_cut():
    M = 4
    grads = _tree.leaves(_tree_of(M, BF16, 0, "meta"))
    params, layout = _bus_views(_tree_of(M, BF16, 0, "meta"))
    cut = ModelCut(group=None, k=2, index=0, dims=((), (-1,), (-2,), (), (-1,), (-2,)))
    p = CS.plan(grads, params, M, grad_sharded=cut.sharded, param_sharded=cut.sharded)
    assert p.form == K.HELD and p.plain_leaves == 0 and len(p.groups) == 1
    (g,) = p.groups
    rows = g.rows
    stride = layout.groups[0].rows * layout.groups[0].cols
    params_rows = rows[rows[:, 6] & K._PARAM != 0]
    assert set(params_rows[:, 1].tolist()) == {stride}
    assert set(rows[rows[:, 6] & K._PARAM == 0][:, 1].tolist()) == {
        x.stride(0) for x in grads}
    # every leaf's pieces cover its elements in order, tiles aligned
    by_slot = {s.leaf_id: s for s in layout.groups[0].slots}
    at = 0
    for kind, xs in (("grad", grads), ("param", params)):
        for i, x in enumerate(xs):
            n, start = x[0].numel(), x.data_ptr()
            if kind == "param":
                assert start == 2 * by_slot[i].offset
            covered = 0
            while covered < n:
                r = rows[at]
                assert r[0] == start + 2 * covered
                assert bool(r[6] & K._SHARDED) == cut.sharded[i]
                assert bool(r[6] & K._PARAM) == (kind == "param")
                if r[6] & K._VECTOR:
                    assert r[0] % 16 == 0 and r[3] * 8 == r[2]
                else:
                    assert r[3] == r[2]
                covered += r[2]
                at += 1
            assert covered == n
    assert at == len(rows)
    assert rows[:, 7].tolist() == (np.cumsum(rows[:, 3]) - rows[:, 3]).tolist()
    n_all = sum(x.numel() for x in grads) + sum(x.numel() for x in params)
    assert g.units == int(rows[:, 3].sum()) and p.nbytes == 2 * n_all
    assert p.reread_columns == 0


def test_meta_route_reports_its_work_and_launches_nothing():
    M = 16    # above the 8 workers held in registers: every tile read twice
    grads = _tree.leaves(_tree_of(M, BF16, 0, "meta"))
    params, _ = _bus_views(_tree_of(M, BF16, 0, "meta"))
    p = CS.plan(grads, params, M)
    before = CS.consensus_stats.launches
    out, c = cost.measure(CS.consensus_stats, p)
    assert CS.consensus_stats.launches == before
    assert out.shape == (4, 2) and out.dtype == F32 and out.device.type == "meta"
    n = sum(x[0].numel() for x in grads)
    ops = n * (M * 6 + 3) + n * (M * 4 + 1)
    assert [(e.name, e.ops, e.nbytes, e.products) for e in c.kernels] == [
        ("consensus_stats", ops, 2 * 2 * M * n * 2, False)]
    assert p.reread_columns == p.groups[0].units > 0
    # the four statistics, as step_metrics sums them
    four = Dc._model_sum(out, None)
    assert four.shape == (4,) and four.dtype == F32


def test_energy_form_and_a_leaf_the_kernel_cannot_read():
    """The allreduce mode's energy is the held form over one worker; a
    slice with gaps is read as rows of runs; a leaf of a dtype the kernel
    cannot read is refused, not summed another way."""
    x = torch.empty(10, 7, dtype=BF16, device="meta")
    p = CS.plan([x[None], x.t()[None]], [], 1)
    assert p.form == K.HELD and p.plain_leaves == 0 and p.plain is None
    assert p.nbytes == 2 * 2 * 70 and p.reread_columns == 0
    p = CS.plan([x[None], x[:, :3][None]], [], 1)             # the slice leaves gaps
    assert p.nbytes == 2 * (70 + 30) and p.groups[0].rows[-1, 8:].tolist() == [10, 7]
    with pytest.raises(ValueError, match="float64"):
        CS.plan([x[None].double()], [], 1)
    with pytest.raises(ValueError, match="column sums"):
        CS.plan([x[None]], [x[None]], 1, grad_sums=[torch.empty(7, device="meta")])
    with pytest.raises(ValueError, match="M = 3"):
        CS.plan([x[None]], [], 3)


def test_stats_counters_and_span_on_the_card_route():
    M = 4
    grads = _tree.leaves(_tree_of(M, BF16, 0, "meta"))
    params, _ = _bus_views(_tree_of(M, BF16, 0, "meta"))
    with telemetry.run() as tel:
        out = Dc._stats(grads, params, M)
    assert out.shape == (4, 2)
    n = sum(x.numel() * x.element_size() for x in grads + params)
    assert {k: v for k, v in tel.counters.items() if k.startswith("stats.")} == {
        "stats.bytes_kernel": n, "stats.plain_leaves": 0, "stats.reread_columns": 0}
    assert [s["name"] for s in tel.spans] == ["stats.kernel"]


# ---------------------------------------------------------------------------
# The CPU route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cpu_leaves_take_the_plain_version(dtype):
    M = 4
    grads = _tree.leaves(_tree_of(M, dtype, 0))
    params, _ = _bus_views(_tree_of(M, dtype, 1))
    p = CS.plan(grads, params, M)
    assert p.groups == () and p.plain_leaves == len(grads) + len(params)
    before = CS.consensus_stats.launches
    got = CS.consensus_stats(p)
    assert CS.consensus_stats.launches == before
    assert torch.equal(got, CS.consensus_stats_reference(grads, params, M))
    with telemetry.run() as tel:
        Dc._stats(grads, params, M)
    assert tel.spans == [] and tel.counters == {
        "stats.bytes_kernel": 0, "stats.plain_leaves": len(grads) + len(params),
        "stats.reread_columns": 0}


def test_the_launch_is_an_operator_of_the_dispatcher():
    """So that a profiler links the kernel to the ranges around its call."""
    op = torch.ops.repro_torch.consensus_stats.default
    mutated = [a.name for a in op._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write]
    assert mutated == ["out"]
