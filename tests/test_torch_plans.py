"""The launch plans of ``axpy`` and the one-row ``mx_qgemv`` walk, as plain
Python: what each block and lane of the CUDA kernels covers.

``axpy_plan`` takes n elements on the vector path (a 16-byte vector a
thread) up to four waves of the card, and past that cuts them into tiles of
16-byte vectors walked as contiguous parts through shared memory, plus a
tail of fewer than a tile; ``qgemv_plan`` cuts (N, K) MX codes into column
tiles, one block a tile, rounds down K and lane runs inside E8M0 blocks.  Each is held here to cover
every element (every column and code row) exactly once, to keep its ragged
tails right, and to fill a card of 132 SMs at the projection shapes.  The
kernels themselves are held against their plain versions on the card
(``test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.troop import LaunchConfig  # noqa: E402
from repro_torch.kernels.axpy import (BARRIER_BYTES,  # noqa: E402
                                      SM_THREADS, SMEM_LIMIT, THREADS,
                                      VECTOR_WAVES, axpy_plan, stream_plan, vector_plan)
from repro_torch.kernels.mx_gemv import QgemvPlan, qgemv_plan  # noqa: E402
from repro_torch.tune import REGISTRY  # noqa: E402
from repro_torch.tune.search import enumerate_space  # noqa: E402

SMS = 132
# the registry's space, plus unroll 4 (LaunchConfig takes it)
AXPY_SPACE = [LaunchConfig(streams=s, unroll=u, block_k=b)
              for s in (1, 2) for u in (1, 2, 4) for b in (256, 512, 1024)]


def axpy_counts(plan):
    """How often the plan's walk touches each 16-byte vector: the tiles of
    every block's steps in every part, then the tail."""
    count = np.zeros(plan.nv, np.int64)
    steps = np.zeros(plan.per, np.int64)
    for b in range(plan.blocks):
        for i in range(b * plan.spb, min((b + 1) * plan.spb, plan.per)):
            steps[i] += 1
            for first, end in plan.parts():
                if first + i < end:
                    t = first + i
                    count[t * plan.tile_v:(t + 1) * plan.tile_v] += 1
    assert (steps == 1).all()               # every step by one block
    count[plan.tiles * plan.tile_v:] += 1
    return count


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cfg", AXPY_SPACE,
                         ids=lambda c: f"s{c.streams}u{c.unroll}k{c.block_k}")
@pytest.mark.parametrize("n_tiles,extra", [(0, 8), (1, 8), (1, 0), (7, 24),
                                           (64, 0), (301, 16)])
def test_axpy_plan_covers_every_element_once(itemsize, cfg, n_tiles, extra):
    """The stream over n = n_tiles whole tiles + ``extra`` elements: 8
    elements alone, one tile + 8, one tile, an odd count of tiles (the
    second part one short) and enough tiles for many blocks of every step
    count."""
    vec = 16 // itemsize
    n = n_tiles * cfg.block_k * vec + extra
    plan = stream_plan(n, itemsize, cfg)
    assert plan.vec == vec and plan.nv == n // vec
    assert plan.tiles == n_tiles and plan.tile_v == cfg.block_k
    assert plan.tail == extra // vec and plan.tail < plan.tile_v
    assert plan.per == -(-n_tiles // cfg.streams)
    assert [end - first for first, end in plan.parts()][:-1] == \
        [plan.per] * (cfg.streams - 1)
    assert 1 <= plan.spb <= cfg.unroll
    assert plan.blocks == max(1, -(-plan.per // plan.spb))
    assert (axpy_counts(plan) == 1).all()


@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("streams,block_k", [(1, 256), (1, 512), (1, 1024),
                                             (1, 2048), (2, 256), (2, 512),
                                             (2, 1024)])
def test_axpy_steps_fit_shared_memory(streams, unroll, block_k):
    """A slot for each tile of each of a block's steps, all in 227 KB with
    the barriers: every step of ``unroll`` where they fit, else as many as
    fit (two parts of 16 KB tiles, or one of 32 KB, at 4 steps: 3); the
    same bytes for both types."""
    cfg = LaunchConfig(streams=streams, unroll=unroll, block_k=block_k)
    plans = [stream_plan(block_k * 8, itemsize, cfg) for itemsize in (2, 4)]
    spb = plans[0].spb
    assert all(p.spb == spb and p.smem == plans[0].smem for p in plans)
    slot = streams * 2 * block_k * 16
    assert 1 <= spb <= unroll and streams * spb <= 16
    assert plans[0].smem == BARRIER_BYTES + spb * slot <= SMEM_LIMIT
    assert spb == unroll or BARRIER_BYTES + (spb + 1) * slot > SMEM_LIMIT
    assert (spb < unroll) == (unroll == 4 and block_k * streams >= 2048)


def test_axpy_space_is_the_registry_one():
    """The plan reads the registry's knobs (its space is the JAX one), and
    the registry's default is one part, one step a block, 4 KB tiles;
    every candidate's steps fit a block at once, and 2^20 bf16 takes the
    vector path whatever the knobs."""
    spec = REGISTRY["axpy"]
    assert spec.space == {"streams": (1, 2), "unroll": (1, 2),
                          "block_k": (256, 512, 1024)}
    assert (spec.default.streams, spec.default.unroll,
            spec.default.block_k) == (1, 1, 256)
    for cfg in enumerate_space(spec):
        plan = axpy_plan(1 << 27, 2, cfg, SMS)
        assert plan.spb == cfg.unroll and plan.tiles > 0
        assert plan.blocks == -(-plan.per // cfg.unroll)
        assert axpy_plan(1 << 20, 2, cfg, SMS) == vector_plan(1 << 20, 2, cfg)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("vectors,path", [
    (1, "vector"), (THREADS + 1, "vector"), (SMS * SM_THREADS, "vector"),
    (VECTOR_WAVES * SMS * SM_THREADS, "vector"),
    (VECTOR_WAVES * SMS * SM_THREADS + 1, "stream"), (1 << 24, "stream")])
def test_axpy_plan_takes_the_vector_path_up_to_four_waves(itemsize, vectors,
                                                          path):
    """Up to 4 times as many 16-byte vectors as the SMs hold threads, a
    vector a thread in blocks of 256, every vector once; one vector more
    streams."""
    n = vectors * (16 // itemsize)
    plan = axpy_plan(n, itemsize, REGISTRY["axpy"].default, SMS)
    if path == "stream":
        assert plan.tiles > 0 and plan.tail < plan.tile_v
        return
    assert (plan.tiles, plan.per, plan.tail, plan.smem) == (0, 0, vectors, 0)
    assert (plan.blocks - 1) * THREADS < vectors <= plan.blocks * THREADS
    assert (axpy_counts(plan) == 1).all()


def test_axpy_sizes_of_the_smoke_sit_on_either_side():
    """On 132 SMs 2^20 and 2^23 bf16 (and 2^20 fp32) take the vector path
    and 2^24 and 2^27 the stream."""
    cfg = REGISTRY["axpy"].default
    assert axpy_plan(1 << 20, 2, cfg, SMS).tiles == 0
    assert axpy_plan(1 << 23, 2, cfg, SMS).tiles == 0
    assert axpy_plan(1 << 20, 4, cfg, SMS).tiles == 0
    assert axpy_plan(1 << 24, 2, cfg, SMS).tiles == (1 << 21) // 256
    assert axpy_plan(1 << 27, 2, cfg, SMS).tiles == (1 << 24) // 256


MX_SHAPES = [
    (1024, 1024), (1024, 2816), (2048, 2048), (2048, 5632),  # projections
    (151936, 1024),                                          # the read-out
    (2816, 1024), (1408, 2048), (2048, 1408),
    (1040, 2848), (48, 96), (16, 1024), (1024, 32), (16, 32)]


def qgemv_counts(plan: QgemvPlan, N: int, bits: int):
    """How often the plan's lanes touch each (group of ``cols`` columns,
    code row), checking on the way that every live run stays inside one
    E8M0 block."""
    sb = 16 if bits == 4 else 32
    count = np.zeros((-(-N // plan.cols), plan.rows), np.int64)
    runs = np.array(list(plan.runs()), np.int64)
    live = (runs[:, 0] < N) & (runs[:, 1] < plan.rows)
    runs = runs[live]
    assert (runs[:, 0] % plan.cols == 0).all()
    assert (runs[:, 1] % plan.rpl == 0).all()
    assert (runs[:, 1] + plan.rpl <= plan.rows).all()
    assert (runs[:, 1] // sb == (runs[:, 1] + plan.rpl - 1) // sb).all()
    for i in range(plan.rpl):
        np.add.at(count, (runs[:, 0] // plan.cols, runs[:, 1] + i), 1)
    return count


@pytest.mark.parametrize("bits", [4, 8], ids=["fp4", "fp8"])
@pytest.mark.parametrize("N,K", MX_SHAPES)
def test_qgemv_plan_covers_each_column_and_row_once(N, K, bits):
    """Every (column, code row) of the weight by exactly one lane run of
    8 or 16 columns (16 where that gives half the SMs a lane's columns) and
    rpl rows inside one E8M0 block; one block a tile, its rounds covering
    K with none idle; the tiles cover N once (the last one ragged where N
    is not a multiple)."""
    plan = qgemv_plan(N, K, bits, SMS)
    assert plan.rows == (K // 2 if bits == 4 else K)
    assert plan.cols == (16 if 2 * -(-N // 16) >= SMS else 8)
    assert plan.lpr in (1, 2, 4, 8, 16, 32)
    assert plan.rpl in (1, 2, 4, 8, 16) and 1 <= plan.warps <= 8
    assert plan.rounds >= 1
    assert (plan.rounds - 1) * plan.band < plan.rows <= plan.rows_per_block
    assert (plan.tiles - 1) * plan.tile < N <= plan.tiles * plan.tile
    assert (qgemv_counts(plan, N, bits) == 1).all()


@pytest.mark.parametrize("N,K,bits", [
    (1024, 1024, 4), (1024, 2816, 4), (2048, 2048, 4), (2048, 5632, 4),
    (151936, 1024, 4), (151936, 1024, 8),        # the smoke's six shapes
    (1024, 1024, 8), (1024, 2816, 8), (2048, 2048, 8)])
def test_qgemv_plan_takes_k_in_one_block(N, K, bits):
    """At the projection shapes of qwen1.5-0.5b (q/k/v/o, down) and
    qwen2-moe-a2.7b (attention, the shared expert's down) and at the
    read-outs, one block of at most 8 warps takes a tile's whole K, in one
    round at the projections, its lanes leave less than a run of rows idle
    past K in every row lane, and the lanes fill 8 warps an SM of 132
    where the shape has the rows for it."""
    plan = qgemv_plan(N, K, bits, SMS)
    assert 1 <= plan.warps <= 8
    assert (plan.rounds == 1) == (N < 4 * SMS * 128)
    rlanes = 32 // plan.lpr
    assert plan.rows_per_block - plan.rows < rlanes * plan.rpl
    lanes = plan.tiles * plan.lpr * -(-plan.rows // plan.rpl)
    assert lanes >= 8 * 32 * SMS or plan.rpl == 1 or \
        plan.warps * rlanes * (plan.rpl // 2) < plan.rows


@pytest.mark.parametrize("N,K,bits,rounds,warps", [
    (64, 16384, 4, 2, 8), (64, 8192, 8, 2, 8), (1024, 16384, 8, 4, 8),
    (2048, 5632, 8, 2, 6), (64, 1 << 17, 4, 16, 8), (64, 1 << 17, 8, 32, 8)])
def test_qgemv_plan_walks_k_in_rounds_past_4096_rows_a_block(N, K, bits,
                                                             rounds, warps):
    """Where 16 rows a lane and 8 warps leave K uncovered, one block a
    tile walks K in rounds of 16 rows a lane, whatever K: as few rounds as
    8 warps take, then as few warps as cover K in those rounds."""
    plan = qgemv_plan(N, K, bits, SMS)
    assert (plan.rounds, plan.rpl, plan.warps) == (rounds, 16, warps)
    assert (plan.rounds - 1) * plan.band < plan.rows <= plan.rows_per_block


def test_qgemv_plan_streams_the_read_outs():
    """The read-outs have columns enough for 4 blocks an SM of 128-column
    tiles: each block walks all of K in bands of 64 rows, each lane 8 rows
    a band, in as many rounds as K takes."""
    for bits, rounds in ((4, 8), (8, 16)):
        plan = qgemv_plan(151936, 1024, bits, SMS)
        assert (plan.cols, plan.lpr, plan.warps, plan.rpl) == (16, 8, 2, 8)
        assert plan.rounds == rounds and plan.tiles == 1187
        assert plan.rows_per_block == plan.rows
