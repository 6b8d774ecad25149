"""The launch plans of ``axpy``, the one-row MX walk (``mx_qgemv``, the
fused SwiGLU, the grouped experts), the paged decode, ``rmsnorm`` and
``batched_qgemv``, as plain Python: what each block and lane of the CUDA
kernels covers.

``axpy_plan`` takes n elements on the vector path (a 16-byte vector a
thread) up to four waves of the card, and past that cuts them into tiles of
16-byte vectors walked as contiguous parts through shared memory, plus a
tail of fewer than a tile; ``qgemv_plan`` cuts (N, K) MX codes into column
tiles, one block a (tile, x row) holding a group of warps for each weight
stream, rounds down K and lane runs inside E8M0 blocks.  Each is held here
to cover every element (every stream, x row, column and code row) exactly
once, to keep its ragged tails right, and to fill a card of 132 SMs at the
projection shapes.
``paged_decode_plan`` cuts each slot's valid positions into splits of whole
pages, tiles of 16 positions a warp and m-tiles of 16 query heads; the walk
that the kernel computes on the device from it (``PageSplit`` in
``csrc/mma_attention.cuh``, ``paged_decode_mma_kernel`` in
``csrc/decode_attention.cu``) is written out here to fold every valid
position once, in warps that never cross a page.  ``rmsnorm_plan`` gives
a row one warp where d fits 8 vectors a lane, else the fewest warps, and a
block ``rmsnorm_threads`` / 32 warps; ``batched_qgemv_plan`` routes B >= 2
with groups of whole k-steps to the tensor-core tile walk (16-row tiles,
rounds of k-steps, K split over a block's warps where the tiles are few)
and the rest to the SIMT walk; ``batched_plan`` cuts ``batched_mx_qgemv``'s
MX tile walk (8 or 2 columns a lane, K split over a block's warps), held
here to cover every column, code row and output once, and its lanes'
fragments are emulated in numpy against the plain version.  ``wkv6_plan``
cuts a (batch, head) of ``wkv6`` into slices of the state's columns and
``mamba_plan`` spreads a channel's 16 states over 4 or 16 lanes; each is
held to cover every (column | state, step) once and to fill the card at
rwkv6-3b's and jamba's widths.  ``dotp_plan`` cuts two operands into
contiguous parts walked by one step a block up to a wave of the card and
by a striding wave past it; it is held to cover every 16-byte vector
once, and a numpy emulation of ``csrc/dotp.cu``'s summation order (which
``test_torch_cuda.py`` holds the card's bf16 bits to) is held to the JAX
oracle and the interpret-mode Pallas ``dotp``.  The kernels themselves
are held against their plain versions on the card
(``test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.troop import LaunchConfig  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_plan, wave_splits)
from repro_torch.kernels.axpy import (BARRIER_BYTES,  # noqa: E402
                                      SM_THREADS, SMEM_LIMIT, THREADS,
                                      VECTOR_WAVES, axpy_plan, stream_plan, vector_plan)
from repro_torch.kernels.mx_gemv import (BatchedPlan,  # noqa: E402
                                        QgemvPlan, batched_plan,
                                        grouped_plan, qgemv_plan,
                                        round_blocks, swiglu_plan)
from repro_torch.kernels.qgemv import (batched_qgemv_plan,  # noqa: E402
                                       k_step, walk_blocks)
from repro_torch.kernels.mamba_scan import mamba_plan  # noqa: E402
from repro_torch.kernels.rmsnorm import (MAX_VECS,  # noqa: E402
                                         rmsnorm_plan)
from repro_torch.kernels.rwkv6 import wkv6_plan, wkv6_smem  # noqa: E402
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


def walk_counts(plan: QgemvPlan, N: int, bits: int):
    """How often the plan's lanes touch each (stream, x row, group of
    ``cols`` columns, code row), checking on the way that every live run
    stays inside one E8M0 block and inside its block's tile."""
    sb = 16 if bits == 4 else 32
    count = np.zeros((plan.streams, plan.xrows, -(-N // plan.cols),
                      plan.rows), np.int64)
    runs = np.array(list(plan.lane_runs()), np.int64)
    st, xr, t, c, r0 = runs.T
    assert ((t * plan.tile <= c) & (c < (t + 1) * plan.tile)).all()
    live = (c < N) & (r0 < plan.rows)
    st, xr, c, r0 = st[live], xr[live], c[live], r0[live]
    assert (c % plan.cols == 0).all() and (r0 % plan.rpl == 0).all()
    assert (r0 + plan.rpl <= plan.rows).all()
    assert (r0 // sb == (r0 + plan.rpl - 1) // sb).all()
    for i in range(plan.rpl):
        np.add.at(count, (st, xr, c // plan.cols, r0 + i), 1)
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
    assert (walk_counts(plan, N, bits) == 1).all()


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


@pytest.mark.parametrize("N,K,bits,want", [
    (1024, 1024, 4, (8, 1, 8, 2, 1, 128, 512)),
    (1024, 2816, 4, (8, 1, 6, 8, 1, 128, 1408)),
    (2048, 2048, 4, (16, 1, 8, 4, 1, 128, 1024)),
    (2048, 5632, 4, (16, 1, 6, 16, 1, 128, 2816)),
    (151936, 1024, 4, (16, 8, 2, 8, 8, 1187, 512)),
    (151936, 1024, 8, (16, 8, 2, 8, 16, 1187, 1024))])
def test_qgemv_plan_is_unchanged_at_the_smoke_shapes(N, K, bits, want):
    """``mx_qgemv``'s cuts at the smoke's six shapes (cols, lpr, warps,
    rpl, rounds, tiles, rows) stay as they were before the walk took the
    SwiGLU and the grouped experts: one stream, one row, one group."""
    plan = qgemv_plan(N, K, bits, SMS)
    assert tuple(plan)[:7] == want
    assert (plan.xrows, plan.streams) == (1, 1)
    assert plan.block_warps == plan.warps and plan.blocks == plan.tiles


WALK_SHAPES = [(2816, 1024), (5632, 2048),    # the SwiGLU's gate + up
               (1408, 2048), (2048, 1408),    # the experts' up and down
               (1040, 2848), (48, 96), (16, 32), (64, 16384)]


@pytest.mark.parametrize("bits", [4, 8], ids=["fp4", "fp8"])
@pytest.mark.parametrize("N,K", WALK_SHAPES)
@pytest.mark.parametrize("xrows,streams", [
    (1, 2),                                   # mx_qgemv_swiglu
    (4, 1), (1, 1), (7, 1)],                  # grouped_expert_qgemv
    ids=["swiglu", "grouped-4", "grouped-1", "grouped-7"])
def test_walk_plans_cover_each_stream_row_column_and_code_row_once(
        N, K, bits, xrows, streams):
    """The SwiGLU's and the grouped experts' cuts: every (weight stream, x
    row, column, code row) by exactly one lane run, inside one E8M0 block;
    one block a (tile, x row), whose lanes stay inside the tile; the tiles
    cover N once (the last one at most ragged); a group of at most 8
    warps, at most 16 code loads a lane, rounds covering K with none
    idle."""
    plan = qgemv_plan(N, K, bits, SMS, xrows, streams)
    assert (plan.xrows, plan.streams) == (xrows, streams)
    assert plan.rows == (K // 2 if bits == 4 else K)
    assert plan.rpl <= 16 and 1 <= plan.warps <= 8
    assert plan.block_warps == plan.warps * streams
    assert (plan.rounds - 1) * plan.band < plan.rows <= plan.rows_per_block
    assert (plan.tiles - 1) * plan.tile < N <= plan.tiles * plan.tile
    assert plan.blocks == plan.tiles * xrows
    assert (walk_counts(plan, N, bits) == 1).all()


@pytest.mark.parametrize("bits", [4, 8], ids=["fp4", "fp8"])
@pytest.mark.parametrize("kind,N,K", [
    ("swiglu", 2816, 1024), ("swiglu", 5632, 2048),
    ("grouped", 1408, 2048), ("grouped", 2048, 1408)])
def test_walk_plans_give_every_sm_work_at_the_smoke_shapes(kind, N, K,
                                                           bits):
    """At the smoke's SwiGLU shapes (qwen1.5-0.5b's and qwen2-moe-a2.7b's
    shared expert's gate + up) and grouped shapes (qwen2-moe-a2.7b's
    experts, top-4), the wrappers' cuts give each of 132 SMs a block and
    8 warps' lanes, in one round; 1408 columns make no ragged tile."""
    plan = (swiglu_plan(N, K, bits, SMS) if kind == "swiglu"
            else grouped_plan(N, K, bits, SMS, 4))
    assert plan.blocks >= SMS
    assert plan.blocks * plan.block_warps >= 8 * SMS
    assert plan.rounds == 1
    assert N % plan.tile == 0
    if kind == "swiglu":
        assert plan.streams == 2 and plan.xrows == 1
    else:
        assert plan.streams == 1 and plan.xrows == 4


def test_mx_entry_points_take_the_wrappers_argtypes():
    """Each ``extern "C"`` entry point of ``csrc/mx_gemv.cu`` takes, in
    order, the pointers and ints its wrapper's ``_ARGTYPES`` pass (no
    compiler here checks the two against each other)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build, mx_gemv
    src = (Path(_build.CSRC) / "mx_gemv.cu").read_text()
    found = {}
    for name, params in re.findall(
            r'extern "C" \w+ (\w+)\(([^)]*)\)', src):
        found[name] = [_build.P if "*" in p else _build.I
                       for p in params.split(",")]
    assert found == mx_gemv._ARGTYPES


# ------------------------------------------------------------ paged decode
PAGED_WARPS = REGISTRY["paged_decode_attention"].space["decode_warps"]
MAX_PAGES = 256        # the kernel's page list (repro_paged_decode_max_pages)
SLOTS = 8


def paged_lengths(page, nblk):
    """One slot of each edge: idle, one position, a page less one, a
    page, a page and one, the whole table, mid-table, and a stale length
    past the table (the kernel clamps it)."""
    return [0, 1, page - 1, page, page + 1, nblk * page, 7 * page + 3,
            nblk * page + 40]


def paged_walk(length, nblk, page, plan):
    """What the blocks of one slot fold, as the kernel computes it: split s
    takes [lo, hi), ceil(ceil(n / page) / nsplit) pages each, n = length
    clamped to the table; warp w folds positions lo + t bn + 16 w .. + 15
    of tile t, those >= hi masked.  Yields (split, lo, hi, tile, warp,
    positions folded)."""
    n = max(0, min(length, nblk * page))
    nsplit, bn = plan["nsplit"], plan["bn"]
    chunk = -(-(-(-n // page)) // nsplit) * page
    for split in range(nsplit):
        lo = split * chunk
        hi = min(n, lo + chunk)
        tiles = -(-(hi - lo) // bn) if hi > lo else 0
        for t in range(tiles):
            for w in range(plan["warps"]):
                first = lo + t * bn + 16 * w
                yield split, lo, hi, t, w, [p for p in range(first, first + 16)
                                            if p < hi]


PAGED_CASES = [(nblk, page, G, warps) for nblk, page in ((64, 16), (32, 32))
               for G in (1, 5, 16, 20) for warps in PAGED_WARPS]


def paged_plan(nblk, page, G, warps, resident=264):
    KV = 2
    return paged_decode_plan(SLOTS, G * KV, KV, page, nblk,
                             LaunchConfig(decode_warps=warps), resident,
                             MAX_PAGES)


@pytest.mark.parametrize("resident", [132, 528])
@pytest.mark.parametrize("nblk,page,G,warps", PAGED_CASES)
def test_paged_decode_plan_folds_every_position_once(nblk, page, G, warps,
                                                     resident):
    """Every valid position of every slot by exactly one (split, tile,
    warp); nothing past the slot's valid positions; the blocks of one
    split a tile of ``bn`` = 16 positions a warp."""
    plan = paged_plan(nblk, page, G, warps, resident)
    assert plan["bn"] == 16 * plan["warps"] == 16 * warps
    for length in paged_lengths(page, nblk):
        n = max(0, min(length, nblk * page))
        count = np.zeros(nblk * page + 64, np.int64)
        for *_, pos in paged_walk(length, nblk, page, plan):
            np.add.at(count, pos, 1)
        assert (count[:n] == 1).all() and (count[n:] == 0).all()


@pytest.mark.parametrize("nblk,page,G,warps", PAGED_CASES)
def test_paged_decode_plan_keeps_splits_and_warps_inside_pages(nblk, page, G,
                                                               warps):
    """Every split starts on a page boundary and takes at most ``pages``
    table entries (the block's shared list); no warp's 16 positions cross
    a page, at 16-row (bf16) and 32-row (int8) pages."""
    plan = paged_plan(nblk, page, G, warps)
    assert plan["pages"] == -(-nblk // plan["nsplit"]) <= MAX_PAGES
    for length in paged_lengths(page, nblk):
        for _, lo, hi, _, _, pos in paged_walk(length, nblk, page, plan):
            assert lo % page == 0
            assert -(-hi // page) - lo // page <= plan["pages"]
            if pos:                       # a warp with a valid position
                assert pos[0] % 16 == 0
                assert pos[0] // page == (pos[0] + 15) // page


@pytest.mark.parametrize("nblk,page,G,warps", PAGED_CASES)
def test_paged_decode_plan_covers_the_heads_once(nblk, page, G, warps):
    """The m-tiles of 16 rows over blockIdx.z cover a KV head's G query
    heads once (G = 20: two tiles, the second of 4 rows); the grid is one
    block per (slot, KV head) on x and the splits on y."""
    plan = paged_plan(nblk, page, G, warps)
    gx, gy, gz = plan["grid"]
    assert (gx, gy, gz) == (SLOTS * 2, plan["nsplit"], -(-G // 16))
    heads = [16 * z + row for z in range(gz) for row in range(16)
             if 16 * z + row < G]
    assert heads == list(range(G))


@pytest.mark.parametrize("nblk,page,G,warps", PAGED_CASES)
def test_paged_decode_plan_idle_slot_commits_the_empty_state(nblk, page, G,
                                                             warps):
    """A slot of length 0 folds nothing in any split, so every split
    commits acc = 0, l = 0, m = -1e30 and the row comes out 0; a slot of
    one position leaves every split but the first empty."""
    plan = paged_plan(nblk, page, G, warps)
    assert list(paged_walk(0, nblk, page, plan)) == []
    splits = {split for split, *_ in paged_walk(1, nblk, page, plan)}
    assert splits == {0}


@pytest.mark.parametrize("G,KV,nblk,resident,want", [
    (1, 16, 64, 528, 4),        # the engines: 128 blocks, 4 an SM
    (1, 16, 64, 132, 1),        # the engines at one block an SM
    (1, 16, 9000, 528, 36),     # a table past one split's page list
    (5, 8, 64, 528, 4),         # qwen3-14b's heads: 64 blocks, 1024 rows
    (16, 2, 64, 528, 4),        # glm4-9b's: 16 blocks, capped at 256 rows
    (16, 2, 32 * 16, 132, 8),   # one block an SM: 132 // 16
    (20, 2, 64, 528, 4)])       # two m-tiles
def test_paged_decode_plan_splits(G, KV, nblk, resident, want):
    """The splits fill one wave of what the card holds, from the table's
    capacity (none shorter than 256 rows), and never take more table
    entries a split than the kernel's page list."""
    plan = paged_decode_plan(8, G * KV, KV, 16, nblk, LaunchConfig(),
                             resident, MAX_PAGES)
    assert plan["nsplit"] == want
    assert want == max(wave_splits(8 * KV * plan["grid"][2], nblk * 16,
                                   resident), -(-nblk // MAX_PAGES))
    with pytest.raises(ValueError, match="decode_warps"):
        paged_decode_plan(8, G * KV, KV, 16, nblk,
                          LaunchConfig(decode_warps=9), resident, MAX_PAGES)


# ----------------------------------------------------------------- rmsnorm
RMS_THREADS = REGISTRY["rmsnorm"].space["rmsnorm_threads"]


@pytest.mark.parametrize("threads", RMS_THREADS)
@pytest.mark.parametrize("d,wpr,vpl", [
    (128, 1, 1), (1024, 1, 4), (2048, 1, 8),   # qk-norm, the served widths
    (4096, 2, 8), (32768, 16, 8)])             # several warps a row
def test_rmsnorm_plan_covers_each_vector_and_row_once(d, wpr, vpl, threads):
    """A warp a row where d fits 8 vectors a lane (d <= 2048), else the
    fewest warps; the row's lanes (lane l of its warp w: vectors 32 w + l +
    32 wpr v) cover each 16-byte vector once, with the fewest vectors a
    lane; ``threads`` / 32 warps a block, so threads / (32 wpr) rows a block
    (at least one); 13 rows, a ragged last block: each row has its wpr
    warps once."""
    T, nvec = 13, d // 8
    plan = rmsnorm_plan(T, d, threads)
    assert (plan.wpr, plan.vpl) == (wpr, vpl)
    assert plan.vpl <= MAX_VECS
    assert plan.vpl // 2 * 32 * plan.wpr < nvec <= plan.vpl * 32 * plan.wpr
    count = np.zeros(nvec, np.int64)
    for w in range(plan.wpr):
        for lane in range(32):
            for v in range(plan.vpl):
                i = 32 * w + lane + 32 * plan.wpr * v
                if i < nvec:
                    count[i] += 1
    assert (count == 1).all()
    assert plan.rows == max(1, threads // 32 // plan.wpr)
    assert plan.threads == plan.rows * plan.wpr * 32 <= 1024
    warps = np.zeros(T, np.int64)
    for b in range(plan.blocks):
        for warp in range(plan.threads // 32):
            row = b * plan.rows + warp // plan.wpr
            if row < T:
                warps[row] += 1
    assert (warps == plan.wpr).all()
    assert (plan.blocks - 1) * plan.rows < T <= plan.blocks * plan.rows


@pytest.mark.parametrize("d", [12, 32776])
def test_rmsnorm_plan_refuses_what_the_kernel_cannot_take(d):
    """d must be a multiple of 8 and fit 16 warps of 8 vectors a lane (the
    kernel's 512 threads)."""
    assert rmsnorm_plan(1, 32768, 256).threads == 512
    with pytest.raises(ValueError, match="rmsnorm"):
        rmsnorm_plan(1, d, 128)


@pytest.mark.parametrize("module,source", [("rmsnorm", "rmsnorm"),
                                           ("dotp", "dotp"),
                                           ("qgemv", "qgemv"),
                                           ("rwkv6", "rwkv6"),
                                           ("mamba_scan", "mamba_scan")])
def test_entry_points_take_the_wrappers_argtypes(module, source):
    """Each ``extern "C"`` entry point of the source takes, in order, the
    pointers, ints and floats its wrapper's ``_ARGTYPES`` pass."""
    import importlib
    import re
    from pathlib import Path

    from repro_torch.kernels import _build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = (Path(_build.CSRC) / f"{source}.cu").read_text()
    found = {}
    for name, params in re.findall(
            r'extern "C" \w+ (\w+)\(([^)]*)\)', src):
        found[name] = [_build.P if "*" in p else
                       _build.F if p.split()[0] == "float" else _build.I
                       for p in params.split(",")]
    assert found == mod._ARGTYPES


# ----------------------------------------------------------- batched_qgemv
QGEMV_SPACE = list(enumerate_space(REGISTRY["batched_qgemv"]))
# (N, K, group): the smoke's rows and test_torch_cuda.py's
QGEMV_SHAPES = [(151936, 1024, 128), (2048, 4096, 128), (1000, 1024, 1024),
                (1000, 1024, 128), (33, 2816, 128)]


def tile_walk(plan, K):
    """How often the plan's warps take each 16-row tile (each (block, warp /
    ksplit) pair, ksplit warps on it), how often a tile's warps walk each
    k-step, each warp's count of rounds, and each run of steps between two
    scale flushes (a group's end, a round's end), which must lie inside one
    group."""
    nsteps = K // plan.kstep
    tiles = np.zeros(plan.tiles, np.int64)
    per = plan.warps // plan.ksplit
    for b in range(plan.blocks):
        for w in range(plan.warps):
            if b * per + w // plan.ksplit < plan.tiles:
                tiles[b * per + w // plan.ksplit] += 1
    steps = np.zeros(nsteps, np.int64)
    rounds, runs = [], []
    for wk in range(plan.ksplit):
        rounds.append(len(plan.rounds(K, wk)))
        for first in plan.rounds(K, wk):
            run = []
            for u in range(plan.steps):
                s = first + u
                if s >= nsteps:
                    break
                steps[s] += 1
                run.append(s)
                if (s + 1) % plan.gsteps == 0 or u == plan.steps - 1:
                    runs.append(run)
                    run = []
            assert run == []
    return tiles, steps, rounds, runs


@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("N,K,group", QGEMV_SHAPES)
def test_batched_qgemv_plan_tiles_cover_each_row_and_step_once(N, K, group,
                                                              bits, B):
    """At every candidate of the tuner's space, one row of x (the one-row
    ``qgemv``) too: the tile walk, block_n / 32 warps, rounds of 4 x unroll
    k-steps (more only where K is split, up to 16); 16-row tiles over N, every k-step of every tile walked by one warp
    once, the K split dividing the warps with each warp keeping a round
    (the kernel's barrier after the first); and the partial between two
    scale flushes never crosses a group."""
    for cfg in QGEMV_SPACE:
        plan = batched_qgemv_plan(N, K, K // group, B, bits, cfg, SMS)
        assert plan.route == "tile" and "mma.sync" in plan.why
        assert plan.kstep == k_step(bits) and plan.gsteps * plan.kstep == group
        assert plan.warps == cfg.block_n // 32
        assert plan.steps in (4 * cfg.unroll, 8, 16)
        assert plan.steps == 4 * cfg.unroll or plan.ksplit > 1
        assert plan.warps % plan.ksplit == 0
        per = plan.warps // plan.ksplit
        assert plan.tiles == -(-N // 16)
        assert (plan.blocks - 1) * per < plan.tiles <= plan.blocks * per
        tiles, steps, rounds, runs = tile_walk(plan, K)
        assert (tiles == plan.ksplit).all() and (steps == 1).all()
        assert min(rounds) >= 1
        for run in runs:
            assert len({s // plan.gsteps for s in run}) == 1


@pytest.mark.parametrize("N,K,bits,B,ksplit,steps,blocks", [
    (151936, 1024, 8, 8, 1, 4, 1187), (151936, 1024, 4, 8, 1, 4, 1187),
    (151936, 1024, 8, 16, 1, 4, 1187),   # the read-out: 9,496 tiles
    (2048, 4096, 8, 4, 8, 8, 128),       # 128 tiles, 64 k-steps
    (2048, 4096, 4, 4, 8, 4, 128),       # 32 k-steps
    (2048, 4096, 8, 1, 8, 8, 128),       # one row of x: the same cut
    (151936, 1024, 4, 1, 1, 4, 1187)])
def test_batched_qgemv_plan_at_the_smoke_rows(N, K, bits, B, ksplit, steps,
                                              blocks):
    """The smoke's rows at the default config (8 warps, rounds of 4
    k-steps): the read-outs fill the card with tiles and take no K split;
    (2048, 4096) has 128 tiles, so 8 warps share each one, and in int8 a
    warp's 8 steps are one round.  One row of x is cut as many."""
    plan = batched_qgemv_plan(N, K, K // 128, B, bits, LaunchConfig(), SMS)
    assert (plan.route, plan.ksplit, plan.steps, plan.blocks) == (
        "tile", ksplit, steps, blocks)


@pytest.mark.parametrize("N,K,group,bits,B", [
    (256, 1024, 64, 4, 1),      # one row, groups of half a k-step
    (256, 1024, 64, 4, 8),      # int4 groups of 64: half a k-step of 128
    (256, 1024, 32, 8, 16),     # int8 groups of 32: half a k-step of 64
    (256, 1536, 192, 4, 2),     # int4 groups of 192: 1.5 k-steps
    (256, 14528, 64, 8, 8),     # xs 232,448 bytes, padded 232,576
    # the smoke's SIMT walk rows: the read-out, one row and eight
    (151936, 1024, 64, 4, 1), (151936, 1024, 32, 8, 1),
    (151936, 1024, 64, 4, 8), (151936, 1024, 32, 8, 8)])
def test_batched_qgemv_plan_routes_the_rest_to_the_walk(N, K, group, bits,
                                                        B):
    """Groups that do not hold whole k-steps (at one row of x too) and xs
    that fills the shared memory only without its padding take the SIMT
    walk, and the plan says why."""
    plan = batched_qgemv_plan(N, K, K // group, B, bits, LaunchConfig(), SMS)
    assert plan.route == "walk"
    why = "shared memory" if K == 14528 else "narrower"
    assert why in plan.why


@pytest.mark.parametrize("cfg", [LaunchConfig(block_n=512),
                                 LaunchConfig(unroll=3),
                                 LaunchConfig(block_n=48)])
def test_batched_qgemv_plan_refuses_knobs_the_tile_walk_cannot_take(cfg):
    """More than 8 warps (the tile kernel's launch bound), unroll outside
    1, 2, 4 or a block of a partial warp raise; the walk's own range is
    checked by its wrapper."""
    with pytest.raises(ValueError, match="block_n"):
        batched_qgemv_plan(2048, 4096, 32, 4, 8, cfg, SMS)


@pytest.mark.parametrize("N,K,B,cfg,want", [
    (151936, 1024, 1, LaunchConfig(), (8, 1, 8 * SMS)),   # the read-out
    (151936, 1024, 8, LaunchConfig(), (8, 1, 8 * SMS)),
    (151936, 1024, 8, LaunchConfig(block_n=128, unroll=2), (4, 2, 14 * SMS)),
    (2048, 4096, 4, LaunchConfig(), (8, 1, 256)),         # rows run out
    (256, 14528, 8, LaunchConfig(), (8, 1, 32))])         # xs fills an SM
def test_walk_blocks_fill_the_card_until_the_rows_run_out(N, K, B, cfg,
                                                          want):
    """The SIMT walk's cut, which its wrapper launches and the chip probe
    times: block_n / 32 warps, unroll W rows a warp, and blocks for every
    row up to the blocks the SMs hold at once (2,048 threads, xs in 227
    KiB of shared memory an SM: at least one)."""
    warps, rows, blocks = walk_blocks(N, K, B, cfg, SMS)
    assert (warps, rows, blocks) == want
    assert blocks * warps * rows >= N or blocks % SMS == 0


# -------------------------------------------------------- batched_mx_qgemv
MX_BATCHED_SPACE = list(enumerate_space(REGISTRY["batched_mx_qgemv"]))
# (N, K, bits): the smoke's rows, the cuda tests' and the ragged ones
MX_BATCHED_SHAPES = [(151936, 1024, 4), (151936, 1024, 8), (2048, 4096, 4),
                     (2048, 4096, 8), (1040, 2848, 8), (48, 96, 4)]


def mx_tile_walk(plan: BatchedPlan, N: int, K: int, bits: int):
    """The tile walk's cut as counts: how often the plan's warps take each
    tile (each (block, warp / ksplit) pair, ksplit warps on it, each with
    its own wk), how often a tile's warps walk each E8M0 block, how often
    the lanes of one warp load each (column of its tile, code row of a
    block), and how often each (x row, column) is stored (by the tile's
    first warp, lane (g, q) the x rows 8 nt + 2q + e < B of columns g cols
    .. + cols - 1)."""
    per = plan.warps // plan.ksplit
    takes = np.zeros((plan.tiles, plan.ksplit), np.int64)
    for b in range(plan.blocks):
        for w in range(plan.warps):
            if b * per + w // plan.ksplit < plan.tiles:
                takes[b * per + w // plan.ksplit, w % plan.ksplit] += 1
    nkb = K // 32
    walked = np.zeros(nkb, np.int64)
    for wk in range(plan.ksplit):
        for first in plan.rounds(K, wk):
            walked[first:min(first + plan.round_blocks, nkb)] += 1
    stride, rows = (16, 4) if bits == 4 else (32, 8)
    cells = np.zeros((plan.tile, stride), np.int64)
    for lane in range(32):
        g, q = divmod(lane, 4)
        cells[g * plan.cols:(g + 1) * plan.cols,
              rows * q:rows * (q + 1)] += 1
    return takes, walked, cells


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("N,K,bits", MX_BATCHED_SHAPES)
def test_batched_plan_covers_each_column_code_row_and_output_once(N, K,
                                                                  bits, B):
    """At every candidate of the tuner's space: every tile by ksplit warps,
    one each wk; every E8M0 block of K by one warp of a tile (so a partial,
    one block's products, never crosses a block); every (column, code
    row) of a block and tile by one lane; every Y[b][n] written once."""
    for cfg in MX_BATCHED_SPACE:
        plan = batched_plan(N, K, bits, B, cfg, SMS)
        assert "mma.sync" in plan.why
        assert plan.warps == cfg.block_n // 32 and plan.warps % plan.ksplit == 0
        assert plan.nt == (1 if B <= 8 else 2)
        assert plan.tiles == -(-N // plan.tile)
        per = plan.warps // plan.ksplit
        assert (plan.blocks - 1) * per < plan.tiles <= plan.blocks * per
        takes, walked, cells = mx_tile_walk(plan, N, K, bits)
        assert (takes == 1).all() and (walked == 1).all() and (cells == 1).all()
        assert min(len(plan.rounds(K, wk)) for wk in range(plan.ksplit)) >= 1
        stored = np.zeros((B, plan.tiles * plan.tile), np.int64)
        for t in range(plan.tiles):
            for lane in range(32):
                g, q = divmod(lane, 4)
                c = (t * 8 + g) * plan.cols
                for nt in range(plan.nt):
                    for e in range(2):
                        n = 8 * nt + 2 * q + e
                        if n < B and c < N:
                            stored[n, c:c + plan.cols] += 1
        assert (stored[:, :N] == 1).all() and (stored[:, N:] == 0).all()


@pytest.mark.parametrize("N,K,bits,B,cols,ksplit,blocks", [
    (151936, 1024, 4, 8, 8, 4, 1187),    # 2,374 tiles of 64 columns
    (151936, 1024, 8, 8, 8, 4, 1187),
    (151936, 1024, 4, 16, 8, 4, 1187),   # two n-tiles
    (2048, 4096, 4, 4, 2, 8, 128),       # 32 tiles of 64 columns: 2 a lane
    (2048, 4096, 8, 4, 2, 8, 128), (2048, 4096, 4, 16, 2, 8, 128)])
def test_batched_plan_at_the_smoke_rows(N, K, bits, B, cols, ksplit, blocks):
    """The smoke's rows at the default config (8 warps, unroll 1): the
    read-outs take 64-column tiles, K split over 4 warps (at 8 the tiles'
    warps would pass 64 an SM); 4096 -> 2048 takes 16-column tiles, 8
    warps on each."""
    plan = batched_plan(N, K, bits, B, LaunchConfig(), SMS)
    assert (plan.cols, plan.ksplit, plan.blocks) == (cols, ksplit, blocks)
    assert plan.round_blocks == round_blocks(bits, cols, 1)


@pytest.mark.parametrize("cfg,B", [(LaunchConfig(block_n=512), 4),
                                   (LaunchConfig(unroll=4), 4),
                                   (LaunchConfig(), 17), (LaunchConfig(), 0)])
def test_batched_plan_refuses_what_the_kernel_cannot_take(cfg, B):
    with pytest.raises(ValueError, match="rows <= 16"):
        batched_plan(2048, 4096, 4, B, cfg, SMS)


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte i of the
    result is byte (s >> 4i) & 7 of the eight bytes {x, y}, or that byte's
    sign replicated where bit 3 of the selector nibble is set."""
    x, y, s = (np.asarray(v, np.uint64) for v in (x, y, s))
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(15)
        b = (both >> ((sel & np.uint64(7)) * np.uint64(8))) & np.uint64(255)
        b = np.where(sel & np.uint64(8),
                     np.where(b & np.uint64(128), np.uint64(255),
                              np.uint64(0)), b)
        out |= b << np.uint64(8 * i)
    return out.astype(np.uint32)


def fp4x8_bf16(w):
    """``csrc/mx_gemv.cu`` `fp4x8_bf16`, op for op: uint32 words -> their
    four bf16x2 words (..., 4)."""
    w = np.asarray(w, np.uint32)
    m = w & np.uint32(0x77777777)
    mh, w4 = m >> np.uint32(16), w << np.uint32(4)
    lo_a = byte_perm(0xC0800000, 0xC0804000, m)
    lo_b = byte_perm(0xC0800000, 0xC0804000, mh)
    hi_a = byte_perm(0x3F3F3F00, 0x40404040, m) | (
        byte_perm(w4, w, 0x5140) & np.uint32(0x80808080))
    hi_b = byte_perm(0x3F3F3F00, 0x40404040, mh) | (
        byte_perm(w4, w, 0x7362) & np.uint32(0x80808080))
    return np.stack([byte_perm(lo_a, hi_a, 0x5140),
                     byte_perm(lo_a, hi_a, 0x7362),
                     byte_perm(lo_b, hi_b, 0x5140),
                     byte_perm(lo_b, hi_b, 0x7362)], -1)


def bf16x2(words):
    """bf16x2 words -> (..., 2) float32: the low half, then the high."""
    words = np.asarray(words, np.uint32)
    return np.stack([(words << np.uint32(16)).view(np.float32),
                     (words & np.uint32(0xFFFF0000)).view(np.float32)], -1)


def test_fp4_decode_in_registers_is_exact():
    """Every byte of two e2m1 codes decodes to the JAX package's values
    (``fp4_decode``) in the order the A fragment takes: low nibble (the
    even k) in the low half."""
    from repro_torch.quant.tensor import fp4_decode
    b = np.arange(256, dtype=np.uint32)
    words = b | (b << 8) | (b << 16) | (b << 24)
    got = bf16x2(fp4x8_bf16(words))                  # (256, 4, 2)
    lo = fp4_decode(torch.as_tensor(b & 15, dtype=torch.uint8)).numpy()
    hi = fp4_decode(torch.as_tensor(b >> 4, dtype=torch.uint8)).numpy()
    for i in range(4):
        np.testing.assert_array_equal(got[:, i, 0], lo)
        np.testing.assert_array_equal(got[:, i, 1], hi)


def emulate_batched(wq, scales, xs, plan: BatchedPlan):
    """``mx_mma_kernel`` in numpy, lane by lane: each warp's tile, each of
    its E8M0 blocks, each k16 step's A fragments decoded from the lane's
    loads (fp4 by ``fp4x8_bf16``, fp8 byte pairs of consecutive code
    rows), B fragments from x words 4q + 2 step (+ 1), the mma as its
    16 x 8 product, the block's partial times 2^(s - 127), the K split's
    partials added in warp order, and the stores of lane (g, q)."""
    fp8 = wq.dtype == torch.float8_e4m3fn
    codes = wq.view(torch.uint8).numpy().astype(np.uint32)
    if fp8:
        vals = torch.arange(256, dtype=torch.uint8).view(
            torch.float8_e4m3fn).float().numpy()
    sc = scales.numpy().astype(np.int64)
    x = xs.float().numpy()
    B, K = x.shape
    N = codes.shape[1]
    rows, stride = (8, 32) if fp8 else (4, 16)
    cols, nt_n = plan.cols, plan.nt
    y = np.zeros((B, N), np.float32)
    for t in range(plan.tiles):
        parts = []
        for wk in range(plan.ksplit):
            acc = np.zeros((32, nt_n, cols // 2, 4), np.float32)
            for first in plan.rounds(K, wk):
                for kb in range(first, min(first + plan.round_blocks,
                                           K // 32)):
                    # A[st][j]: 16 x 16, B[st][nt]: 16 x 8
                    A = np.zeros((2, cols // 2, 16, 16), np.float32)
                    Bm = np.zeros((2, nt_n, 16, 8), np.float32)
                    f = np.zeros((32, cols), np.float32)
                    for lane in range(32):
                        g, q = divmod(lane, 4)
                        c = (t * 8 + g) * cols
                        c = c if c < N else 0
                        r0 = kb * stride + rows * q
                        chunk = codes[r0:r0 + rows, c:c + cols]  # (rows, cols)
                        s = sc[kb, c:c + cols]
                        f[lane] = np.where(s > 0, np.ldexp(1.0, s - 127),
                                           np.float32(2.0 ** -127))
                        for st in range(2):
                            for h in range(2):
                                if fp8:
                                    a = vals[chunk[4 * st + 2 * h]]
                                    b = vals[chunk[4 * st + 2 * h + 1]]
                                    pairs = np.stack([a, b], -1)
                                else:
                                    byte = chunk[2 * st + h]
                                    pad = np.zeros(-cols % 4, np.uint32)
                                    wd = np.concatenate([byte, pad]).reshape(
                                        -1, 4)
                                    wd = (wd[:, 0] | wd[:, 1] << 8
                                          | wd[:, 2] << 16 | wd[:, 3] << 24)
                                    pairs = bf16x2(fp4x8_bf16(wd)).reshape(
                                        -1, 2)[:cols]
                                for j in range(cols // 2):
                                    k0 = 2 * q + 8 * h
                                    A[st, j, g, k0:k0 + 2] = pairs[2 * j]
                                    A[st, j, g + 8, k0:k0 + 2] = pairs[2 * j + 1]
                        for nt in range(nt_n):
                            xr = x[min(8 * nt + g, B - 1)]
                            k = kb * 32 + 8 * q
                            for st in range(2):
                                for h in range(2):
                                    kk = k + 4 * st + 2 * h
                                    Bm[st, nt, 2 * q + 8 * h:2 * q + 8 * h + 2,
                                       g] = xr[kk:kk + 2]
                    for nt in range(nt_n):
                        for j in range(cols // 2):
                            p = (A[0, j] @ Bm[0, nt]).astype(np.float32)
                            p = (p + A[1, j] @ Bm[1, nt]).astype(np.float32)
                            for lane in range(32):
                                g, q = divmod(lane, 4)
                                frag = np.array([p[g, 2 * q], p[g, 2 * q + 1],
                                                 p[g + 8, 2 * q],
                                                 p[g + 8, 2 * q + 1]])
                                fj = f[lane, [2 * j, 2 * j, 2 * j + 1,
                                              2 * j + 1]]
                                acc[lane, nt, j] += fj * frag
            parts.append(acc)
        acc = parts[0]
        for more in parts[1:]:
            acc = acc + more
        for lane in range(32):
            g, q = divmod(lane, 4)
            c = (t * 8 + g) * cols
            if c >= N:
                continue
            for nt in range(nt_n):
                for e in range(2):
                    n = 8 * nt + 2 * q + e
                    if n < B:
                        row = np.stack([acc[lane, nt, :, e],
                                        acc[lane, nt, :, 2 + e]], -1)
                        y[n, c:c + cols] = row.reshape(-1)
    return y


@pytest.mark.parametrize("elem,cols,B", [("fp4", 8, 3), ("fp4", 2, 9),
                                         ("fp8", 8, 9), ("fp8", 2, 3),
                                         ("fp4", 8, 16)])
def test_batched_lane_mapping_reproduces_the_plain_version(elem, cols, B):
    """The lane-to-(column, k) mapping of the tile walk, emulated in numpy
    from the codes' bytes, gives ``ref.batched_mx_qgemv`` on a small shape
    (fp32 sums in another order: 1e-5 of sum |w x|), at 8 and 2 columns
    a lane, one and two n-tiles, a K split in two, a ragged last
    tile."""
    from repro_torch.kernels import ref
    from repro_torch.quant.tensor import quantize_mx
    rng = np.random.default_rng(7)
    N, K = (144, 128) if cols > 2 else (48, 128)
    wq = quantize_mx(torch.as_tensor(rng.standard_normal((K, N)) / 8,
                                     dtype=torch.float32), elem=elem)
    xs = torch.as_tensor(rng.standard_normal((B, K)),
                         dtype=torch.float32).to(torch.bfloat16)
    bits = 4 if elem == "fp4" else 8
    rb = round_blocks(bits, cols, 1)
    tiles = -(-N // (8 * cols))
    plan = BatchedPlan("", cols, 4, rb, 2, tiles, -(-tiles // 2),
                       1 if B <= 8 else 2)
    got = emulate_batched(wq.values, wq.scales, xs, plan)
    want = ref.batched_mx_qgemv(wq.values, wq.scales, xs).numpy()
    wd = ref._mx_dequant(wq.values, wq.scales).numpy()
    bound = 1e-5 * (np.abs(xs.float().numpy()) @ np.abs(wd))
    assert (np.abs(got - want) <= bound).all()


# ------------------------------------------------------ the scans' splits
RWKV6_3B, JAMBA = (1, 2048, 40, 64), (1, 2048, 8192)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("B,T,H,hd", [
    (1, 256, 4, 64),        # the registry example
    (2, 77, 3, 32),         # ragged T
    (1, 100, 2, 128),
    (1, 5, 2, 64),          # shorter than a chunk
    (1, 160, 40, 64),       # rwkv6-3b's heads
    (3, 33, 50, 128),       # B H past the card: the widest slice
])
def test_wkv6_plan_covers_every_column_and_chunk_once(B, T, H, hd, chunk):
    """Block (bh, c) of the grid (B H, hd / cols) owns columns c cols ..
    (c + 1) cols - 1 of (batch, head) bh and walks every chunk of T: each
    (batch, head, column, chunk) once; the sub-chunks tile the chunk."""
    plan = wkv6_plan(B, T, H, hd, chunk)
    nchunks = -(-T // chunk)
    count = np.zeros((B * H, hd, nchunks), np.int64)
    gx, gy = plan.grid
    assert gx * gy == plan.blocks and gy == plan.col_blocks == hd // plan.cols
    for bh in range(gx):
        for c in range(gy):
            for ch in range(nchunks):
                count[bh, c * plan.cols:(c + 1) * plan.cols, ch] += 1
    assert (count == 1).all()
    assert plan.chunk == chunk and chunk % plan.sub == 0
    assert plan.cols in (8, 16, 32) and plan.cols <= hd
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_wkv6_plan_at_rwkv6_3b(chunk, itemsize):
    """A block of 16 warps holds an SM (its producers and consumers), so
    rwkv6-3b's 40 heads of 64 take 32 columns a block: 80 blocks, all in
    one wave; 16 columns would give 160 blocks, a second wave."""
    plan = wkv6_plan(*RWKV6_3B, chunk, SMS, itemsize)
    assert (plan.cols, plan.blocks, plan.threads) == (32, 80, 512)
    assert plan.blocks <= SMS < 40 * 64 // 16
    assert plan.smem + 1024 <= 228 * 1024


def test_wkv6_plan_takes_the_narrowest_slice_in_one_wave():
    """The most blocks that still run in one wave; where even the widest
    slice needs more, the widest that fits the shared memory."""
    assert wkv6_plan(1, 64, 4, 64, 32).cols == 8            # 32 blocks
    assert wkv6_plan(1, 64, 16, 64, 32).cols == 8           # 128 blocks
    assert wkv6_plan(1, 64, 17, 64, 32).cols == 16          # 68 blocks
    assert wkv6_plan(4, 64, 40, 64, 32).cols == 32          # 320 blocks
    assert wkv6_plan(3, 33, 50, 128, 32).cols == 32         # 600 blocks
    for bad in (dict(hd=48), dict(chunk=64), dict(T=0)):
        kw = {"B": 1, "T": 8, "H": 1, "hd": 64, "chunk": 32, **bad}
        with pytest.raises(ValueError, match="wkv6"):
            wkv6_plan(**kw)


@pytest.mark.parametrize("hd,chunk,cols,itemsize,want", [
    (64, 32, 16, 4, 137_984), (64, 32, 16, 2, 111_360),
    (128, 32, 16, 4, 199_168), (32, 8, 8, 4, 19_456)])
def test_wkv6_smem_is_the_kernels_layout(hd, chunk, cols, itemsize, want):
    """``Layout<T, HD, L, CB>::bytes`` of ``csrc/rwkv6.cu``, worked out by
    hand (two staged chunks, or one at hd 128 and chunks of 32, where two
    do not fit); every slice the plan may take fits a block's 227 KB."""
    assert wkv6_smem(hd, chunk, cols, itemsize) == want
    for h in (32, 64, 128):
        for L in (8, 16, 32):
            assert wkv6_plan(1, 8, 1, h, L).smem <= 227 * 1024
            assert wkv6_plan(9, 8, 50, h, L).smem <= 227 * 1024


def reduce_owner(lanes, L):
    """The tile-end transpose-reduce of ``csrc/mamba_scan.cu``: for each
    lane of a channel, the first sum it holds at the end and how many;
    the lanes that write (the lower lane of each pair that holds the same
    sum when L < lanes)."""
    out = {}
    for g in range(lanes):
        first, cnt, o = 0, L, lanes // 2
        while o >= 1:
            if cnt >= 2:
                if g & o:
                    first += cnt // 2
                cnt //= 2
            o //= 2
        if not g & max(lanes // L - 1, 0):
            out[g] = (first, cnt)
    return out


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("b,T,di", [
    (2, 512, 512),          # the registry example
    (1, 100, 300),          # ragged T and channels
    (1, 3, 128),            # shorter than a tile
    (1, 40, 4224),          # 4 lanes a channel
    (3, 17, 1000),
])
def test_mamba_plan_covers_every_state_and_step_once(b, T, di, chunk):
    """Lane g of channel cl in block (cb, batch) holds states g states ..
    (g + 1) states - 1 of channel cb channels + cl and walks every step:
    each (batch, channel, state, step) once; at a tile's end each step's
    sum of a channel is written by one lane."""
    plan = mamba_plan(b, T, di, chunk)
    assert plan.lanes * plan.states == 16
    assert plan.channels * plan.lanes == plan.threads
    count = np.zeros((b, di, 16), np.int64)
    for bb in range(b):
        for cb in range(plan.col_blocks):
            for tid in range(plan.threads):
                c = cb * plan.channels + tid // plan.lanes
                g = tid % plan.lanes
                if c < di:
                    count[bb, c, g * plan.states:(g + 1) * plan.states] += 1
    assert (count == 1).all()
    assert plan.blocks == b * plan.col_blocks
    assert (plan.col_blocks - 1) * plan.channels < di <= (plan.col_blocks
                                                          * plan.channels)
    steps = np.zeros(chunk, np.int64)
    for first, cnt in reduce_owner(plan.lanes, chunk).values():
        steps[first:first + cnt] += 1
    assert (steps == 1).all()          # every step of every tile once


def test_mamba_plan_fills_the_card_at_jamba():
    """jamba's 8192 channels: 4 lanes of 4 states, 32 channels a block of
    128 threads, 256 blocks (32,768 threads): at least one block an SM;
    the registry's (2, 512, 512) takes 16 lanes of 1 (128 blocks, the
    most it has)."""
    plan = mamba_plan(*JAMBA, 32, SMS)
    assert (plan.lanes, plan.states, plan.blocks) == (4, 4, 256)
    assert plan.blocks >= SMS and plan.blocks * plan.threads == 32768
    assert mamba_plan(2, 512, 512, 32, SMS).lanes == 16
    assert mamba_plan(2, 512, 512, 32, SMS).blocks == 128
    with pytest.raises(ValueError, match="mamba_scan"):
        mamba_plan(1, 8, 64, 64)


# -------------------------------------------------------------------- dotp
DOTP_SPACE = list(enumerate_space(REGISTRY["dotp"]))
# the smoke's two sizes (bf16 elements)
DOTP_SMOKE = (1 << 20, 1 << 27)


def dotp_vectors(plan):
    """(threads of the grid, folds): the 16-byte vectors each thread of
    ``csrc/dotp.cu`` folds, in its order (its steps, then each part, then
    each of its ``vpt`` vectors), -1 where it holds none."""
    iters = -(-plan.steps // plan.blocks)
    b = np.arange(plan.blocks)[:, None]
    t = np.arange(plan.threads)[None, :]
    cols = []
    for k in range(iters):
        c = b + k * plan.blocks
        for s in range(plan.streams):
            for u in range(plan.vpt):
                i = c * plan.chunk + u * plan.threads + t
                g = s * plan.part + i
                live = (c < plan.steps) & (i < plan.part) & (g < plan.nv)
                cols.append(np.where(live, g, -1).reshape(-1))
    return np.stack(cols, axis=1)


def xor_tree(v):
    """``repro::warp_sum`` over the last axis (32 lanes): v += the value of
    lane ^ o for o = 16, 8, 4, 2, 1 (every lane ends with the same sum)."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def block_sum(v):
    """``block_sum`` of ``csrc/dotp.cu`` over the last axis (threads, a
    multiple of 32): each warp's xor tree, then the warps' sums as the
    first lanes of one warp, the others 0."""
    w = xor_tree(v.reshape(*v.shape[:-1], -1, 32))
    lanes = np.zeros((*w.shape[:-1], 32), np.float32)
    lanes[..., :w.shape[-1]] = w
    return xor_tree(lanes)


def dotp_emulate(x, y, plan):
    """``csrc/dotp.cu``'s sum of x . y (numpy float32 arrays) walked as
    ``plan`` says, in numpy float32: each thread's FMAs over its vectors,
    the block's xor-shuffle and shared-memory step, then the combine
    (thread t of ``plan.combine`` folds the float4 groups of partials t,
    t + combine, ..., each group's four in order) and its block step.
    Products of bf16 values are exact in fp32, so there each FMA is the
    float32 sum this takes: the kernel's bits.  For fp32 inputs it rounds
    each product, which the FMA does not (within the gate)."""
    p = (x.astype(np.float32) * y.astype(np.float32)).reshape(plan.nv,
                                                              plan.vec)
    acc = np.zeros(plan.blocks * plan.threads, np.float32)
    for col in dotp_vectors(plan).T:
        live = col >= 0
        prod = p[np.where(live, col, 0)]
        for j in range(plan.vec):
            acc = np.where(live, acc + prod[:, j], acc)
    partial = block_sum(acc.reshape(plan.blocks, plan.threads))
    groups = -(-plan.blocks // 4)
    rounds = -(-groups // plan.combine)
    q = np.zeros(rounds * plan.combine * 4, np.float32)
    q[:plan.blocks] = partial
    q = q.reshape(rounds, plan.combine, 4)
    s = np.zeros(plan.combine, np.float32)
    for r in range(rounds):
        for k in range(4):
            s = s + q[r, :, k]
    return block_sum(s)


def dotp_tiles(plan):
    """Every vector of both operands once, counted by the plan's arithmetic
    (no array of the operands' size): the (part, step) ranges tile [0, nv),
    each step falls to one block, and a step's (vector, thread) slots are
    [0, chunk)."""
    c = np.arange(plan.steps)
    starts = (np.arange(plan.streams)[:, None] * plan.part
              + c[None, :] * plan.chunk)
    ends = (np.arange(plan.streams)[:, None] * plan.part
            + np.minimum((c[None, :] + 1) * plan.chunk, plan.part))
    starts, ends = np.minimum(starts, plan.nv), np.minimum(ends, plan.nv)
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    order = np.argsort(starts)
    starts, ends = starts[order], ends[order]
    assert starts[0] == 0 and ends[-1] == plan.nv
    assert (starts[1:] == ends[:-1]).all()
    owners = np.bincount(c % plan.blocks, minlength=plan.blocks)
    assert owners.sum() == plan.steps and (owners > 0).all()
    slots = (np.arange(plan.vpt)[:, None] * plan.threads
             + np.arange(plan.threads)[None, :]).reshape(-1)
    assert (np.sort(slots) == np.arange(plan.chunk)).all()


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cfg", DOTP_SPACE,
                         ids=lambda c: f"s{c.streams}u{c.unroll}k{c.block_k}")
@pytest.mark.parametrize("n", [8, 4096, 65536 + 8, 1 << 20])
def test_dotp_plan_covers_every_vector_once(itemsize, cfg, n):
    """Every thread's vectors over the grid: each 16-byte vector of both
    operands once (n of one vector, a few blocks, a ragged part, 2^20); up
    to a wave one step a block (all of a thread's loads before its first
    FMA), every block within the card's residency; one combine of
    ``COMBINE`` threads."""
    from repro_torch.kernels.dotp import (COMBINE, SM_BLOCKS, SM_THREADS,
                                          dotp_plan)
    plan = dotp_plan(n, itemsize, cfg, SMS)
    vec = 16 // itemsize
    assert (plan.vec, plan.nv, plan.streams) == (vec, n // vec, cfg.streams)
    assert plan.threads == cfg.block_k // vec and plan.vpt == cfg.unroll
    assert plan.chunk == plan.threads * plan.vpt
    assert plan.part == -(-plan.nv // cfg.streams)
    assert plan.steps == -(-plan.part // plan.chunk)
    resident = SMS * min(SM_BLOCKS, SM_THREADS // plan.threads)
    assert plan.blocks == min(plan.steps, resident)
    assert plan.combine == COMBINE
    idx = dotp_vectors(plan)
    assert (np.bincount(idx[idx >= 0], minlength=plan.nv) == 1).all()
    dotp_tiles(plan)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cfg", DOTP_SPACE,
                         ids=lambda c: f"s{c.streams}u{c.unroll}k{c.block_k}")
def test_dotp_plan_covers_2_27_once(itemsize, cfg):
    """2^27 elements (256 or 512 MB an operand), counted by the plan's
    arithmetic: past a wave, one wave of blocks strides over the steps."""
    from repro_torch.kernels.dotp import dotp_plan
    plan = dotp_plan(1 << 27, itemsize, cfg, SMS)
    assert plan.steps > plan.blocks
    dotp_tiles(plan)


def test_dotp_plan_at_the_smoke_sizes():
    """The registry's space is the JAX one; at the default (2 parts,
    unroll 1, 512 elements a block-step) 2^20 bf16 is 1,024 blocks of 64
    threads, a step each, and 2^27 bf16 strides 131,072 steps over 4,224
    blocks; at 2^20 every candidate takes one step a block."""
    from repro_torch.kernels.dotp import dotp_plan
    spec = REGISTRY["dotp"]
    assert spec.space == {"streams": (1, 2), "unroll": (1, 2, 4),
                          "block_k": (256, 512, 1024)}
    assert len(DOTP_SPACE) == 18
    small, large = (dotp_plan(n, 2, spec.default, SMS) for n in DOTP_SMOKE)
    assert (small.threads, small.vpt, small.part, small.steps,
            small.blocks) == (64, 1, 1 << 16, 1024, 1024)
    assert (large.threads, large.vpt, large.part, large.steps,
            large.blocks) == (64, 1, 1 << 23, 131072, 4224)
    for cfg in DOTP_SPACE:
        plan = dotp_plan(DOTP_SMOKE[0], 2, cfg, SMS)
        assert plan.steps == plan.blocks


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [4096, 65536])
def test_dotp_order_matches_the_jax_oracle_and_pallas(n, dtype):
    """The kernel's summation order (``dotp_emulate``) at every candidate
    on 132 SMs, within 1e-5 of sum |x_i y_i| (the smoke's gate) of the JAX
    oracle and of the interpret-mode Pallas ``dotp`` at both streams."""
    import jax.numpy as jnp
    from repro.core.troop import TroopConfig
    from repro.kernels import ops as JK
    from repro.kernels import ref as JR
    from repro_torch.kernels.dotp import dotp_plan
    rng = np.random.default_rng(40)
    x, y = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(getattr(torch, dtype)).float().numpy() for _ in range(2))
    xj, yj = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, y))
    gate = 1e-5 * float(np.abs(x.astype(np.float64) * y).sum())
    wants = [float(JR.dotp(xj, yj))] + [
        float(JK.dotp(xj, yj, TroopConfig(streams=s, interpret=True)))
        for s in (1, 2)]
    itemsize = 2 if dtype == "bfloat16" else 4
    for cfg in DOTP_SPACE:
        got = float(dotp_emulate(x, y, dotp_plan(n, itemsize, cfg, SMS)))
        for want in wants:
            assert abs(got - want) <= gate, (cfg, got, want)


@pytest.mark.parametrize("n", [4096, 65536 + 8])
def test_dotp_order_is_the_exact_sum_rounded_in_stages(n):
    """bf16 products are exact in fp32: the emulation's sum is within the
    fp32 rounding of its stages of the float64 sum, and matches the plain
    version (``ref.dotp``) within the gate at every candidate."""
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels.dotp import dotp_plan
    rng = np.random.default_rng(41)
    xt, yt = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .bfloat16() for _ in range(2))
    x, y = xt.float().numpy(), yt.float().numpy()
    exact = float((x.astype(np.float64) * y).sum())
    mass = float(np.abs(x.astype(np.float64) * y).sum())
    plain = float(TR.dotp(xt, yt))
    for cfg in DOTP_SPACE:
        got = float(dotp_emulate(x, y, dotp_plan(n, 2, cfg, SMS)))
        assert abs(got - exact) <= 1e-5 * mass
        assert abs(got - plain) <= 1e-5 * mass
