"""Cycle-level model of the Spatz VPE — the paper-faithful reproduction.

Simulates the micro-architecture the paper describes, at beat granularity
(1 beat = F=4 64-bit elements = one cycle of unit throughput):

  * VRF: 4 banks, 3R/1W; the write-port arbitration is where the paper's
    structural conflicts live.  Register group g starts at bank (2g) mod 4
    (standard layout, §IV-D); beat b of group g hits bank (start+b) mod 4.
  * VFU: 1 beat/cycle, read->write latency LAT=3 (2-cycle FPU + writeback).
  * VLSU: total ``mem_beats_per_cycle`` beats/cycle of TCDM bandwidth.
      - Spatz_BASELINE: one interface, 1 beat/cycle.
      - Spatz_2xBW:     one *wide* interface, 2 consecutive beats/cycle
        (the 2-banks/cycle write stride of Fig. 2a).
      - TROOP:          two decoupled interfaces, each 1 beat/cycle on a
        contiguous half of every access (§IV-A).
  * Chaining: 1-bit credit (consumer sees the committed frontier with a
    1-cycle lag, single frontier) vs. TROOP per-interface completion
    counters — the consumer can use both halves' frontiers (§IV-B).
  * Write arbitration: static VFU>VLSU (baseline) vs. dynamic VLSU-first
    with a 2-entry shadow buffer absorbing VFU writes (§IV-C).
  * TCDM: for LMUL>=4 the two decoupled interfaces hit the same bank group
    unless address scrambling offsets the rows (§IV-E): modeled as the
    interfaces alternating (half throughput) when unscrambled.
  * Reductions: linear (1 element/cycle) vs. log2 steps x LAT (§IV-G).

FPU utilization = VFU busy beats / total cycles — the quantity of Fig. 5.

A copy of the JAX package's ``repro/core/perfmodel.py`` (framework-free:
dataclasses only), kept here so the port imports nothing of the JAX
package; ``repro_torch.tune.search`` reads it to rank candidates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

F = 4                    # FPUs (64-bit lanes)
VRF_BANKS = 4
LAT = 3                  # VFU read->write latency
ELEMS_PER_INSTR = 64     # LMUL=8 x VLEN512 / 64-bit
BEATS_PER_INSTR = ELEMS_PER_INSTR // F      # 16


@dataclass(frozen=True)
class SpatzConfig:
    name: str
    mem_beats_per_cycle: int = 1
    decoupled: bool = False          # TROOP (A): two half-interfaces
    completion_chaining: bool = False  # TROOP (B)
    dynamic_priority: bool = False   # TROOP (C) + shadow buffer
    shadow_depth: int = 2
    scrambling: bool = False         # TROOP (E)
    log2_reduction: bool = False     # TROOP (G)
    issue_overhead: int = 2          # dispatch rate (cycles/instr, in order)
    # Scalar-core serialization per strip (address setup, loop control,
    # offload handshakes) — NOT itemized in the paper; calibrated ONCE on
    # DOTP@4096 against Fig. 5 and then held fixed for all other kernels
    # and vector lengths (see benchmarks/fig5_utilization.py for the
    # validation deltas).  TROOP's restructured software (unrolling /
    # software pipelining, §IV-F) hides it.
    sw_strip_overhead: int = 0


BASELINE = SpatzConfig("Spatz_BASELINE", mem_beats_per_cycle=1,
                       sw_strip_overhead=14)
BW2X = SpatzConfig("Spatz_2xBW", mem_beats_per_cycle=2,
                   sw_strip_overhead=6)
# NOTE shadow_depth=3: the paper's RTL arbiter absorbs the worst-case
# two-interface collision with 2 entries; our FIFO-drain discipline needs
# one more slot of slack to reach the same steady state (documented delta).
BW2X_TROOP = SpatzConfig(
    "Spatz_2xBW_TROOP", mem_beats_per_cycle=2, decoupled=True,
    completion_chaining=True, dynamic_priority=True, scrambling=True,
    log2_reduction=True, shadow_depth=3)
CONFIGS = {c.name: c for c in (BASELINE, BW2X, BW2X_TROOP)}


@dataclass
class Instr:
    kind: str                        # vle | vse | vfu | vred
    beats: int
    reg: int
    deps: List["Instr"] = field(default_factory=list)
    reads: List[int] = field(default_factory=list)   # source register ids
    war: List["Instr"] = field(default_factory=list) # prior readers of dst
    big_lmul: bool = True            # LMUL>=4 (TCDM conflict relevant)
    # state
    committed: int = 0               # total beats committed
    lo: int = 0                      # committed in [0, split)
    hi: int = 0                      # committed in [split, beats)
    issued: int = 0                  # VFU beats entered the pipe
    issued_lo: int = 0               # VLSU beats issued per half
    issued_hi: int = 0
    strip_leader: bool = False       # first memory op of a strip
    busy_frac: float = 1.0           # FPU-busy fraction (vred: slides idle)
    start: int = -1                  # dispatch-ready cycle
    done: bool = False

    @property
    def split(self) -> int:
        return (self.beats + 1) // 2

    def bank(self, b: int) -> int:
        return ((2 * self.reg) + b) % VRF_BANKS

    def frontier(self, completion: bool) -> int:
        """Usable leading-prefix beats for an in-order consumer."""
        if not completion:
            # single-frontier credit chaining: prefix only
            return self.lo if self.lo < self.split else self.split + self.hi
        if self.lo >= self.split:
            return self.split + self.hi
        return self.lo

    def commit(self, b: int):
        self.committed += 1
        if b < self.split:
            self.lo += 1
        else:
            self.hi += 1


@dataclass
class SimResult:
    cycles: int
    fpu_busy: int
    stalls: Dict[str, int]

    @property
    def fpu_util(self) -> float:
        return self.fpu_busy / max(self.cycles, 1)


class Spatz:
    """Two in-order units (VLSU, VFU) + bank-arbitrated VRF writes.

    TROOP adds: per-half completion chaining, a write buffer on the VLSU1
    path and a shadow buffer on the VFU path (paper §IV-B/C)."""

    def __init__(self, cfg: SpatzConfig):
        self.cfg = cfg

    @staticmethod
    def wire_hazards(program: List[Instr]):
        """Attach WAR dependencies: a write to reg r must not overtake
        earlier readers of r (per-beat, credit-style — paper §III-D)."""
        for i, ins in enumerate(program):
            ins.war = []
            for j in range(i - 1, -1, -1):
                prev = program[j]
                if prev.reg == ins.reg and prev.kind in ("vle", "vfu"):
                    break                      # previous writer: WAW barrier
                if ins.reg in prev.reads:
                    ins.war.append(prev)
        return program

    def run(self, program: List[Instr]) -> SimResult:
        cfg = self.cfg
        self.wire_hazards(program)
        dispatch_at = {id(ins): k * cfg.issue_overhead
                       for k, ins in enumerate(program)}
        mem_q = [i for i in program if i.kind in ("vle", "vse")]
        vfu_q = [i for i in program if i.kind in ("vfu", "vred")]
        mi = fi = 0                      # issue pointers
        cycle = 0
        fpu_busy = 0
        stalls = {"vrf": 0, "chain": 0, "tcdm": 0, "shadow": 0}
        pipe: List[Tuple[int, Instr, int]] = []      # VFU writebacks
        shadow: List[Tuple[Instr, int]] = []         # VFU write buffer (C)
        v1buf: List[Tuple[Instr, int]] = []          # VLSU1 write buffer (C)
        retry: List[Tuple[Instr, int, int]] = []     # static-priority losers
        remaining = len(program)

        def avail_ok(dep: Instr, b: int) -> bool:
            if cfg.completion_chaining:
                if b < dep.split:
                    return b < dep.lo
                return (b - dep.split) < dep.hi
            return b < dep.frontier(False)

        def war_ok(ins: Instr, b: int) -> bool:
            for rdr in ins.war:
                done_reads = rdr.issued if rdr.kind in ("vfu", "vred") \
                    else rdr.issued_lo + rdr.issued_hi
                if done_reads <= b and done_reads < rdr.beats:
                    return False
            return True

        for cycle in range(1, 2_000_000):
            if remaining == 0:
                break
            writes: List[Tuple[str, Instr, int]] = []

            # ----- VLSU issue ------------------------------------------------
            m = mem_q[mi] if mi < len(mem_q) else None
            if m is not None and cycle < dispatch_at[id(m)]:
                m = None
            if m is not None and m.strip_leader and m.start < 0:
                m.start = cycle + cfg.sw_strip_overhead
            if m is not None and m.start > 0 and cycle < m.start:
                m = None
            if retry:
                for (ri, rb, itf) in retry:
                    writes.append((f"vlsu{itf}", ri, rb))
                retry = []
            elif m is not None:
                if cfg.decoupled:
                    conflict = (not cfg.scrambling) and m.big_lmul
                    use_ifs = [cycle % 2] if conflict else [0, 1]
                    if conflict:
                        stalls["tcdm"] += 1
                    for itf in use_ifs:
                        if itf == 1 and len(v1buf) >= cfg.shadow_depth:
                            stalls["shadow"] += 1
                            continue
                        if itf == 0 and m.issued_lo < m.split:
                            b = m.issued_lo
                        elif itf == 1 and m.issued_hi < m.beats - m.split:
                            b = m.split + m.issued_hi
                        else:
                            continue
                        if m.kind == "vse":
                            if all(avail_ok(d, b) for d in m.deps):
                                writes.append((f"vse{itf}", m, b))
                            else:
                                stalls["chain"] += 1
                        elif war_ok(m, b):
                            writes.append((f"vlsu{itf}", m, b))
                        else:
                            stalls["chain"] += 1
                else:
                    for k in range(cfg.mem_beats_per_cycle):
                        b = m.issued_lo + m.issued_hi + k
                        if b >= m.beats:
                            break
                        if m.kind == "vse":
                            if all(avail_ok(d, b) for d in m.deps):
                                writes.append(("vse0", m, b))
                            else:
                                stalls["chain"] += 1
                                break
                        elif war_ok(m, b):
                            writes.append(("vlsu0", m, b))
                        else:
                            stalls["chain"] += 1
                            break
            # mark issued now (they either commit, buffer, or enter retry)
            for (src, inst, b) in writes:
                if src.startswith(("vlsu", "vse")):
                    if b < inst.split:
                        inst.issued_lo = max(inst.issued_lo, b + 1)
                    else:
                        inst.issued_hi = max(inst.issued_hi,
                                             b - inst.split + 1)
            if m is not None and m.issued_lo + m.issued_hi >= m.beats:
                mi += 1

            # ----- VFU issue -------------------------------------------------
            f = vfu_q[fi] if fi < len(vfu_q) else None
            if f is not None and cycle < dispatch_at[id(f)]:
                f = None
            if f is not None:
                b = f.issued
                if f.kind == "vred":
                    ready = all(d.committed >= d.beats for d in f.deps)
                else:
                    ready = all(avail_ok(d, b) for d in f.deps) and \
                        war_ok(f, b)
                if not ready:
                    stalls["chain"] += 1
                elif cfg.dynamic_priority and len(shadow) >= cfg.shadow_depth:
                    stalls["shadow"] += 1
                else:
                    f.issued += 1
                    fpu_busy += f.busy_frac
                    pipe.append((cycle + LAT, f, b))
                    if f.issued >= f.beats:
                        fi += 1            # pipelined back-to-back issue

            # ----- VRF write arbitration ------------------------------------
            due = [(inst, b) for (t, inst, b) in pipe if t <= cycle]
            pipe = [(t, inst, b) for (t, inst, b) in pipe if t > cycle]
            reqs: Dict[int, List[Tuple[str, Instr, int]]] = {}
            # buffers offer one entry per distinct bank (independent writes)
            offered = set()
            for qi, (inst, b) in enumerate(v1buf):
                bank = inst.bank(b)
                if bank not in offered:
                    offered.add(bank)
                    reqs.setdefault(bank, []).append(("v1buf", inst, b))
            offered = set()
            for qi, (inst, b) in enumerate(shadow):
                bank = inst.bank(b)
                if bank not in offered:
                    offered.add(bank)
                    reqs.setdefault(bank, []).append(("shadow", inst, b))
            for inst, b in due:
                reqs.setdefault(inst.bank(b), []).append(("vfu", inst, b))
            for (src, inst, b) in writes:
                if src.startswith("vse"):
                    inst.commit(b)           # memory-side write, no VRF port
                    if inst.committed == inst.beats:
                        remaining -= 1
                    continue
                reqs.setdefault(inst.bank(b), []).append((src, inst, b))

            if cfg.dynamic_priority:
                prio = {"vlsu0": 0, "v1buf": 1, "vlsu1": 2, "shadow": 3,
                        "vfu": 4}
            else:
                prio = {"vfu": 0, "shadow": 1, "vlsu0": 2, "v1buf": 3,
                        "vlsu1": 4}
            new_retry: List[Tuple[Instr, int, int]] = []
            for bank, cand in reqs.items():
                cand.sort(key=lambda r: prio[r[0]])
                src, inst, b = cand[0]
                if src == "shadow":
                    shadow.remove((inst, b))
                elif src == "v1buf":
                    v1buf.remove((inst, b))
                inst.commit(b)
                if inst.committed == inst.beats:
                    remaining -= 1
                if len(cand) > 1:
                    stalls["vrf"] += len(cand) - 1
                for src2, inst2, b2 in cand[1:]:
                    if src2 == "vfu":
                        if cfg.dynamic_priority and \
                                len(shadow) < cfg.shadow_depth:
                            shadow.append((inst2, b2))
                        else:
                            pipe.append((cycle + 1, inst2, b2))
                    elif src2 == "vlsu1" and cfg.dynamic_priority:
                        v1buf.append((inst2, b2))   # buffered, no stall
                    elif src2.startswith("vlsu"):
                        itf = int(src2[-1])
                        new_retry.append((inst2, b2, itf))
                        # interface stalls: roll the issue pointer back
                        if b2 < inst2.split:
                            inst2.issued_lo = min(inst2.issued_lo, b2 + 1)
                        else:
                            inst2.issued_hi = min(inst2.issued_hi,
                                                  b2 - inst2.split + 1)
                    # shadow/v1buf losers stay queued
            retry = new_retry

        return SimResult(cycle, fpu_busy, stalls)

# --------------------------------------------------------------------------
# Kernel micro-programs (strip-mined, LMUL=8)
# --------------------------------------------------------------------------
def _red_cost(cfg: SpatzConfig, elems: int = ELEMS_PER_INSTR):
    """(cycles, fpu_busy_fraction) of the final reduction.

    log2 (TROOP, §IV-G): ceil(log2(e)) slide+vfadd steps; each step costs a
    register-length slide on the SLDU, the add, and the LAT drain — ~300
    cycles for 64 elements, mostly FPU-idle (this is what caps the paper's
    DOTP at 76% for VL=4096 and is amortized to 96% at long VL).
    linear: element-serial accumulate through the FPU pipe.
    """
    import math
    if cfg.log2_reduction:
        steps = max(int(math.ceil(math.log2(elems))), 1)
        cycles = steps * (2 * BEATS_PER_INSTR + 2 * LAT + 12)
        busy = steps * BEATS_PER_INSTR / 2
    else:
        cycles = elems * LAT + 2 * BEATS_PER_INSTR
        busy = elems / 4
    return cycles, busy / max(cycles, 1)


def prog_dotp(vl: int, cfg: SpatzConfig) -> List[Instr]:
    """x.y: per strip 2 loads + 1 chained vfmacc.

    Baseline/2xBW: LMUL=8 — the VRF holds only FOUR register groups, so
    x/y/acc reuse is forced and the next strip's loads carry WAR hazards.
    TROOP: software-pipelined at LMUL=4 (§IV-F) — 8 register groups allow
    double-buffered x/y, removing the WAR chain entirely."""
    prog: List[Instr] = []
    acc_dep: Optional[Instr] = None
    if cfg.decoupled:
        beats = BEATS_PER_INSTR // 2
        strips = max(vl // (ELEMS_PER_INSTR // 2), 1)
        for s in range(strips):
            gx, gy = (0, 1) if s % 2 == 0 else (2, 3)
            lx = Instr("vle", beats, reg=gx, strip_leader=(s % 8 == 0))
            ly = Instr("vle", beats, reg=gy)
            fm = Instr("vfu", beats, reg=4, deps=[lx, ly],
                       reads=[gx, gy, 4])
            prog += [lx, ly, fm]
            acc_dep = fm
    else:
        strips = max(vl // ELEMS_PER_INSTR, 1)
        for s in range(strips):
            lx = Instr("vle", BEATS_PER_INSTR, reg=0, strip_leader=True)
            ly = Instr("vle", BEATS_PER_INSTR, reg=1)
            fm = Instr("vfu", BEATS_PER_INSTR, reg=2, deps=[lx, ly],
                       reads=[0, 1, 2])
            prog += [lx, ly, fm]
            acc_dep = fm
    cyc, frac = _red_cost(cfg)
    prog.append(Instr("vred", cyc, reg=3, deps=[acc_dep], reads=[2],
                      busy_frac=frac))
    return prog


def prog_axpy(vl: int, cfg: SpatzConfig, unroll: int = 1) -> List[Instr]:
    """y <- a*x + y (x, y loaded; y stored).  unroll=2 (paper §IV-F) uses
    the other two register groups so the store no longer blocks the next
    strip's loads."""
    strips = max(vl // ELEMS_PER_INSTR, 1)
    prog: List[Instr] = []
    s = 0
    while s < strips:
        group = []
        for u in range(min(unroll, strips - s)):
            gx, gy = (0, 1) if u % 2 == 0 else (2, 3)
            lx = Instr("vle", BEATS_PER_INSTR, reg=gx,
                       strip_leader=(u == 0))
            ly = Instr("vle", BEATS_PER_INSTR, reg=gy)
            fm = Instr("vfu", BEATS_PER_INSTR, reg=gy, deps=[lx, ly],
                       reads=[gx, gy])
            group.append((lx, ly, fm))
        for lx, ly, fm in group:
            prog += [lx, ly]
        for lx, ly, fm in group:
            prog.append(fm)
        for lx, ly, fm in group:
            prog.append(Instr("vse", BEATS_PER_INSTR, reg=fm.reg,
                              deps=[fm], reads=[fm.reg]))
        s += unroll
    return prog


def prog_gemv(rows: int, cols: int, cfg: SpatzConfig) -> List[Instr]:
    """y = W x, vectorized over rows (column tiles streamed, x broadcast
    from the scalar FPR): one vle + one chained vfmacc per column tile;
    W buffers double-buffer across groups 0/1, accumulator in group 2."""
    strips = max(rows // ELEMS_PER_INSTR, 1)
    prog: List[Instr] = []
    for s in range(strips):
        last = None
        for j in range(cols):
            gw = j % 2
            lw = Instr("vle", BEATS_PER_INSTR, reg=gw,
                       strip_leader=(j % 4 == 0))
            fm = Instr("vfu", BEATS_PER_INSTR, reg=2, deps=[lw],
                       reads=[gw, 2])
            prog += [lw, fm]
            last = fm
        prog.append(Instr("vse", BEATS_PER_INSTR, reg=2, deps=[last],
                          reads=[2]))
    return prog


def prog_gemm(n: int, cfg: SpatzConfig, reuse: int = 8) -> List[Instr]:
    """Tiled GEMM at LMUL=4 (8 register groups): streamed tiles double-
    buffer while ``reuse`` chained vfmaccs amortize each load (high OI)."""
    beats = BEATS_PER_INSTR // 2
    strips = max(n // (ELEMS_PER_INSTR // 2), 1)
    prog: List[Instr] = []
    for s in range(strips):
        gw = s % 2
        lw = Instr("vle", beats, reg=gw, strip_leader=(s % 4 == 0))
        prog.append(lw)
        for r in range(reuse):
            prog.append(Instr("vfu", beats, reg=2 + r % 6, deps=[lw],
                              reads=[gw, 2 + r % 6]))
    return prog


def prog_fft(n: int, cfg: SpatzConfig) -> List[Instr]:
    """Butterfly stages at LMUL=4: 2 loads + 2 flops + 2 stores per pair."""
    import math
    beats = BEATS_PER_INSTR // 2
    stages = max(int(math.log2(max(n, 2))), 1)
    strips = max(n // (ELEMS_PER_INSTR // 2), 1)
    prog: List[Instr] = []
    for st in range(min(stages, 6)):
        for s in range(strips):
            g = (s % 2) * 4
            lx = Instr("vle", beats, reg=0 + g, strip_leader=True)
            ly = Instr("vle", beats, reg=1 + g)
            f1 = Instr("vfu", beats, reg=2 + g, deps=[lx, ly],
                       reads=[0 + g, 1 + g])
            f2 = Instr("vfu", beats, reg=3 + g, deps=[lx, ly],
                       reads=[0 + g, 1 + g])
            sv = Instr("vse", beats, reg=2 + g, deps=[f1], reads=[2 + g])
            sv2 = Instr("vse", beats, reg=3 + g, deps=[f2], reads=[3 + g])
            prog += [lx, ly, f1, f2, sv, sv2]
    return prog


KERNELS = {
    "dotp": lambda cfg, vl=4096: prog_dotp(vl, cfg),
    "axpy": lambda cfg, vl=4096: prog_axpy(
        vl, cfg, unroll=2 if cfg.decoupled else 1),
    "gemv": lambda cfg, vl=4096: prog_gemv(256, 64, cfg),
    "gemm": lambda cfg, vl=4096: prog_gemm(4096, cfg),
    "fft": lambda cfg, vl=4096: prog_fft(1024, cfg),
}


def utilization(kernel: str, cfg: SpatzConfig, vl: int = 4096) -> SimResult:
    prog = KERNELS[kernel](cfg, vl)
    return Spatz(cfg).run(prog)


def figure5(vl: int = 4096) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for kname in KERNELS:
        out[kname] = {}
        for cname, cfg in CONFIGS.items():
            out[kname][cname] = utilization(kname, cfg, vl).fpu_util
    return out
