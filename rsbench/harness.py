"""One run of one cell: set-up, the measured window, the check.

Set-up makes the graph on the device from the seed, bulk-loads the store
(``RapidStore.from_edges``), builds the cold views and warms every query
kind of the mix once; a mix with a writer also commits a few warm-up
transactions and queries each spliced view, so the splice path is warm.

The window runs for ``seconds``: reader clients in a closed loop, each
pinning a fresh snapshot per query (``store.begin_read``), running it and
waiting for its answer on the device, then ``end_read``; and a writer
that offers transactions on a schedule (open loop, timed from when each
was due) through ``store.apply``.  Every query issued in the window is
waited for.

A sample of the queries drawn from the seed over the whole window, every
query whose view was assembled anew and each client's query in flight at
the close keep their answers.  After the window the final view is pinned
and fingerprinted, the device peak is read, the program's state is
freed, and the plain reference judges what was kept
(:mod:`rsbench.reference.judge`).

A query kind that a mix names is one of the six built into
:mod:`rsbench.queries`, or a file ``rsbench/kinds/<name>.py``
(:class:`FileKind`; what the file defines is in
:func:`rsbench.spec.kind_module`).  Adding a kind adds that file and
edits nothing here: the kind's optional ``prepare`` runs in set-up, the
client draws the query's operands from the seed before the read's clock
starts, the check takes the fingerprint the
kind's ``USES`` names beside what its ``capture`` keeps, and the judge
adds the kind's ``NUMBERS``, held to their limits, to the run's result
only where the mix names the kind.
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import gen, queries, spec, traceread, yardstick
from .reference import judge as judge_mod

PLAN_LENGTH = 1 << 14  # queries a client may issue: far above any window


def now() -> float:
    return time.perf_counter()


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class State:
    """What set-up made, handed to the window and the check."""

    cell: spec.Cell
    seed: int
    device: torch.device
    store: object
    base_keys: torch.Tensor
    ctx: dict  # the queries' operands and settings
    plans: List[list]
    check_pos: List[List[int]]
    txns: List[tuple]  # (inserts, deletes) not yet offered
    acked: List[tuple] = field(default_factory=list)  # (commit ts, inserts, deletes)
    setup: Dict[str, float] = field(default_factory=dict)
    profile: Optional[traceread.DeviceProfile] = None
    tile_groups: List[dict] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------
class FileKind:
    """A query kind defined by its own file (:func:`spec.kind_module`); in
    the control it runs the file's ``control``, which reads the view's
    COO."""

    def __init__(self, module, control: bool) -> None:
        self.module = module
        self.uses = "coo" if control else module.USES
        self.run = module.control if control else module.run


def _kind_table(cell: spec.Cell, control: bool) -> Dict[str, object]:
    """The mix's kinds by name: the built-in ones and the kind files."""
    table = queries.CONTROL if control else queries.KINDS
    out, unknown = {}, []
    for name in cell.traffic["kinds"]:
        has_file = spec.kind_path(name, cell.root).is_file()
        if name in table and has_file:
            raise KeyError(f"query kind {name!r} is both built in and a file")
        if name in table:
            out[name] = table[name]
        elif has_file:
            out[name] = FileKind(spec.kind_module(name, cell.root), control)
        else:
            unknown.append(name)
    if unknown:
        raise KeyError(f"unknown query kinds {sorted(unknown)}; known: {sorted(table)} "
                       f"and the files of rsbench/kinds/")
    return out


def file_kinds(cell: spec.Cell) -> Dict[str, object]:
    """The modules of the mix's kind files, by name."""
    return {name: k.module for name, k in _kind_table(cell, False).items()
            if isinstance(k, FileKind)}


def _operands(kind, ctx: dict, root: int):
    """What the query takes: a kind file's operands drawn from the seed and
    the plan's ``root``; a built-in kind's root itself."""
    return kind.module.draw(ctx, root) if isinstance(kind, FileKind) else root


def _capture(kind, view, answer, ctx: dict, ops, control: bool) -> dict:
    if not isinstance(kind, FileKind):
        return queries.capture(kind, view, answer, ctx, control)
    if kind.uses == "coo":
        out = {"coo_fp": queries.coo_fingerprint(view)}
    else:
        out = {"tiles_fp": queries.tiles_fingerprint(view.to_leaf_blocks_device())}
    out.update(kind.module.capture(view, answer, ctx, ops))
    return out


def _store_kwargs(config: dict) -> dict:
    s = config["store"]
    tiers = s.get("leaf_tiers") or [s["B"]]  # explicit: no setting of the environment applies
    return {"partition_size": int(s["partition_size"]), "B": int(s["B"]),
            "leaf_tiers": [int(t) for t in tiers]}


def tile_stats(blocks) -> List[dict]:
    """Each tile group's sizes for the kernels' bounds: tiles, live ids,
    bytes of their live sectors, distinct ids."""
    out = []
    for _src, rows, length in queries.tile_groups(blocks):
        live = torch.arange(rows.shape[1], device=rows.device)[None, :] < length.long()[:, None]
        out.append({"n_tiles": int(rows.shape[0]), "width": int(rows.shape[1]),
                    "live": int(length.long().sum()),
                    "sector_bytes": yardstick.live_sector_bytes(length),
                    "distinct": int(torch.unique(rows[live]).numel())})
        del live
    return out


def setup(cell: spec.Cell, seed: int, device: torch.device, trace: bool,
          n_windows: int = 1, seconds: float = 0.0, control: bool = False) -> State:
    """Everything before the window; ``seconds`` sizes the writer's
    transactions for ``n_windows`` windows."""
    from repro_torch.core import RapidStore

    cfg, traffic = cell.config, cell.traffic
    times: Dict[str, float] = {}
    t = now()
    edges, base_keys = gen.base_graph(cfg, seed, device)
    sync(device)
    times["generate_s"] = now() - t

    t = now()
    n = 1 << int(cfg["scale"])
    host_edges = edges.cpu().numpy()
    del edges
    store = RapidStore.from_edges(n, host_edges, device=device, **_store_kwargs(cfg))
    del host_edges
    times["build_s"] = now() - t

    t = now()
    ops = gen.operands(n, int(traffic.get("spmm_d", 0)), seed, device)
    rng = np.random.default_rng(gen.subseed(seed, 6))
    ctx = {"seed": int(seed), "n": n, "pagerank_iters": int(traffic.get("pagerank_iters", 0)),
           "x": ops["x"], "H": ops["H"], "config": cfg, "traffic": traffic,
           "base_keys": base_keys, "device": device}
    srcs = (base_keys >> 32)
    heaviest = int(torch.bincount(srcs, minlength=n).argmax())
    k = min(n, int(traffic["check"].get("spmm_rows", 0)))
    rows = np.union1d(rng.choice(n, size=k, replace=False), [heaviest])
    ctx["spmm_rows"] = torch.from_numpy(rows.astype(np.int64)).to(device)
    del srcs
    for mod in file_kinds(cell).values():
        if hasattr(mod, "prepare"):
            mod.prepare(ctx)
    plans = gen.client_plans(traffic, base_keys, seed, PLAN_LENGTH)
    every = int(traffic["check"]["every"])
    check_pos = [gen.check_positions(p, every, rng) for p in plans]
    writer = traffic.get("writer")
    txns: List[tuple] = []
    if writer:
        per_window = int(math.ceil(seconds * float(writer["rate_per_s"]))) + 1
        txns = gen.transactions(cfg, writer, base_keys,
                                int(writer["warm_commits"]) + n_windows * per_window, seed)
    sync(device)
    times["operands_s"] = now() - t

    state = State(cell=cell, seed=seed, device=device, store=store, base_keys=base_keys,
                  ctx=ctx, plans=plans, check_pos=check_pos, txns=txns)
    kinds = _kind_table(cell, control)

    # the cold views and every kind once (the kernels load or build here)
    t = now()
    _warm(state, kinds)
    times["cold_views_s"] = now() - t
    if writer:
        t = now()
        for _ in range(int(writer["warm_commits"])):
            ins, dels = state.txns.pop(0)
            state.acked.append((int(store.apply(ins, dels)), ins, dels))
            _warm(state, kinds)
        times["warm_commits_s"] = now() - t
    if trace:
        t = now()
        h = store.begin_read()
        try:
            if any(k.uses == "tiles" for k in queries.KINDS.values() if k.name in kinds):
                state.tile_groups = tile_stats(h.view.to_leaf_blocks_device())
        finally:
            store.end_read(h)
        state.profile = traceread.DeviceProfile(device)
        state.profile.warm(lambda: (torch.ones(8, device=device) * 2).sum().item())
        times["trace_setup_s"] = now() - t
    gc.collect()
    sync(device)
    state.setup = times
    return state


def _warm(state: State, kinds: Dict[str, queries.Kind]) -> None:
    """Each kind once on a fresh pin, its answer waited for."""
    store = state.store
    for name, kind in kinds.items():
        h = store.begin_read()
        try:
            root = next(r for k, r in state.plans[0] if k == name)
            kind.run(h.view, state.ctx, _operands(kind, state.ctx, root))
            sync(state.device)
        finally:
            store.end_read(h)


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------
@dataclass
class Window:
    t0: float
    t_end: float
    t_closed: float
    reads: List[dict]
    writes: List[dict]
    checks: List[dict]
    trace: Optional[traceread.Trace] = None
    host: List[tuple] = field(default_factory=list)  # (label, start ns, end ns)
    breakdown: Optional[dict] = None


def _pred_ids(view) -> tuple:
    """Ids of the predecessor bundle's device arrays, to tell afterwards
    whether this query assembled anew (no strong reference is kept)."""
    ref = getattr(view, "_pred", None)
    pred = ref() if ref is not None else None
    if pred is None:
        return None, None
    return id(pred.dev_coo), id(pred.dev_blocks)


def _assembled(view, before: tuple) -> bool:
    a = getattr(view, "assembly", None)
    if a is None:
        return False
    coo, blocks = before
    return ((a.dev_coo is not None and id(a.dev_coo) != coo)
            or (a.dev_blocks is not None and id(a.dev_blocks) != blocks))


def window(state: State, seconds: float, trace: bool, control: bool = False) -> Window:
    """The measured window, and a wait for every query issued in it."""
    store, device, ctx = state.store, state.device, state.ctx
    traffic = state.cell.traffic
    kinds = _kind_table(state.cell, control)
    writer = traffic.get("writer")
    reads: List[dict] = []
    writes: List[dict] = []
    checks: List[dict] = []
    host: List[tuple] = []
    errors: List[str] = []

    def client(ci: int) -> None:
        plan, check_at = state.plans[ci], set(state.check_pos[ci])
        for i, (name, root) in enumerate(plan):
            kind = kinds[name]
            ops = _operands(kind, ctx, root)  # before the read's clock
            t_issue = now()
            if t_issue >= t_end:
                return
            rec = {"client": ci, "i": i, "kind": name, "t_issue": t_issue, "ts": None,
                   "t_done": None, "latency": math.inf, "assembled": False, "error": None}
            try:
                h = store.begin_read()
            except Exception as e:  # a boundary that must keep running: recorded
                rec["error"] = repr(e)
                reads.append(rec)
                continue
            t_release = 0.0
            try:
                rec["ts"] = int(h.ts)
                before = _pred_ids(h.view)
                answer = kind.run(h.view, ctx, ops)
                sync(device)
                rec["t_done"] = now()
                rec["assembled"] = _assembled(h.view, before)
                # the sample, every view assembled anew, and the query in
                # flight at the close
                if i in check_at or rec["assembled"] or rec["t_done"] >= t_end:
                    got = _capture(kind, h.view, answer, ctx, ops, control)
                    checks.append({"kind": name, "ts": rec["ts"], "root": root, "client": ci,
                                   "i": i, **got})
                    sync(device)
                    host.append(("check_capture", rec["t_done"] * 1e9, now() * 1e9))
                del answer
            except Exception as e:  # recorded; the query counts as failed
                rec["error"] = repr(e)
                errors.append(f"client {ci} query {i} {name}: {e!r}")
            finally:
                t = now()
                store.end_read(h)
                t_release = now() - t
            if rec["error"] is None:
                rec["latency"] = rec["t_done"] - t_issue + t_release
                host.append((name, t_issue * 1e9, rec["t_done"] * 1e9))
            reads.append(rec)

    def write_loop(pending: List[tuple]) -> None:
        rate = float(writer["rate_per_s"])
        for k, (ins, dels) in enumerate(pending):
            due = t0 + k / rate
            if due >= t_end:
                return
            wait = due - now()
            if wait > 0:
                time.sleep(wait)
            rec = {"k": k, "due": due, "t_start": now(), "ts": 0, "error": None}
            try:
                rec["ts"] = int(store.apply(ins, dels))
                state.acked.append((rec["ts"], ins, dels))
            except Exception as e:  # recorded; the write counts as failed
                rec["error"] = repr(e)
                errors.append(f"write {k}: {e!r}")
            rec["t_ack"] = now()
            host.append(("apply", rec["t_start"] * 1e9, rec["t_ack"] * 1e9))
            writes.append(rec)

    pending: List[tuple] = []
    if writer:
        per_window = int(math.ceil(seconds * float(writer["rate_per_s"]))) + 1
        pending, state.txns = state.txns[:per_window], state.txns[per_window:]
    threads = [threading.Thread(target=client, args=(ci,), name=f"reader-{ci}")
               for ci in range(int(traffic["clients"]))]
    if writer:
        threads.append(threading.Thread(target=write_loop, args=(pending,), name="writer"))
    counters_before = None
    if trace:
        counters_before = traceread.counter_values(_registries(store))
        gc.callbacks.append(_gc_timer(host))
        state.profile.start()
    t0 = now()
    t_end = t0 + seconds
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if trace:
        state.profile.stop()
        gc.callbacks.pop()
    t_closed = now()
    host.append(("window_closed", t_end * 1e9, t_closed * 1e9))
    for e in errors[:20]:
        log("error:", e)
    w = Window(t0=t0, t_end=t_end, t_closed=t_closed, reads=reads, writes=writes,
               checks=checks, host=host)
    if trace:
        w.trace, w.breakdown = _read_trace(state, w, counters_before, kinds)
    return w


def _gc_timer(host: list):
    """A ``gc.callbacks`` entry that records each collection as a host
    interval (a pause of every thread)."""
    started = {}

    def timer(phase, info):
        if phase == "start":
            started["t"] = now()
        elif "t" in started:
            host.append((f"gc_gen{info.get('generation')}", started.pop("t") * 1e9, now() * 1e9))

    return timer


def _registries(store) -> list:
    from repro_torch.obs.metrics import REGISTRY

    return [REGISTRY, store.registry]


def _kernel_bounds(state: State, w: Window, kinds: dict) -> Dict[str, List[float]]:
    """The least seconds of each kernel launch the window's queries made,
    by kernel, from the operands each sent (kind files with ``bounds``;
    drawn again from the seed and the plan), counted on a fresh pin after
    the window."""
    out: Dict[str, List[float]] = {}
    done = [r for r in w.reads if r["error"] is None and isinstance(kinds[r["kind"]], FileKind)
            and hasattr(kinds[r["kind"]].module, "bounds")]
    if not done:
        return out
    h = state.store.begin_read()
    try:
        for r in done:
            mod = kinds[r["kind"]].module
            ops = mod.draw(state.ctx, state.plans[r["client"]][r["i"]][1])
            for kernel, secs in mod.bounds(h.view, state.ctx, ops).items():
                out.setdefault(kernel, []).extend(secs)
    finally:
        state.store.end_read(h)
    return out


def _read_trace(state: State, w: Window, counters_before: dict, kinds: dict):
    prof = state.profile
    lo, hi = prof.t_start_ns, prof.t_stop_ns
    events = prof.events()
    spans = traceread.window_spans(lo, hi)
    host = list(w.host) + [(traceread.label(n, a), s, e) for n, s, e, a in spans]
    tr = traceread.Trace(
        window_s=(hi - lo) / 1e9,
        busy_s=traceread.busy_ns(events, lo, hi) / 1e9,
        device_events=events,
        spans=[(n, (e - s) / 1e9, a) for n, s, e, a in spans],
        counters=traceread.delta(traceread.counter_values(_registries(state.store)),
                                 counters_before),
        tile_groups=state.tile_groups,
        d=int(state.cell.traffic.get("spmm_d", 0)),
        bounds=_kernel_bounds(state, w, kinds),
    )
    breakdown = {"device_ops": traceread.top_ops(events),
                 "idle_gaps": traceread.idle_gaps(events, lo, hi, host)}
    return tr, breakdown


# ---------------------------------------------------------------------------
# What the window measured
# ---------------------------------------------------------------------------
def end_to_end(w: Window, seconds: float) -> Dict[str, float]:
    issued = [r for r in w.reads if r["t_issue"] < w.t_end]
    done = [r for r in issued if r["error"] is None and r["t_done"] <= w.t_end]
    out = {"read_p95_ms": yardstick.percentile([r["latency"] for r in issued], 95) * 1e3,
           "reads_per_s": yardstick.rate(len(done), seconds)}
    due = [t for t in w.writes if t["due"] < w.t_end]  # a failed write has ts 0: unseen
    if due:
        out["visibility_ms"] = yardstick.visibility(due, done, w.t_end) * 1e3
    return out


def read_line(w: Window) -> dict:
    """The readers' earlier line: counts, quantiles, splices, by kind."""
    issued = [r for r in w.reads if r["t_issue"] < w.t_end]
    lat = [r["latency"] * 1e3 for r in issued]
    by_kind = {}
    for name in sorted({r["kind"] for r in issued}):
        mine = [r["latency"] * 1e3 for r in issued if r["kind"] == name]
        by_kind[name] = {"n": len(mine), "p50_ms": yardstick.percentile(mine, 50),
                         "p95_ms": yardstick.percentile(mine, 95)}
    # assembled: the query's view spliced its COO or tiles after a commit, or
    # concatenated them whole where the newest retired bundle lacked them
    assembled = [r for r in issued if r["assembled"]]
    return {"line": "reads", "issued": len(issued),
            "completed_in_window": sum(1 for r in issued
                                       if r["error"] is None and r["t_done"] <= w.t_end),
            "failed": sum(1 for r in issued if r["error"] is not None),
            "p50_ms": yardstick.percentile(lat, 50), "p95_ms": yardstick.percentile(lat, 95),
            "p99_ms": yardstick.percentile(lat, 99),
            "assembled_share": len(assembled) / len(issued),
            "assembled_p50_ms": (yardstick.percentile([r["latency"] * 1e3 for r in assembled],
                                                      50) if assembled else None),
            "distinct_ts": len({r["ts"] for r in issued if r["ts"] is not None}),
            "by_kind": by_kind}


def write_line(w: Window) -> Optional[dict]:
    if not w.writes:
        return None
    late = [(t["t_start"] - t["due"]) * 1e3 for t in w.writes]
    commit = [(t["t_ack"] - t["t_start"]) * 1e3 for t in w.writes]
    return {"line": "writer", "offered": len(w.writes),
            "acked": sum(1 for t in w.writes if t["error"] is None),
            "lateness_ms_mean": sum(late) / len(late), "lateness_ms_max": max(late),
            "apply_ms_p50": yardstick.percentile(commit, 50),
            "apply_ms_max": max(commit)}


def final_view(state: State) -> dict:
    """The view pinned after the window: every acknowledged write must be
    in it, in its COO and its tiles alike."""
    uses = {k.uses for k in _kind_table(state.cell, False).values()}
    h = state.store.begin_read()
    try:
        out = {"kind": "final", "ts": int(h.ts), "answer": None}
        if "coo" in uses:
            out["coo_fp"] = queries.coo_fingerprint(h.view)
        if "tiles" in uses:
            out["tiles_fp"] = queries.tiles_fingerprint(h.view.to_leaf_blocks_device())
        sync(state.device)
    finally:
        state.store.end_read(h)
    return out


def check(state: State, w: Window, final: Optional[dict]) -> Dict[str, float]:
    """The judge's numbers for the window ``w``."""
    lost = sum(1 for r in w.reads if r["error"] is not None)
    # a write that failed, or that was acknowledged without a version (each
    # transaction deletes live edges, so a sound store always makes one)
    lost += sum(1 for t in w.writes if t["error"] is not None or not t["ts"])
    return judge_mod.judge(state.base_keys, state.acked, w.checks, state.ctx,
                           list(state.cell.traffic["kinds"]), lost, final,
                           files=file_kinds(state.cell))


def free_program(state: State) -> None:
    """Drop the store and everything it pinned on the device."""
    state.store = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float) -> dict:
    """One run: set-up, the window, the check; the result's fields and the
    earlier lines."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = setup(cell, seed, device, trace, seconds=seconds)
    setup_s = now() - t_process
    w = window(state, seconds, trace)
    final = final_view(state)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    free_program(state)
    t = now()
    numbers = check(state, w, final)
    limits = judge_mod.limits(file_kinds(cell))
    out = {
        "correct": judge_mod.verdict(numbers, limits),
        "attempted": sum(1 for r in w.reads if r["t_issue"] < w.t_end)
        + sum(1 for x in w.writes if x["due"] < w.t_end),
        "failed": sum(1 for r in w.reads if r["error"] is not None)
        + sum(1 for x in w.writes if x["error"] is not None),
        "numbers": numbers, "limits": limits, "peak": peak, "window": w,
        "setup": dict(state.setup, setup_s=setup_s, check_s=now() - t,
                      checks=len(w.checks)),
    }
    if trace:
        out["metrics"] = {m["name"]: m for m in cell.per_layer}
        out["trace"] = w.trace
    else:
        e2e = end_to_end(w, seconds)
        e2e["setup_s"] = setup_s
        out["e2e"] = e2e
    return out
