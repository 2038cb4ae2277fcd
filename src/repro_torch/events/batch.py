"""Vectorized batch replay: one wavefront over K records on a device.

``replay_batch`` replays many compiled ``StepProgram``s together, the
same discipline as ``repro_torch.dse.batched_sim``: the recurrence
advances in static topological LEVELS of the step DAG across ALL
records — no per-record Python in the recurrence.  Node spans and the DP
all-reduce use each program's steady-state rates (every sibling flow
active — the fair-share fixed point of a lockstep schedule).

The schedule structure is entirely static per (schedule, pp, v,
n_micro): ``_shape_tables`` compiles ``device_op_order`` +
``op_dependency`` once per shape into level-indexed integer tables.
Ops are layered by Kahn's algorithm over the op DAG (each device's
in-order slot chain plus the cross-device ``op_dependency`` edges), so
every dependency lands in a strictly earlier level and each (stage,
level) holds at most one op.  The tables, all ``(S, L)``:

  * ``ldir``    direction of the op a stage runs at each level
                (0=F, 1=B, -1=idle);
  * ``ldep_s``  the stage whose node END this op's START waits for
                (-1 = no cross dependency);
  * ``ldep_l``  the LEVEL that dependency completed at.

The recurrence is ``end[s, l] = max(dev_end[s], end[ldep_s, ldep_l])
+ tau`` for every schedule (``gpipe`` / ``1f1b`` / ``interleaved``).
``replay_rows`` stacks the batch's unique keys' tables on the device and
hands them, each record's key index and the (6, K) rows to
``repro_torch.kernels.wavefront``: one launch of the CUDA kernel on the
card (mixed keys included), the plain level loop on the CPU.  The
``scalar_fallback`` output key is kept, always ``False``, for schema
stability.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.events.dag import StepProgram, device_op_order, op_dependency
from repro_torch.kernels import wavefront
from repro_torch.models.common import check_device
from repro_torch.obs import metrics


# ---------------------------------------------------------------------------
# Static shape tables: schedule structure compiled once per shape
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=512)
def _shape_tables(schedule: str, pp: int, v: int, nm: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ldir, ldep_s, ldep_l), each (S, L) — see module docstring.

    Kahn layering: an op lands at level 1 + max(level of preds) where
    its preds are the previous slot on the same device and its
    ``op_dependency`` target.  Because the same-device chain is always
    an edge, levels are strictly increasing along each device's order,
    giving the at-most-one-op-per-(stage, level) property the dense
    recurrence relies on — and making the same-device predecessor
    always available as the running per-device end, so only the cross
    dependency needs an index.
    """
    orders = [device_op_order(schedule, pp, v, nm, s) for s in range(pp)]
    O = max(len(o) for o in orders)
    slot_of: Dict[Tuple[str, int, int, int], int] = {}
    for s, order in enumerate(orders):
        for i, (d, c, m) in enumerate(order):
            slot_of[(d, s, c, m)] = i

    dep_s = np.full((pp, O), -1, np.int32)
    dep_i = np.full((pp, O), -1, np.int32)
    for s, order in enumerate(orders):
        for i, (d, c, m) in enumerate(order):
            dep = op_dependency(d, s, c, m, pp, v)
            if dep is not None:
                dd, ds, dc, dm = dep
                dep_s[s, i] = ds
                dep_i[s, i] = slot_of[(dd, ds, dc, dm)]

    # Kahn layering over (in-order chain + cross-dep) edges
    def preds(s: int, i: int) -> List[Tuple[int, int]]:
        out = [(s, i - 1)] if i > 0 else []
        if dep_s[s, i] >= 0:
            out.append((int(dep_s[s, i]), int(dep_i[s, i])))
        return out

    n_ops = sum(len(o) for o in orders)
    indeg: Dict[Tuple[int, int], int] = {}
    succ: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for s, order in enumerate(orders):
        for i in range(len(order)):
            ps = preds(s, i)
            indeg[(s, i)] = len(ps)
            for p in ps:
                succ.setdefault(p, []).append((s, i))
    lvl = np.full((pp, O), -1, np.int32)
    q = deque(k for k, d in indeg.items() if d == 0)
    n_done = 0
    while q:
        s, i = q.popleft()
        n_done += 1
        lvl[s, i] = max((lvl[ps, pi] for ps, pi in preds(s, i)),
                        default=-1) + 1
        for nxt in succ.get((s, i), ()):
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                q.append(nxt)
    if n_done != n_ops:
        raise ValueError(
            f"cyclic op dependencies for schedule={schedule!r} "
            f"pp={pp} v={v} nm={nm} ({n_ops - n_done} ops unplaced)")

    L = int(lvl.max()) + 1
    ldir = np.full((pp, L), -1, np.int32)
    ldep_s = np.full((pp, L), -1, np.int32)
    ldep_l = np.full((pp, L), -1, np.int32)
    for s, order in enumerate(orders):
        for i, (d, _c, _m) in enumerate(order):
            lv = lvl[s, i]
            ldir[s, lv] = 0 if d == "F" else 1
            if dep_s[s, i] >= 0:
                ldep_s[s, lv] = dep_s[s, i]
                ldep_l[s, lv] = lvl[dep_s[s, i], dep_i[s, i]]
    for a in (ldir, ldep_s, ldep_l):
        a.setflags(write=False)
    return ldir, ldep_s, ldep_l


def _shape_key(p: StepProgram) -> Tuple[str, int, int, int]:
    return (p.schedule, p.n_stages, p.v, p.n_micro)


@functools.lru_cache(maxsize=64)
def _key_tables(shape_keys: Tuple[Tuple, ...]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (U, S, L) stacks of the unique keys' tables, padded to the
    batch maxima with -1 sentinels (table construction is paid once per
    shape, memoized); a record's tables are its key's row."""
    tabs = [_shape_tables(*key) for key in shape_keys]
    S = max(t[0].shape[0] for t in tabs)
    L = max(t[0].shape[1] for t in tabs)
    U = len(tabs)
    stacks = [np.full((U, S, L), -1, np.int32) for _ in range(3)]
    for u, tab in enumerate(tabs):
        for a, src in zip(stacks, tab):
            a[u, :src.shape[0], :src.shape[1]] = src
    for a in stacks:
        a.setflags(write=False)
    return tuple(stacks)


# ---------------------------------------------------------------------------
# replay_rows / replay_batch
# ---------------------------------------------------------------------------
def replay_rows(shape_keys: Sequence[Tuple], key_rows: np.ndarray,
                rows: np.ndarray, device="cuda"
                ) -> Dict[str, np.ndarray]:
    """Replay K pre-compiled record rows: ``rows`` is the (6, K)
    ``kernels.wavefront.ROW_KEYS`` matrix, ``shape_keys`` the batch's unique
    (schedule, pp, v, n_micro) keys and ``key_rows`` the per-record
    index into it.  This is the shared wavefront entry: ``replay_batch``
    extracts rows from ``StepProgram``s, ``events.compile_batch`` builds
    them vectorized without any programs.  The wavefront runs on
    ``device`` (a CUDA device that is not there raises).  Returns the
    SoA result dict (see ``replay_batch``)."""
    device = check_device(device)
    K = rows.shape[1]
    if K == 0:
        out = {k: np.zeros(0) for k in
               ("step_time", "makespan_body", "bubble", "dp_exposed",
                "analytic_step_time", "err")}
        out["scalar_fallback"] = np.zeros(0, bool)
        return out
    metrics.inc("batch_replay.records", K)
    metrics.inc("batch_replay.device_calls")
    tabs = [torch.tensor(t, device=device)
            for t in _key_tables(tuple(shape_keys))]
    res = wavefront.wavefront(
        *tabs, torch.tensor(np.asarray(key_rows, np.int32), device=device),
        torch.tensor(np.asarray(rows, np.float64), device=device))
    out = dict(zip(wavefront.RES_KEYS, res.cpu().numpy()))
    out["analytic_step_time"] = rows[5]
    out["scalar_fallback"] = np.zeros(K, bool)
    return out


def replay_batch(programs: Sequence[StepProgram],
                 device="cuda") -> Dict[str, np.ndarray]:
    """Replay K programs; returns SoA arrays over the batch:
    ``step_time``, ``makespan_body``, ``bubble``, ``dp_exposed``,
    ``analytic_step_time``, ``err``, plus a ``scalar_fallback`` bool
    mask kept for schema stability — always ``False`` now that every
    schedule (gpipe / 1f1b / interleaved) runs through the vectorized
    wavefront, which runs on ``device``."""
    K = len(programs)
    if K == 0:
        return replay_rows((), np.zeros(0, np.int64), np.zeros((6, 0)),
                           device=device)

    # Dedupe by object identity at C speed: bench batches and outer
    # rounds replay few unique programs many times, so all per-record
    # Python (span walks, attribute reads, shape keying) is paid once
    # per UNIQUE program.  Held references keep ids unique.
    ids = np.fromiter(map(id, programs), np.int64, count=K)
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    uprogs = [programs[int(i)] for i in first]
    urows = np.array([p.spans() + (p.n_micro * p.v,
                                   p.analytic.step_time if p.analytic
                                   else np.nan)
                      for p in uprogs])                 # (U, 6)
    key_of: Dict[Tuple, int] = {}
    ukey_idx = np.empty(len(uprogs), np.int64)
    for u, p in enumerate(uprogs):
        ukey_idx[u] = key_of.setdefault(_shape_key(p), len(key_of))
    shape_keys = list(key_of)
    key_rows = ukey_idx[inv]                            # (K,)
    rows = np.ascontiguousarray(urows[inv].T)           # (6, K)
    return replay_rows(shape_keys, key_rows, rows, device=device)
