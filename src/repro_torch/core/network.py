"""Rail-based OI network model (paper §IV-A, Fig 5b).

A rail dimension D_i = (N_i, R_i, S_i): S_i OCSs connect N_i MCMs, each
MCM contributing R_i links (k_i per OCS, S_i = floor(R_i/k_i)), under the
OCS port bound k_i * N_i <= P.  The full network interweaves rail
dimensions with  prod_i N_i = N  and  sum_i R_i <= L.  OCS count:
S = sum_i (prod_{j != i} N_j) * S_i.

Logical topologies (ring / fully-connected per parallelism) are configured
onto the physical rails by OCS (re)configuration; RailX and TPUv4 are
special cases with 2-3 uniform rail dimensions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hardware import HW, DEFAULT_HW
from repro_torch.core.mcm import MCMArch


@dataclass(frozen=True)
class RailDim:
    n: int              # N_i — MCMs per rail
    r: int              # R_i — links per MCM devoted to this dimension
    k: int = 1          # links per MCM per OCS

    @property
    def ocs_per_rail(self) -> int:
        return self.r // self.k     # S_i

    def port_ok(self, ports: int) -> bool:
        return self.k * self.n <= ports

    @property
    def bw_per_mcm(self) -> float:
        """Relative link count usable by traffic on this dimension."""
        return float(self.r)


@dataclass(frozen=True)
class OITopology:
    dims: Tuple[RailDim, ...]
    # parallelisms mapped onto each dim (multiple allowed — §IV-B);
    # entries are tuples like ("CP", "EP") when sharing/reusing a dim.
    mapping: Tuple[Tuple[str, ...], ...] = ()
    # link allocation per parallelism (l_p, §IV-B step 3)
    link_alloc: Dict[str, int] = field(default_factory=dict)
    reuse_pair: Optional[Tuple[str, str]] = None

    def n_mcm(self) -> int:
        out = 1
        for d in self.dims:
            out *= d.n
        return out

    def total_links_used(self) -> int:
        return sum(d.r for d in self.dims)

    def ocs_count(self) -> int:
        """S = sum_i (prod_{j!=i} N_j) * S_i."""
        total = 0
        n_all = self.n_mcm()
        for d in self.dims:
            rails_in_dim = n_all // d.n
            total += rails_in_dim * d.ocs_per_rail
        return total

    def validate(self, mcm: MCMArch, hw: HW = DEFAULT_HW,
                 n_mcm_expected: Optional[int] = None) -> List[str]:
        errs = []
        if n_mcm_expected is not None and self.n_mcm() != n_mcm_expected:
            errs.append(f"prod(N_i)={self.n_mcm()} != N={n_mcm_expected}")
        if self.total_links_used() > mcm.total_links:
            errs.append(f"sum(R_i)={self.total_links_used()} > "
                        f"L={mcm.total_links}")
        for i, d in enumerate(self.dims):
            if not d.port_ok(hw.ocs_ports):
                errs.append(f"dim{i}: k*N={d.k * d.n} > P={hw.ocs_ports}")
            if d.r < 1 or d.n < 2:
                errs.append(f"dim{i}: degenerate ({d.n},{d.r})")
        return errs


# ---------------------------------------------------------------------------
# Link allocation (paper §IV-B step 3 + Eq. 1)
# ---------------------------------------------------------------------------
def allocate_links(volumes: Dict[str, float], total_links: int,
                   reuse_pair: Optional[Tuple[str, str]] = None
                   ) -> Dict[str, int]:
    """l_p = floor(L * v_p / sum(v)); with dynamic reuse, the pair shares
    l_reuse = floor(L * max(v,v') / (sum(v_others) + max(v,v'))) links.
    Every parallelism with traffic gets at least one link."""
    inter = {p: v for p, v in volumes.items() if v > 0}
    if not inter:
        return {}
    alloc: Dict[str, int] = {}
    if reuse_pair is not None:
        a, b = reuse_pair
        if a in inter and b in inter:
            vmax = max(inter[a], inter[b])
            others = {p: v for p, v in inter.items() if p not in (a, b)}
            denom = sum(others.values()) + vmax
            l_reuse = int(total_links * vmax / denom)
            l_reuse = max(l_reuse, 1)
            rest = total_links - l_reuse
            ssum = sum(others.values())
            for p, v in others.items():
                alloc[p] = max(int(rest * v / ssum), 1) if ssum else 0
            alloc[a] = l_reuse
            alloc[b] = l_reuse      # same physical links, reused in time
            # trim rounding/min-1 overshoot — the pair occupies its links
            # ONCE; charge them to whichever member came first in ``inter``
            first = a if list(inter).index(a) < list(inter).index(b) else b
            usage = {p: (alloc[p] if p not in (a, b) else
                         (alloc[p] if p == first else 0)) for p in inter}
            while sum(usage.values()) > total_links \
                    and max(usage.values()) > 1:
                big = max(usage, key=usage.get)
                usage[big] -= 1
                alloc[big] -= 1
                if big == first:
                    alloc[a] = alloc[b] = alloc[big]
            return alloc
    ssum = sum(inter.values())
    for p, v in inter.items():
        alloc[p] = max(int(total_links * v / ssum), 1)
    # trim if rounding/min-1 overshot the budget
    while sum(alloc.values()) > total_links and max(alloc.values()) > 1:
        big = max(alloc, key=alloc.get)
        alloc[big] -= 1
    return alloc


# ---------------------------------------------------------------------------
# Physical-topology derivation (paper §IV-B step 4)
# ---------------------------------------------------------------------------
def _partitions(items: Sequence[str], max_parts: int):
    """All ways to group ``items`` into <= max_parts unordered groups."""
    items = list(items)
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _partitions(rest, max_parts):
        # own group
        if len(part) < max_parts:
            yield [[first]] + part
        # join an existing group
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1:]


def derive_physical(groups_degrees: Dict[str, int],
                    link_alloc: Dict[str, int],
                    mcm: MCMArch,
                    n_mcm: int,
                    hw: HW = DEFAULT_HW,
                    reuse_pair: Optional[Tuple[str, str]] = None
                    ) -> Optional[OITopology]:
    """Enumerate parallelism->rail-dimension assignments (<=4 dims), keep
    feasible ones, return the topology with the fewest OCSs.

    groups_degrees: inter-MCM parallelism degrees (prod == n_mcm).
    If reuse_pair is set, those two parallelisms MUST share one dim.
    """
    ps = [p for p, d in groups_degrees.items() if d > 1]
    if not ps:
        return OITopology(dims=(), mapping=(), link_alloc=link_alloc,
                          reuse_pair=None)
    best: Optional[OITopology] = None
    for part in _partitions(ps, 4):
        if reuse_pair is not None:
            a, b = reuse_pair
            together = any(a in g and b in g for g in part)
            apart = any((a in g) != (b in g) and (a in g or b in g)
                        for g in part)
            if (a in ps and b in ps) and (not together or apart):
                continue
        dims = []
        ok = True
        for g in part:
            n_i = 1
            for p in g:
                n_i *= groups_degrees[p]
            if reuse_pair and all(q in g for q in reuse_pair):
                r_i = link_alloc.get(reuse_pair[0], 1)
                extra = [link_alloc.get(p, 0) for p in g
                         if p not in reuse_pair]
                r_i += sum(extra)
            else:
                r_i = sum(link_alloc.get(p, 0) for p in g)
            r_i = max(r_i, 1)
            # pick k_i: smallest k satisfying the port bound
            k_i = max(1, math.ceil(n_i / hw.ocs_ports))
            if k_i > r_i:
                ok = False
                break
            dims.append(RailDim(n=n_i, r=r_i, k=k_i))
        if not ok:
            continue
        topo = OITopology(dims=tuple(dims),
                          mapping=tuple(tuple(g) for g in part),
                          link_alloc=dict(link_alloc),
                          reuse_pair=reuse_pair)
        errs = topo.validate(mcm, hw, n_mcm_expected=n_mcm)
        if errs:
            continue
        if best is None or topo.ocs_count() < best.ocs_count():
            best = topo
    return best


# ---------------------------------------------------------------------------
# Memoized / batched derivation front-end (the refinement hot path)
# ---------------------------------------------------------------------------
# The partition enumeration above only reads (degrees, alloc, reuse_pair)
# plus mcm.total_links, n_mcm and hw.ocs_ports — nothing else of the MCM
# or HW.  DSE refinement re-derives the same handful of configurations
# over and over (top-K winners cluster on a few strategy shapes), so a
# content-keyed memo turns derivation into a dict hit.  Dict key order
# matters: the fewest-OCS tie-break follows partition enumeration order,
# which follows ``groups_degrees`` insertion order — keys preserve it.
_DERIVE_CACHE: Dict[tuple, Optional[OITopology]] = {}
_DERIVE_CACHE_MAX = 65536


def derive_physical_cached(groups_degrees: Dict[str, int],
                           link_alloc: Dict[str, int],
                           mcm: MCMArch,
                           n_mcm: int,
                           hw: HW = DEFAULT_HW,
                           reuse_pair: Optional[Tuple[str, str]] = None
                           ) -> Optional[OITopology]:
    """``derive_physical`` behind a content-keyed memo (identical
    results; OITopology is frozen, so sharing instances is safe)."""
    key = (tuple(groups_degrees.items()), tuple(link_alloc.items()),
           reuse_pair, mcm.total_links, n_mcm, hw.ocs_ports)
    try:
        return _DERIVE_CACHE[key]
    except KeyError:
        pass
    topo = derive_physical(groups_degrees, link_alloc, mcm, n_mcm, hw,
                           reuse_pair=reuse_pair)
    if len(_DERIVE_CACHE) >= _DERIVE_CACHE_MAX:
        _DERIVE_CACHE.clear()
    _DERIVE_CACHE[key] = topo
    return topo


def derive_physical_batch(rows: Sequence[Tuple[Dict[str, int],
                                               Dict[str, int],
                                               Optional[Tuple[str, str]]]],
                          mcms: Sequence[MCMArch],
                          hw: HW = DEFAULT_HW) -> List[Optional[OITopology]]:
    """Derive one topology per (degrees, alloc, reuse_pair) row; row i
    uses ``mcms[i]``.  The memo collapses duplicate configurations, so a
    top-K refinement batch costs one real derivation per unique shape."""
    return [derive_physical_cached(deg, alloc, mcm, mcm.n_mcm, hw,
                                   reuse_pair=rp)
            for (deg, alloc, rp), mcm in zip(rows, mcms)]
