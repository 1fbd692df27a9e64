"""The capacity ladder alone (mst_torch.transfer.run_fused_jobs), on a
scripted launcher: each run's buffer holds fixed headers, and no model
runs. With the capacity tiers 64, 256 and 1,024 and the pool tiers 64,
256 and 1,024 (both patched, as the ladder reads them at call time), each
case checks the launcher's calls in order (so ``host_work`` runs once,
after the first launch and before the first fetch), what the ladder
returns or raises, the counters of the unit it ran in and the hints it
leaves:

- the counts fit the hint's tier, which is above the smallest tier that
  holds them: the hint steps back down;
- the counts outgrow a tier: the next one runs (``capacity``);
- the record sums outgrow the pool tier: the run's records are packed
  again at the exact tier (``transfer.repack``);
- the sums outgrow the top pool tier: the program runs again in the
  per-job row layout (``pool``);
- the routing table overflows at the top tier while the records fit: the
  dense compaction runs (``dense``), and its true counts are checked
  again, which may raise, or may outgrow a pool tier or the top one (the
  pool hints then stay);
- the counts outgrow the top tier: ``OverflowError``;
- a launcher that does not run through the record pool: no pool, no
  ``transfer.repack`` counter, and the pool hints stay.
"""

import types

import numpy as np
import pytest

from mst_torch import transfer as tt
from mst_torch.runtime import profile as tp

B, CB = 2, 8
TIERS = (64, 256, 1024)
ROOT = "t.ladder"


class Scripted:
    """A launcher whose every run reports, for each of the B jobs, the
    header counts ``script(capacity, dense)`` = (count_p, count_u, live_p,
    live_u), and whose re-pack keeps them. Its calls go to ``log``."""

    def __init__(self, pooled, script, log):
        self.pooled, self.script, self.log = pooled, script, log
        self.fetched = []

    def launch(self, capacity, dense, pool):
        self.log.append(("launch", capacity, dense, pool))
        out = ("run", capacity, dense, pool)
        return out, (None if pool is None else (capacity, dense))

    def repack(self, kept, capacity, pool):
        self.log.append(("repack", capacity, pool))
        return ("repack", *kept, pool)

    def fetch(self, out):
        what, capacity, dense, pool = out
        self.log.append(("fetch", what))
        head = np.zeros((B, 8 + CB), np.uint32)
        head[:, 4:8] = self.script(capacity, dense)
        # the records are left out: the ladder reads the headers alone
        buf = head if pool is None else np.concatenate(
            [head.ravel(), np.zeros(2 * (pool[0] + pool[1]), np.uint32)])
        self.fetched.append(buf)
        return buf


def _counts(p, u, live_p=1, live_u=1, dense=None):
    """A script: each job's counts, and with ``dense`` the dense
    compaction's true (count_p, count_u)."""
    return lambda capacity, is_dense: (
        (*dense, 0, 0) if is_dense else (p, u, live_p, live_u))


FITS = ("fetch", "run")
CASES = {
    # name: (pooled, (capacity_hint, pool_hint_p, pool_hint_u), script,
    #        the launcher's calls and the host work in order, the result
    #        (capacity, pool) or the error, counters, hints after)
    "the hint steps back down": (
        True, (1024, 1, 1), _counts(10, 2),
        [("launch", 1024, False, (64, 64)), "host", FITS],
        (1024, (64, 64)), {"transfer.repack": 0}, (64, 20, 4)),
    "a capacity step-up": (
        True, (0, 300, 1), _counts(100, 2),
        [("launch", 64, False, (1024, 64)), "host", FITS,
         ("launch", 256, False, (1024, 64)), FITS],
        (256, (1024, 64)),
        {"transfer.repack": 0, "transfer.redispatch.capacity": 1},
        (256, 200, 4)),
    "a pool miss re-packs": (
        True, (0, 1, 1), _counts(40, 10),
        [("launch", 64, False, (64, 64)), "host", FITS,
         ("repack", 64, (256, 64)), ("fetch", "repack")],
        (64, (256, 64)), {"transfer.repack": 1}, (64, 80, 20)),
    "beyond the top pool tier, the row layout": (
        True, (1024, 1, 1), _counts(600, 100),
        [("launch", 1024, False, (64, 64)), "host", FITS,
         ("launch", 1024, False, None), FITS],
        (1024, None),
        {"transfer.repack": 0, "transfer.redispatch.pool": 1},
        (1024, 1200, 200)),
    "the dense fallback": (
        True, (1024, 1, 1), _counts(10, 2, live_p=20000, dense=(40, 2)),
        [("launch", 1024, False, (64, 64)), "host", FITS,
         ("launch", 1024, True, (64, 64)), FITS,
         ("repack", 1024, (256, 64)), ("fetch", "repack")],
        (1024, (256, 64)),
        {"transfer.repack": 1, "transfer.redispatch.dense": 1},
        (1024, 80, 4)),
    "the dense fallback beyond the top pool tier": (
        True, (1024, 1, 1), _counts(10, 2, live_p=20000, dense=(600, 100)),
        [("launch", 1024, False, (64, 64)), "host", FITS,
         ("launch", 1024, True, (64, 64)), FITS,
         ("launch", 1024, True, None), FITS],
        (1024, None),
        {"transfer.repack": 0, "transfer.redispatch.dense": 1,
         "transfer.redispatch.pool": 1},
        (1024, 1, 1)),
    "the dense fallback's true counts overflow": (
        True, (1024, 1, 1), _counts(10, 2, live_u=5000, dense=(2000, 2)),
        [("launch", 1024, False, (64, 64)), "host", FITS,
         ("launch", 1024, True, (64, 64)), FITS],
        OverflowError,
        {"transfer.repack": 0, "transfer.redispatch.dense": 1},
        (1024, 1, 1)),
    "the counts overflow the top tier": (
        True, (0, 1, 1), _counts(2000, 2),
        [("launch", 64, False, (64, 64)), "host", FITS,
         ("launch", 256, False, (64, 64)), FITS,
         ("launch", 1024, False, (64, 64)), FITS],
        OverflowError,
        {"transfer.repack": 0, "transfer.redispatch.capacity": 2},
        (0, 1, 1)),
    "no record pool": (
        False, (0, 0, 0), _counts(100, 2),
        [("launch", 64, False, None), "host", FITS,
         ("launch", 256, False, None), FITS],
        (256, None), {"transfer.redispatch.capacity": 1}, (256, 0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_ladder_on_scripted_headers(case, monkeypatch):
    pooled, hints, script, calls, want, counters, after = CASES[case]
    monkeypatch.setattr(tt, "COMPACT_CAPACITIES", TIERS)
    monkeypatch.setattr(tt, "POOL_TIERS", TIERS)
    bundle = types.SimpleNamespace(capacity_hint=hints[0],
                                   pool_hint_p=hints[1],
                                   pool_hint_u=hints[2])
    log = []
    launcher = Scripted(pooled, script, log)
    with tp.span(ROOT):
        if isinstance(want, tuple):
            buf, capacity, pool = tt.run_fused_jobs(
                bundle, launcher, B, CB, host_work=lambda: log.append("host"))
        else:
            with pytest.raises(want):
                tt.run_fused_jobs(bundle, launcher, B, CB,
                                  host_work=lambda: log.append("host"))
    assert log == calls
    if isinstance(want, tuple):
        assert (capacity, pool) == want
        assert buf is launcher.fetched[-1]
    assert tp.units(ROOT)[-1].counters == counters
    assert (bundle.capacity_hint, bundle.pool_hint_p,
            bundle.pool_hint_u) == after
