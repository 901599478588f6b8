"""N4's graph route (``ops/n4.py``) on the CPU.

The CPU route runs every iteration eagerly and never captures.  The graph
route's bookkeeping (the call's slots, the signature cache keyed by their
address, the counters of captures and replays) runs here with a stand-in
for the CUDA capture that replays the captured iteration's Python: a graph
bakes in the addresses of the tensors it read at capture, and so does the
stand-in, which binds the level's slots.  The card test
(``tests/test_torch_cuda.py::test_n4_graph_route_bit_equal_to_eager``)
holds the real graphs bit-equal to the eager loop.
"""
import collections
from types import SimpleNamespace

import pytest
import torch

from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.ops import n4, n4_cuda

torch.set_num_threads(2)
KW = dict(return_iters=True, return_phi=True, return_compacted=True,
          return_field=True, return_overflow=True)
COUNTERS = ("n4_iter_graph_captures", "n4_iter_graph_replays")


def _batch(N, shape, seed):
    hp, mask, _ = make_cohort(N, shape, (1.5, 1.5, 10.0), seed=seed)
    return torch.from_numpy(hp), torch.from_numpy(mask)


def _flat(x):
    return [y for t in x for y in (_flat(t) if isinstance(t, tuple) else [t])]


def _counted(fn):
    """(fn(), counter deltas, HOST_SYNCS["n4"] delta)."""
    before, syncs = dict(n4_cuda.LAUNCHES), n4.HOST_SYNCS["n4"]
    out = fn()
    return (out, {k: n4_cuda.LAUNCHES[k] - before[k] for k in COUNTERS},
            n4.HOST_SYNCS["n4"] - syncs)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph route on the CPU, with an empty cache: the stand-in capture
    runs the iteration once and keeps it for replay, and the call's slots
    come back at one address from call to call of one shape, as the
    caching allocator gives them on a card once warm (``fresh`` set: at a
    new address every call)."""
    state = SimpleNamespace(recorded=[], fresh=False, kept=[])
    buffers = {}

    def record(place, dev, step):
        step()
        state.recorded.append(place)
        return SimpleNamespace(replay=step), None, ({}, {}), None

    def alloc(dev, nbytes):
        if state.fresh:
            state.kept.append(torch.empty(nbytes, dtype=torch.uint8))
            return state.kept[-1]
        return buffers.setdefault(nbytes, torch.empty(nbytes,
                                                      dtype=torch.uint8))

    monkeypatch.setattr(n4, "_graphs_engage", lambda dev: True)
    monkeypatch.setattr(n4, "_place", lambda dev: ("cpu", 0))
    monkeypatch.setattr(n4, "_record", record)
    monkeypatch.setattr(n4, "_alloc", alloc)
    monkeypatch.setattr(n4, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setattr(n4, "_LOCKS", {})
    return state


def test_cpu_route_never_captures():
    hp, mask = _batch(2, (32, 32, 8), seed=5)
    graphs, streams = dict(n4._GRAPHS), dict(n4._STREAMS)
    _, got, syncs = _counted(lambda: n4.n4_bias_correction(
        hp, mask, mask_pad=4096, max_iters=6))
    assert syncs > 0
    assert got == dict.fromkeys(COUNTERS, 0)
    assert dict(n4._GRAPHS) == graphs and dict(n4._STREAMS) == streams


def test_graph_cache_drops_the_signature_used_longest_ago(monkeypatch):
    monkeypatch.setattr(n4, "_GRAPHS", collections.OrderedDict())
    keys = [("cpu", 0, n, 7) for n in range(n4.GRAPHS_KEPT + 2)]
    for k in keys[:n4.GRAPHS_KEPT]:
        n4._remember(k, SimpleNamespace())
    assert n4._lookup(keys[0]) is not None      # now the latest used
    n4._remember(keys[-2], SimpleNamespace())
    n4._remember(keys[-1], SimpleNamespace())
    assert len(n4._GRAPHS) == n4.GRAPHS_KEPT
    assert n4._lookup(keys[1]) is None and n4._lookup(keys[2]) is None
    assert n4._lookup(keys[0]) is not None
    assert n4._lookup(keys[-1]) is not None
    # a graph captured on slots at another address does not fit
    assert n4._lookup(keys[-1][:-1] + (8,)) is None


@pytest.mark.parametrize("N, P, ncp", [(16, 49152, 11), (3, 5000, 5),
                                       (1, 188416, 7)])
def test_slot_layout_aligned_and_disjoint(N, P, ncp):
    offsets, nbytes = n4._layout(N, P, ncp)
    order = sorted(offsets.items(), key=lambda kv: kv[1])
    assert all(off % 512 == 0 for _, off in order)
    rows = N * ncp * P * 4
    assert offsets["bc1"] - offsets["br1"] >= rows
    assert nbytes - order[-1][1] >= N        # done: one byte a lane
    assert nbytes <= 6 * rows + 5 * N * P * 4 + 3 * N * ncp ** 3 * 4 \
        + 16 * 512


def test_graph_route_bit_equal_and_replays_in_later_calls(stand_in):
    """Two calls on the graph route give the eager route's bits, with
    lanes frozen at different iterations; the first call captures each
    level once and replays its other iterations, the second only
    replays."""
    hp, mask = _batch(3, (48, 48, 8), seed=3)
    levels = 4
    with pytest.MonkeyPatch.context() as m:
        m.setattr(n4, "_graphs_engage", lambda dev: False)
        want, none, syncs = _counted(lambda: n4.n4_bias_correction(
            hp, mask, mask_pad=8192, **KW))
    assert none == dict.fromkeys(COUNTERS, 0)
    iters = want[3]
    assert bool((iters != iters[:1]).any())     # lanes stop apart
    assert syncs == int(iters.max(0).values.sum())
    for n, (captures, replays) in enumerate(
            [(levels, syncs - levels), (0, syncs)]):
        got, counts, s = _counted(lambda: n4.n4_bias_correction(
            hp, mask, mask_pad=8192, **KW))
        assert s == syncs
        assert counts == {"n4_iter_graph_captures": captures,
                          "n4_iter_graph_replays": replays}, n
        for a, b in zip(_flat(got), _flat(want)):
            assert torch.equal(a, b), n
    assert len(stand_in.recorded) == levels and len(n4._GRAPHS) == levels


def test_slots_at_another_address_capture_again(stand_in):
    """A call whose slots come back elsewhere captures each level again,
    beside the graphs kept for the other address, with the eager route's
    bits; a call at an address seen before replays."""
    hp, mask = _batch(2, (32, 32, 8), seed=1)
    kw = dict(mask_pad=4096, max_iters=4, fitting_levels=2)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(n4, "_graphs_engage", lambda dev: False)
        want = n4.n4_bias_correction(hp, mask, **kw, return_phi=True)
    stand_in.fresh = True
    for _ in range(2):
        got, counts, _ = _counted(lambda: n4.n4_bias_correction(
            hp, mask, **kw, return_phi=True))
        assert counts["n4_iter_graph_captures"] == 2
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(n4._GRAPHS) == 4
    stand_in.fresh = False
    for captures in (2, 0):
        _, counts, _ = _counted(lambda: n4.n4_bias_correction(
            hp, mask, **kw))
        assert counts["n4_iter_graph_captures"] == captures
