"""Percent of the N4 level loop's iterations that ran as a replay of a
captured CUDA graph (``ventjax_torch/ops/n4.py``): the replays
(``n4_cuda.LAUNCHES["n4_iter_graph_replays"]``) over the iterations, one
host sync each (``HOST_SYNCS["n4"]``), in the traced calls.  None where
the program counts no replays."""


def read(ctx):
    syncs = ctx.counts.get("n4_host_syncs", 0)
    replays = ctx.counts.get("n4_iter_graph_replays")
    if replays is None or syncs <= 0:
        return None
    return 100.0 * replays / syncs
