"""Percent of the centre rows the CI engine ran that were real defect
voxels: the defect voxels of the traced calls' defect maps over the rows
K3 was entered with and the rows of the tail's distance pass
(``ventjax_torch/ops/ci_cuda.py``: ``head_counts_rows``,
``alias_min_d2_rows``) over the traced window."""


def read(ctx):
    rows = (ctx.counts.get("head_counts_rows", 0)
            + ctx.counts.get("alias_min_d2_rows", 0))
    if rows <= 0:
        return None
    per_batch = {b: int((ctx.work(b)["defect"] != 0).sum())
                 for b in set(ctx.calls)}
    real = sum(per_batch[b] for b in ctx.calls)
    return 100.0 * real / rows
